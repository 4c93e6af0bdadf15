"""Build, load and launch the hand-written Hopper kernels.

Each kernel source in ``accelerate_tpu_torch/csrc/`` has a plain C entry
point that launches on the caller's stream, allocates nothing and returns
``cudaGetLastError()``. At first use this module compiles every source
with ``nvcc`` for ``sm_90a`` (one process per source, all started
together) into ``accelerate_tpu_torch/_build/`` and loads the shared
libraries with ``ctypes``; a library is named after the hash of its
sources, so an edited kernel rebuilds and an unchanged one is reused.

The checked wrappers (:func:`paged_decode`, :func:`paged_decode_quant`,
:func:`ragged_prefill`, :func:`ragged_prefill_quant`, :func:`flash_fwd`,
:func:`flash_bwd_dq`, :func:`flash_bwd_dkv`, :func:`dense_decode`,
:func:`dense_decode_quant`) take CPU
tensors to the plain PyTorch version in ``ops/attention.py``. Every
wrapper takes bf16 or fp16 (q's dtype; the K/V tensors that are not int8
payloads must match it): each dtype is its own entry point of the same
source (``paged_decode`` / ``paged_decode_f16``, ``flash_fwd`` /
``flash_fwd_f16``, ...: :data:`KERNEL_DTYPES`), counted apart. For a CUDA
tensor they check device, dtype, shape and contiguity, allocate the
output, launch the kernel and add one to :data:`launch_counts`, or raise.
Nothing falls back from the device to the plain version.

A CUDA graph (``utils/cuda_graphs.py``) launches on replay what its
capture recorded and runs no wrapper: while a graph is captured the
wrappers on the capturing thread count into the capture's own record
(:func:`recording`), and each replay adds that record to
:data:`launch_counts` (:func:`add_launches`). A launch from any other
thread meanwhile counts as usual.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from .attention import (
    DECODE_KERNEL_HEAD_DIMS,
    DECODE_KERNEL_MAX_ROWS,
    DECODE_KERNEL_MAX_SQ,
    FLASH_KERNEL_HEAD_DIMS,
    FLASH_KERNEL_SEQ_MULTIPLE,
    PREFILL_KERNEL_HEAD_DIMS,
)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# kernel name -> (source file, C entry point, ctypes argtypes)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNELS = {
    "paged_decode": (
        "paged_decode.cu", "paged_decode_launch",
        [_P] * 7 + [_I] * 9 + [_F, _P],
    ),
    "ragged_prefill": (
        "ragged_prefill.cu", "ragged_prefill_launch",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    ),
    "flash_fwd": (
        "flash_fwd.cu", "flash_fwd_launch",
        [_P] * 8 + [_I] * 7 + [_F, _P],
    ),
    "flash_bwd_dq": (
        "flash_bwd_dq.cu", "flash_bwd_dq_launch",
        [_P] * 10 + [_I] * 7 + [_F, _P],
    ),
    "flash_bwd_dkv": (
        "flash_bwd_dkv.cu", "flash_bwd_dkv_launch",
        [_P] * 11 + [_I] * 7 + [_F, _P],
    ),
    # the fp16 entries: the same kernels with fp16 elements, in the same
    # libraries as the bf16 ones
    "flash_fwd_f16": (
        "flash_fwd.cu", "flash_fwd_f16_launch",
        [_P] * 8 + [_I] * 7 + [_F, _P],
    ),
    "flash_bwd_dq_f16": (
        "flash_bwd_dq.cu", "flash_bwd_dq_f16_launch",
        [_P] * 10 + [_I] * 7 + [_F, _P],
    ),
    "flash_bwd_dkv_f16": (
        "flash_bwd_dkv.cu", "flash_bwd_dkv_f16_launch",
        [_P] * 11 + [_I] * 7 + [_F, _P],
    ),
    "dense_decode": (
        "dense_decode.cu", "dense_decode_launch",
        [_P] * 6 + [_I] * 8 + [_F, _P],
    ),
    "dense_decode_quant": (
        "dense_decode_quant.cu", "dense_decode_quant_launch",
        [_P] * 8 + [_I] * 9 + [_F, _P],
    ),
    "paged_decode_quant": (
        "paged_decode_quant.cu", "paged_decode_quant_launch",
        [_P] * 9 + [_I] * 10 + [_F, _P],
    ),
    "ragged_prefill_quant": (
        "ragged_prefill_quant.cu", "ragged_prefill_quant_launch",
        [_P] * 17 + [_I] * 8 + [_F, _P],
    ),
}
# the serving kernels' fp16 entries: the same kernels with fp16 q, K/V
# and out, in the same libraries as their bf16 entries
KERNELS.update({
    name + "_f16": (src, entry.replace("_launch", "_f16_launch"), argtypes)
    for name, (src, entry, argtypes) in list(KERNELS.items())
    if name in ("paged_decode", "paged_decode_quant", "dense_decode", "dense_decode_quant",
                "ragged_prefill", "ragged_prefill_quant")
})

# launches per kernel since the last reset_launch_counts(); a wrapper adds
# one exactly where it launches its kernel, never on the plain path
launch_counts = {name: 0 for name in KERNELS}
# where this thread's wrappers count while it captures a graph (no
# ``record``: launch_counts)
_capture = threading.local()

_libs: dict = {}
_lock = threading.Lock()


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


@contextlib.contextmanager
def recording():
    """Count the launches made inside into a fresh dict, yielded, and not
    into :data:`launch_counts`: what a CUDA graph's capture records, and
    what each of its replays then adds. Only this thread's launches are
    recorded."""
    if _record() is not None:
        raise RuntimeError("launches are already being recorded (a capture inside a capture)")
    _capture.record = {}
    try:
        yield _capture.record
    finally:
        _capture.record = None


def _record():
    """The record this thread's launches go to, or None (launch_counts)."""
    return getattr(_capture, "record", None)


def add_launches(counts: dict):
    """Add a capture's recorded launches to :data:`launch_counts`: one
    replay of its graph."""
    for name, n in counts.items():
        launch_counts[name] += n


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _source_digest(name: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / KERNELS[name][0]]:
        h.update(path.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    """The library of kernel ``name``'s source (kernels of one source
    share it)."""
    return BUILD_DIR / f"lib{Path(KERNELS[name][0]).stem}-{_source_digest(name)}.so"


def nvcc_command(name: str, out: Path) -> list:
    """The nvcc command line that builds kernel ``name`` into ``out``."""
    return [
        nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
        "-o", str(out), str(CSRC / KERNELS[name][0]),
    ]


def build(names=None) -> dict:
    """Compile the kernels that have no library yet, one ``nvcc`` process
    per source, all running at once. Returns ``{name: ptxas report}`` for
    what was compiled (a source's report under each of its kernels).
    Raises with the compiler's output on failure."""
    names = list(names or KERNELS)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        if lib in procs:
            procs[lib][0].append(name)
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[lib] = ([name], subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ), tmp)
    reports, failed = {}, []
    for lib, (built, proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {built[0]} (rc {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, lib)
        reports.update({name: out for name in built})
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def _lib(name: str):
    with _lock:
        fn = _libs.get(name)
        if fn is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"the {name} kernel is not loaded, and a CUDA graph capture cannot "
                    "build or load it: run the step once before capturing it"
                )
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, KERNELS[name][1])
            fn.argtypes = KERNELS[name][2]
            fn.restype = ctypes.c_int
            _libs[name] = fn
        return fn


def _launch(name: str, *args):
    err = _lib(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    _count(name)


def _count(name: str):
    """One launch of kernel ``name``: into :data:`launch_counts`, or into
    the record of the graph this thread is capturing."""
    record = _record()
    counts = launch_counts if record is None else record
    counts[name] = counts.get(name, 0) + 1


def _check(t: torch.Tensor, what: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


# the kernels' element types -> the suffix of their entry points
KERNEL_DTYPES = {torch.bfloat16: "", torch.float16: "_f16"}


def _entry(name: str, q: torch.Tensor, *same) -> str:
    """The entry point of kernel ``name`` for q's dtype (bf16: ``name``,
    fp16: ``name + "_f16"``); raises TypeError for any other dtype, or
    when a ``(what, tensor)`` of ``same`` has another dtype than q."""
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(
            f"{name}: the kernels take bf16 or fp16 tensors, got {q.dtype} "
            "(serve a bf16 or fp16 model; fp32 runs only on the CPU)"
        )
    for what, t in same:
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {what} is {t.dtype}, q is {q.dtype}: one dtype for both")
    return name + KERNEL_DTYPES[q.dtype]


def _stream(dev) -> int:
    """The handle of ``dev``'s current CUDA stream, which every launch uses."""
    return torch.cuda.current_stream(dev).cuda_stream


def _require_cuda(t: torch.Tensor, name: str):
    if t.device.type != "cuda":
        raise RuntimeError(
            f"{name}: tensors on {t.device} are neither CPU (plain version) "
            "nor CUDA (kernel)"
        )


def _prefill_kernel_check(q, k_pages, bt: int):
    """What both ragged prefill kernels take: a query-head group over the
    kv heads, head_dim 64 or 128 (one or two 64-column TMA boxes), a token
    block dividing 64 and the capacity, and a page size whose runs of rows
    tile the kernel's 64-row kv tiles (a multiple of 8 that divides 64, or
    a multiple of 64). Returns ``(h, cap, d, kvh, ps, group)``."""
    _, h, cap, d = q.shape
    _, kvh, ps, _ = k_pages.shape
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    if d not in PREFILL_KERNEL_HEAD_DIMS:
        raise ValueError(
            f"head_dim {d}: the ragged prefill kernels take {PREFILL_KERNEL_HEAD_DIMS}"
        )
    if bt < 1 or 64 % bt or cap % bt:
        raise ValueError(
            f"token block {bt} must divide 64 and the capacity {cap}"
        )
    if ps % 8 or (64 % ps and ps % 64):
        raise ValueError(
            f"page size {ps}: the ragged prefill kernels take a multiple of 8 that "
            "divides 64 (8, 16, 32, 64) or a multiple of 64"
        )
    return h, cap, d, kvh, ps, h // kvh


# The decode kernels' split kv walk (csrc/decode_common.cuh, paged and
# dense): a split is a run of whole DECODE_TILE-token tiles, at most
# DECODE_MAX_SPLIT_TILES (the page ids a paged split stages in shared
# memory), and the blocks of every slot's full reservation (a dense
# arena's whole length) are DECODE_BLOCKS_PER_SM per SM: slots that hold
# an eighth of their reservation on average still fill the card once.
DECODE_TILE = 64
DECODE_MAX_SPLIT_TILES = 32
DECODE_BLOCKS_PER_SM = 8


def decode_split_plan(b: int, kvh: int, capacity: int, sms: int):
    """``(tiles_per_split, n_splits)`` of a decode call over ``b`` slots
    and ``kvh`` kv heads that reserve ``capacity`` positions each (a page
    table's pages x page size, a dense arena's length), on a card of
    ``sms`` SMs: the fewest tiles a split
    that give every (slot, kv head) enough splits for
    ``DECODE_BLOCKS_PER_SM * sms`` blocks over full reservations. Split
    s covers tiles ``s * tiles_per_split ..`` (:func:`decode_split_ranges`);
    the splits together cover the whole reservation."""
    tiles = -(-capacity // DECODE_TILE)
    want = max(-(-DECODE_BLOCKS_PER_SM * sms // (b * kvh)),
               -(-tiles // DECODE_MAX_SPLIT_TILES))
    per_split = -(-tiles // min(tiles, want))
    return per_split, -(-tiles // per_split)


def decode_split_ranges(max_pos: int, tiles_per_split: int):
    """The kv position ranges ``[(lo, hi), ...]`` of the live splits of a
    slot whose query rows reach ``max_pos`` (on a dense arena of length
    L, bounded to L - 1 first): the kernel walks tiles 0 .. max_pos // 64,
    ``tiles_per_split`` a split, and a split past them returns at once
    (the last live split's last tile may run past ``max_pos``: its
    positions are masked)."""
    span = tiles_per_split * DECODE_TILE
    return [(lo, lo + span) for lo in range(0, max_pos // DECODE_TILE * DECODE_TILE + 1, span)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _decode_rows_check(h: int, sq: int, d: int, kvh: int, what: str) -> int:
    """What every kernel on the decode core (csrc/decode_common.cuh) takes:
    a query-head group over the kv heads, head_dim in
    DECODE_KERNEL_HEAD_DIMS (the reference's compiled gate, a 64-multiple),
    1..DECODE_KERNEL_MAX_SQ query rows a slot and R = group * Sq <=
    DECODE_KERNEL_MAX_ROWS (four 16-row tiles of the mma.sync products).
    ``what`` names the kernels in the error. Returns the group."""
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    if d not in DECODE_KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the {what} kernels take {DECODE_KERNEL_HEAD_DIMS}")
    if not 1 <= sq <= DECODE_KERNEL_MAX_SQ:
        raise ValueError(
            f"{what} takes 1..{DECODE_KERNEL_MAX_SQ} query rows per slot, got {sq}"
        )
    group = h // kvh
    if group * sq > DECODE_KERNEL_MAX_ROWS:
        raise ValueError(
            f"{group * sq} query rows per kv head (group {group} x Sq {sq}): the {what} "
            f"kernels take at most {DECODE_KERNEL_MAX_ROWS}"
        )
    return group


def _decode_kernel_check(h: int, sq: int, d: int, kvh: int, ps: int) -> int:
    """What both paged decode kernels take: :func:`_decode_rows_check`'s
    shapes and a page size that is a multiple of 8 (the reference's gate;
    16-byte copies of 4 scales). Returns the group."""
    if ps < 8 or ps % 8:
        raise ValueError(f"page size {ps}: the paged decode kernels take a multiple of 8")
    return _decode_rows_check(h, sq, d, kvh, "paged decode")


def _decode_plan(q, kvh: int, capacity: int, d: int):
    """The split plan and the fp32 partials' workspace of one decode call
    over ``capacity`` positions a slot: ``(tiles_per_split, n_splits,
    workspace)``."""
    b, h, sq, _ = q.shape
    dev = q.device
    per_split, n_splits = decode_split_plan(
        b, kvh, capacity, _sm_count(dev.index if dev.index is not None
                                    else torch.cuda.current_device()))
    rows = (h // kvh) * sq
    workspace = torch.empty(b * kvh * n_splits * rows * (d + 2), dtype=torch.float32, device=dev)
    return per_split, n_splits, workspace


def paged_decode(q, k_pages, v_pages, page_table, pos, sm_scale: float):
    """Paged decode attention: q [B, H, Sq, D] and k/v pages [NP, KVH, ps,
    D], bf16 (``paged_decode``) or fp16 (``paged_decode_f16``), page_table
    [B, P] int32, pos [B, Sq] int32 -> out [B, H, Sq, D]. CPU tensors run
    the plain version."""
    if q.device.type == "cpu":
        from .attention import paged_decode_reference

        return paged_decode_reference(q, k_pages, v_pages, page_table, pos, sm_scale)
    _require_cuda(q, "paged_decode")
    b, h, sq, d = q.shape
    num_pages, kvh, ps, _ = k_pages.shape
    p_per_slot = page_table.shape[1]
    group = _decode_kernel_check(h, sq, d, kvh, ps)
    name = _entry("paged_decode", q, ("k_pages", k_pages), ("v_pages", v_pages))
    dev, dt = q.device, q.dtype
    _check(q, "q", dt, (b, h, sq, d), dev)
    _check(k_pages, "k_pages", dt, (num_pages, kvh, ps, d), dev)
    _check(v_pages, "v_pages", dt, (num_pages, kvh, ps, d), dev)
    _check(page_table, "page_table", torch.int32, (b, p_per_slot), dev)
    _check(pos, "pos", torch.int32, (b, sq), dev)
    _check_aligned(("q", q), ("k_pages", k_pages), ("v_pages", v_pages))
    per_split, n_splits, workspace = _decode_plan(q, kvh, p_per_slot * ps, d)
    out = torch.empty_like(q)
    stream = _stream(dev)
    _launch(
        name, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), pos.data_ptr(), out.data_ptr(), workspace.data_ptr(),
        b, kvh, group, sq, d, ps, p_per_slot, per_split, n_splits, float(sm_scale), stream,
    )
    return out


def ragged_prefill(q, k_new, v_new, k_pages, v_pages, page_table, row_slot,
                   row_pos, slot_hist, sm_scale: float, bt: int):
    """Packed ragged prefill: q [1, H, CAP, D], k_new/v_new [1, KVH, CAP, D],
    pages [NP, KVH, ps, D] (all bf16: ``ragged_prefill``, or all fp16:
    ``ragged_prefill_f16``), page_table [S, P], row_slot/row_pos
    [CAP], slot_hist [S] (int32) -> ``(out, k_payload, None, v_payload,
    None)`` with payloads token-major [CAP, KVH, D]. CPU tensors run the
    plain version."""
    if q.device.type == "cpu":
        from .attention import ragged_prefill_reference

        return ragged_prefill_reference(
            q, k_new, v_new, k_pages, v_pages, page_table, row_slot, row_pos,
            slot_hist, sm_scale,
        )
    _require_cuda(q, "ragged_prefill")
    h, cap, d, kvh, ps, group = _prefill_kernel_check(q, k_pages, bt)
    num_pages = k_pages.shape[0]
    n_slots, p_per_slot = page_table.shape
    name = _entry("ragged_prefill", q, ("k_new", k_new), ("v_new", v_new),
                  ("k_pages", k_pages), ("v_pages", v_pages))
    dev, dt = q.device, q.dtype
    _check(q, "q", dt, (1, h, cap, d), dev)
    _check(k_new, "k_new", dt, (1, kvh, cap, d), dev)
    _check(v_new, "v_new", dt, (1, kvh, cap, d), dev)
    _check(k_pages, "k_pages", dt, (num_pages, kvh, ps, d), dev)
    _check(v_pages, "v_pages", dt, (num_pages, kvh, ps, d), dev)
    _check(page_table, "page_table", torch.int32, (n_slots, p_per_slot), dev)
    _check(row_slot, "row_slot", torch.int32, (cap,), dev)
    _check(row_pos, "row_pos", torch.int32, (cap,), dev)
    _check(slot_hist, "slot_hist", torch.int32, (n_slots,), dev)
    _check_aligned(("q", q), ("k_new", k_new), ("v_new", v_new), ("k_pages", k_pages),
                   ("v_pages", v_pages))
    out = torch.empty_like(q)
    stream = _stream(dev)
    _launch(
        name, q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        row_slot.data_ptr(), row_pos.data_ptr(), slot_hist.data_ptr(),
        out.data_ptr(), kvh, group, cap, d, ps, p_per_slot, bt,
        float(sm_scale), stream,
    )
    return out, k_new[0].transpose(0, 1), None, v_new[0].transpose(0, 1), None


def _quant_bits_check(bits: int):
    if bits not in (8, 4):
        raise ValueError(f"KV quantization supports 8 or 4 bits, got {bits}")


def _quant_pages_check(k_pages, v_pages, k_scale, v_scale, d: int, bits: int, dev):
    """Check a quantized arena's payload and scale pages on a CUDA device;
    returns ``(num_pages, kvh, ps)``. Payload rows are read with 16-byte
    loads of 16 (int8) or 32 (int4) values."""
    per_load = 32 if bits == 4 else 16
    if d % per_load:
        raise ValueError(
            f"head_dim {d} must be a multiple of {per_load} (16-byte loads of the "
            f"int{bits} payload rows)"
        )
    num_pages, kvh, ps, _ = k_pages.shape
    pd = d // 2 if bits == 4 else d
    _check(k_pages, "k payload pages", torch.int8, (num_pages, kvh, ps, pd), dev)
    _check(v_pages, "v payload pages", torch.int8, (num_pages, kvh, ps, pd), dev)
    _check(k_scale, "k_scale pages", torch.float32, (num_pages, kvh, ps, 1), dev)
    _check(v_scale, "v_scale pages", torch.float32, (num_pages, kvh, ps, 1), dev)
    _check_aligned(("k payload pages", k_pages), ("v payload pages", v_pages))
    return num_pages, kvh, ps


def paged_decode_quant(q, k_pages, v_pages, k_scale, v_scale, page_table, pos,
                       sm_scale: float, bits: int):
    """Paged decode attention over a quantized arena: q [B, H, Sq, D] bf16
    (``paged_decode_quant``) or fp16 (``paged_decode_quant_f16``: the pages
    dequantized to fp16),
    int8 payload pages [NP, KVH, ps, D] (``bits`` 8) or [NP, KVH, ps, D / 2]
    (``bits`` 4, two values a byte), fp32 scale pages [NP, KVH, ps, 1],
    page_table [B, P] int32, pos [B, Sq] int32 -> out [B, H, Sq, D]. CPU
    tensors run the plain version (gather, dequantize, masked-dense read)."""
    _quant_bits_check(bits)
    if q.device.type == "cpu":
        from .attention import paged_decode_reference

        return paged_decode_reference(q, k_pages, v_pages, page_table, pos, sm_scale,
                                      k_scale=k_scale, v_scale=v_scale, kv_quant_bits=bits)
    _require_cuda(q, "paged_decode_quant")
    b, h, sq, d = q.shape
    _, kvh, ps, _ = k_pages.shape
    p_per_slot = page_table.shape[1]
    group = _decode_kernel_check(h, sq, d, kvh, ps)
    name = _entry("paged_decode_quant", q)
    dev = q.device
    _check(q, "q", q.dtype, (b, h, sq, d), dev)
    _quant_pages_check(k_pages, v_pages, k_scale, v_scale, d, bits, dev)
    _check(page_table, "page_table", torch.int32, (b, p_per_slot), dev)
    _check(pos, "pos", torch.int32, (b, sq), dev)
    _check_aligned(("q", q), ("k_scale pages", k_scale), ("v_scale pages", v_scale))
    per_split, n_splits, workspace = _decode_plan(q, kvh, p_per_slot * ps, d)
    out = torch.empty_like(q)
    stream = _stream(dev)
    _launch(
        name, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(), pos.data_ptr(),
        out.data_ptr(), workspace.data_ptr(), b, kvh, group, sq, d, ps, p_per_slot, bits,
        per_split, n_splits, float(sm_scale), stream,
    )
    return out


def ragged_prefill_quant(q, k_new, v_new, k_pages, v_pages, k_scale, v_scale, page_table,
                         row_slot, row_pos, slot_hist, sm_scale: float, bt: int, bits: int):
    """Packed ragged prefill over a quantized arena, quantize-on-write
    fused: q [1, H, CAP, D], k_new/v_new [1, KVH, CAP, D] (bf16:
    ``ragged_prefill_quant``, or fp16: ``ragged_prefill_quant_f16``), int8
    payload pages [NP, KVH, ps, D or D / 2] with fp32 scale pages
    [NP, KVH, ps, 1], page_table [S, P], row_slot/row_pos [CAP], slot_hist
    [S] (int32) -> ``(out [1, H, CAP, D], k_payload [CAP, KVH, pd] int8,
    k_scale [CAP, KVH, 1] fp32, v_payload, v_scale)``: every packed row
    quantized (pads too), token-major for the caller's arena scatter. CPU
    tensors run the plain version."""
    _quant_bits_check(bits)
    if q.device.type == "cpu":
        from .attention import ragged_prefill_reference

        return ragged_prefill_reference(
            q, k_new, v_new, k_pages, v_pages, page_table, row_slot, row_pos, slot_hist,
            sm_scale, k_scale=k_scale, v_scale=v_scale, kv_quant_bits=bits,
        )
    _require_cuda(q, "ragged_prefill_quant")
    h, cap, d, kvh, ps, group = _prefill_kernel_check(q, k_pages, bt)
    n_slots, p_per_slot = page_table.shape
    name = _entry("ragged_prefill_quant", q, ("k_new", k_new), ("v_new", v_new))
    dev, dt = q.device, q.dtype
    _check(q, "q", dt, (1, h, cap, d), dev)
    _check(k_new, "k_new", dt, (1, kvh, cap, d), dev)
    _check(v_new, "v_new", dt, (1, kvh, cap, d), dev)
    _, kvh, ps = _quant_pages_check(k_pages, v_pages, k_scale, v_scale, d, bits, dev)
    _check(page_table, "page_table", torch.int32, (n_slots, p_per_slot), dev)
    _check(row_slot, "row_slot", torch.int32, (cap,), dev)
    _check(row_pos, "row_pos", torch.int32, (cap,), dev)
    _check(slot_hist, "slot_hist", torch.int32, (n_slots,), dev)
    _check_aligned(("q", q), ("k_new", k_new), ("v_new", v_new))
    pd = d // 2 if bits == 4 else d
    out = torch.empty_like(q)
    k_pay = torch.empty((cap, kvh, pd), dtype=torch.int8, device=dev)
    v_pay = torch.empty_like(k_pay)
    k_scl = torch.empty((cap, kvh, 1), dtype=torch.float32, device=dev)
    v_scl = torch.empty_like(k_scl)
    # the quantize pass's dequantized fresh K and V (q's dtype), read by
    # the attention
    workspace = torch.empty((2, kvh, cap, d), dtype=dt, device=dev)
    stream = _stream(dev)
    _launch(
        name, q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        page_table.data_ptr(), row_slot.data_ptr(), row_pos.data_ptr(), slot_hist.data_ptr(),
        out.data_ptr(), k_pay.data_ptr(), k_scl.data_ptr(), v_pay.data_ptr(),
        v_scl.data_ptr(), workspace.data_ptr(), kvh, group, cap, d, ps, p_per_slot, bt,
        bits, float(sm_scale), stream,
    )
    return out, k_pay, k_scl, v_pay, v_scl


def _flash_shapes(q, k, v, masks, name):
    """Check the flash kernels' shared inputs on a CUDA device; returns
    ``(b, h, kvh, sq, skv, d)``, the mask pointers (None when absent) and
    the entry point's name (``name`` for bf16, ``name + "_f16"`` for
    fp16)."""
    _require_cuda(q, name)
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    if d not in FLASH_KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the flash kernels take {FLASH_KERNEL_HEAD_DIMS}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(
            f"{name}: the flash kernels take bf16 or fp16 tensors, got {q.dtype} "
            "(train with mixed_precision='bf16' or 'fp16', or use attention_impl='xla')"
        )
    if sq % FLASH_KERNEL_SEQ_MULTIPLE or skv % FLASH_KERNEL_SEQ_MULTIPLE:
        raise ValueError(
            f"sequence lengths ({sq}, {skv}) must be multiples of "
            f"{FLASH_KERNEL_SEQ_MULTIPLE} (the kernels' tile)"
        )
    dev, dt = q.device, q.dtype
    _check(q, "q", dt, (b, h, sq, d), dev)
    _check(k, "k", dt, (b, kvh, skv, d), dev)
    _check(v, "v", dt, (b, kvh, skv, d), dev)
    kv_mask, q_seg, kv_seg = masks
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("q_seg and kv_seg must be given together")
    ptrs = []
    for t, what, n in ((kv_mask, "kv_mask", skv), (q_seg, "q_seg", sq), (kv_seg, "kv_seg", skv)):
        if t is not None:
            _check(t, what, torch.int32, (b, n), dev)
        ptrs.append(None if t is None else t.data_ptr())
    return (b, h, kvh, sq, skv, d), ptrs, name + KERNEL_DTYPES[dt]


def flash_fwd(q, k, v, masks, causal: bool, sm_scale: float):
    """Flash forward: q [B, H, Sq, D], k/v [B, KVH, Skv, D] (bf16 or fp16 on
    CUDA: the ``flash_fwd`` or ``flash_fwd_f16`` entry),
    ``masks = (kv_mask [B, Skv], q_seg [B, Sq], kv_seg [B, Skv])`` int32 or
    None -> ``(out [B, H, Sq, D], lse [B, H, Sq] fp32)``. CPU tensors run
    the plain version."""
    if q.device.type == "cpu":
        from .attention import flash_fwd_reference

        return flash_fwd_reference(q, k, v, masks, causal, sm_scale)
    (b, h, kvh, sq, skv, d), mp, entry = _flash_shapes(q, k, v, masks, "flash_fwd")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = _stream(q.device)
    _launch(
        entry, q.data_ptr(), k.data_ptr(), v.data_ptr(), *mp,
        out.data_ptr(), lse.data_ptr(), b, h, kvh, sq, skv, d, int(causal),
        float(sm_scale), stream,
    )
    return out, lse


def _flash_bwd_inputs(q, do, lse, delta):
    b, h, sq, d = q.shape
    dev = q.device
    _check(do, "do", q.dtype, (b, h, sq, d), dev)
    _check(lse, "lse", torch.float32, (b, h, sq), dev)
    _check(delta, "delta", torch.float32, (b, h, sq), dev)


def flash_bwd_dq(q, k, v, do, lse, delta, masks, causal: bool, sm_scale: float):
    """dQ of flash attention from the forward's lse and delta = rowsum(dO
    * O), both [B, H, Sq] fp32 -> dq [B, H, Sq, D]. CPU tensors run the
    plain version."""
    if q.device.type == "cpu":
        from .attention import flash_bwd_dq_reference

        return flash_bwd_dq_reference(q, k, v, do, lse, delta, masks, causal, sm_scale)
    shape, mp, entry = _flash_shapes(q, k, v, masks, "flash_bwd_dq")
    _flash_bwd_inputs(q, do, lse, delta)
    b, h, kvh, sq, skv, d = shape
    dq = torch.empty_like(q)
    stream = _stream(q.device)
    _launch(
        entry, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *mp, dq.data_ptr(), b, h, kvh, sq, skv, d,
        int(causal), float(sm_scale), stream,
    )
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, masks, causal: bool, sm_scale: float):
    """dK and dV of flash attention, summed over each kv head's query-head
    group -> ``(dk, dv)`` [B, KVH, Skv, D]. CPU tensors run the plain
    version."""
    if q.device.type == "cpu":
        from .attention import flash_bwd_dkv_reference

        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, masks, causal, sm_scale)
    shape, mp, entry = _flash_shapes(q, k, v, masks, "flash_bwd_dkv")
    _flash_bwd_inputs(q, do, lse, delta)
    b, h, kvh, sq, skv, d = shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    stream = _stream(q.device)
    _launch(
        entry, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *mp, dk.data_ptr(), dv.data_ptr(), b, h, kvh,
        sq, skv, d, int(causal), float(sm_scale), stream,
    )
    return dk, dv


def _dense_decode_shapes(q, k, pos, name, *same):
    """Check what both dense decode kernels share on a CUDA device
    (:func:`_decode_rows_check`'s shapes, a cache of one position or
    more, q bf16 or fp16 and each ``(what, tensor)`` of ``same`` in q's
    dtype); returns ``(b, kvh, group, sq, length, d)`` and the entry
    point's name."""
    _require_cuda(q, name)
    b, h, sq, d = q.shape
    kvh, length = k.shape[1], k.shape[2]
    group = _decode_rows_check(h, sq, d, kvh, "dense decode")
    if length < 1:
        raise ValueError("dense decode needs a cache of at least one position")
    entry = _entry(name, q, *same)
    _check(q, "q", q.dtype, (b, h, sq, d), q.device)
    _check(pos, "pos", torch.int32, (b, sq), q.device)
    return (b, kvh, group, sq, length, d), entry


def _check_aligned(*named):
    for what, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{what} must start on a 16-byte boundary (16-byte loads)")


def dense_decode(q, k, v, pos, sm_scale: float):
    """Decode attention over a dense cache: q [B, H, Sq, D] and k/v
    [B, KVH, L, D], bf16 (``dense_decode``) or fp16 (``dense_decode_f16``),
    pos [B, Sq] int32 -> out [B, H, Sq, D]; query row
    t of batch row b attends kv positions <= pos[b, t]. CPU tensors run
    the plain version."""
    if q.device.type == "cpu":
        from .attention import decode_attention_reference

        return decode_attention_reference(q, k, v, pos, sm_scale)
    (b, kvh, group, sq, length, d), name = _dense_decode_shapes(
        q, k, pos, "dense_decode", ("k", k), ("v", v))
    dev = q.device
    _check(k, "k", q.dtype, (b, kvh, length, d), dev)
    _check(v, "v", q.dtype, (b, kvh, length, d), dev)
    _check_aligned(("q", q), ("k", k), ("v", v))
    per_split, n_splits, workspace = _decode_plan(q, kvh, length, d)
    out = torch.empty_like(q)
    stream = _stream(dev)
    _launch(
        name, q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), workspace.data_ptr(), b, kvh, group, sq, length, d, per_split,
        n_splits, float(sm_scale), stream,
    )
    return out


def dense_decode_quant(q, k, v, k_scale, v_scale, pos, sm_scale: float, bits: int):
    """Decode attention over a dense quantized cache: q [B, H, Sq, D] bf16
    (``dense_decode_quant``) or fp16 (``dense_decode_quant_f16``: the
    payloads dequantized to fp16),
    k/v int8 payloads [B, KVH, L, D] (``bits`` 8) or [B, KVH, L, D / 2]
    (``bits`` 4, two values a byte), k_scale/v_scale [B, KVH, L, 1] fp32,
    pos [B, Sq] int32 -> out [B, H, Sq, D]. CPU tensors run the plain
    version (dequantize, then the masked-dense read)."""
    _quant_bits_check(bits)
    if q.device.type == "cpu":
        from .attention import decode_attention_reference

        return decode_attention_reference(q, k, v, pos, sm_scale, k_scale=k_scale,
                                          v_scale=v_scale, kv_quant_bits=bits)
    (b, kvh, group, sq, length, d), name = _dense_decode_shapes(q, k, pos,
                                                                "dense_decode_quant")
    pd = d // 2 if bits == 4 else d
    dev = q.device
    _check(k, "k payload", torch.int8, (b, kvh, length, pd), dev)
    _check(v, "v payload", torch.int8, (b, kvh, length, pd), dev)
    _check(k_scale, "k_scale", torch.float32, (b, kvh, length, 1), dev)
    _check(v_scale, "v_scale", torch.float32, (b, kvh, length, 1), dev)
    _check_aligned(("q", q), ("k payload", k), ("v payload", v))
    per_split, n_splits, workspace = _decode_plan(q, kvh, length, d)
    out = torch.empty_like(q)
    stream = _stream(dev)
    _launch(
        name, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), pos.data_ptr(), out.data_ptr(),
        workspace.data_ptr(), b, kvh, group, sq, length, d, bits, per_split, n_splits,
        float(sm_scale), stream,
    )
    return out
