"""ctypes bindings for ``csrc/host_runtime.cpp``, built with g++ at first use.

Counterpart of ``accelerate_tpu/runtime/native.py`` for the load path's
quantizer and the data loader's prefetch ring (``host_ring_*``, bound
here and driven by ``runtime/prefetch.RingBuffer``) with its parallel
copy (:func:`parallel_memcpy`).
The library has a plain C interface, so one ``g++ -O3 -shared -fPIC
-pthread`` builds it, and a ctypes call releases the interpreter lock.
It is built into ``accelerate_tpu_torch/_build/`` under a name keyed by
the source's hash, the flags, the machine and the CPU's feature flags (a
``-march=native`` library from another CPU is never loaded). A failed
build raises: nothing falls back to the plain version behind it. Which
of the two quantizes a weight is a shape rule
(:func:`native_quantize_supported`), the reference's own gate.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host_runtime.cpp"
BUILD_DIR = _PKG / "_build"
CFLAGS = ["-O3", "-march=native", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
          "-pthread"]
COMPILER = "g++"

_lock = threading.Lock()
_lib = None
# one quantize call at a time: each already runs a thread per core, and
# the load pipeline's quantize workers would otherwise run cores x
# workers threads at once
_call_lock = threading.Lock()


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):  # x86, aarch64
                    return line
    except OSError:
        pass
    return ""


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CFLAGS).encode()
                         + platform.machine().encode() + _cpu_flags().encode())
    return BUILD_DIR / f"libhost_runtime-{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path.
    Compiles to a private name and renames it into place, so concurrent
    builds never load a half-written file. Raises with g++'s output on
    failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([COMPILER, *CFLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} with {COMPILER} failed "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _get_lib():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u64 = ctypes.c_uint64
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.host_quantize_group.argtypes = [vp, i, u64, u64, u64, i, i, vp, vp, i]
            lib.host_quantize_group.restype = i
            pp = ctypes.POINTER(ctypes.c_void_p)
            lib.host_parallel_memcpy.argtypes = [pp, pp, ctypes.POINTER(u64), i, i]
            lib.host_parallel_memcpy.restype = None
            for name, argtypes, restype in (
                    ("host_ring_create", [i, u64], vp),
                    ("host_ring_destroy", [vp], None),
                    ("host_ring_close", [vp], None),
                    ("host_ring_acquire_fill", [vp], i),
                    ("host_ring_commit_fill", [vp, i], None),
                    ("host_ring_acquire_read", [vp], i),
                    ("host_ring_release_read", [vp, i], None),
                    ("host_ring_slot_ptr", [vp, i], vp),
                    ("host_ring_slot_bytes", [vp], u64)):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
        return _lib


def parallel_memcpy(copies, num_threads: int = 4) -> None:
    """Run ``copies``, a sequence of ``(dst address, src address, bytes)``,
    on up to ``num_threads`` native threads (``host_parallel_memcpy``).
    The caller keeps every buffer alive and its bytes in range."""
    copies = list(copies)
    if not copies:
        return
    n = len(copies)
    dsts = (ctypes.c_void_p * n)(*(c[0] for c in copies))
    srcs = (ctypes.c_void_p * n)(*(c[1] for c in copies))
    sizes = (ctypes.c_uint64 * n)(*(c[2] for c in copies))
    _get_lib().host_parallel_memcpy(dsts, srcs, sizes, n, num_threads)


def ring_lib():
    """The built library, for ``runtime/prefetch.RingBuffer``."""
    return _get_lib()


def native_quantize_supported(shape, group: int, bits: int, dtype: torch.dtype) -> bool:
    """The reference's gate between the native quantizer and the plain
    version: an fp32 or bf16 [K, ...] leaf with K and the rest non-empty,
    ``group`` dividing K, and for 4 bits an even group and an even K
    unless the group is all of K."""
    if len(shape) < 1 or dtype not in (torch.float32, torch.bfloat16):
        return False
    k = shape[0]
    n = 1
    for s in shape[1:]:
        n *= s
    if k == 0 or n == 0 or k % group:
        return False
    if bits == 4 and k != group and (group % 2 or k % 2):
        return False
    return True


def quantize_group_native(w: torch.Tensor, group: int, bits: int, nf4: bool):
    """Quantize the CPU tensor ``w`` [K, ...] per group of ``group`` rows
    along dim 0: ``(data int8 [K or (K + 1) / 2, ...], scale fp32
    [K / group, ...])``, the layout ``utils/quantization.quantize_array_host``
    gives. ``w`` must pass :func:`native_quantize_supported`. A call runs
    one native thread per core, and calls from several threads run one
    at a time (:data:`_call_lock`)."""
    if not native_quantize_supported(tuple(w.shape), group, bits, w.dtype):
        raise ValueError(f"the native quantizer does not take a {tuple(w.shape)} {w.dtype} "
                         f"leaf at group {group}, {bits} bits")
    w = w.detach().to("cpu").contiguous()
    k = w.shape[0]
    n = w.numel() // k
    out_q = torch.empty(((k if bits == 8 else (k + 1) // 2),) + tuple(w.shape[1:]),
                        dtype=torch.int8)
    out_scale = torch.empty((k // group,) + tuple(w.shape[1:]), dtype=torch.float32)
    lib = _get_lib()
    with _call_lock:
        rc = lib.host_quantize_group(
            w.data_ptr(), 0 if w.dtype == torch.float32 else 1, k, n, group, bits, int(nf4),
            out_q.data_ptr(), out_scale.data_ptr(), os.cpu_count() or 1)
    if rc != 0:
        raise RuntimeError(f"host_quantize_group failed with code {rc}")
    return out_q, out_scale
