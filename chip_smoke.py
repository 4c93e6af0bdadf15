"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the nine hand-written kernel sources of ``accelerate_tpu_torch/csrc``
with nvcc for sm_90a and holds each against its plain PyTorch version:
the paged decode kernel and its int8/int4 entry (Sq 1 and the verify
step's Sq 5, plus six edge cases of its split kv walk in bf16, int8 and
int4: a slot at position 0, lengths at a split edge +- 1, Sq 5 rows
across a split edge, Sq 16 at group 2, group 1, pages of 8 and 32) and
the ragged prefill kernel and its int8/int4 entry
(quantize-on-write payloads and scales bit for bit; a 512-row pack, a
pack of 2-3 slots a 64-row tile at CAP 208, and a 1536-position arena
prefix under a 512-row tail) at the serving path's shapes (small_1b:
H=16, KVH=8, D=128, page 16), the flash forward, dQ and dK/dV kernels
and their fp16 entries at the training path's (B 8, S 2048, causal) and
in masked cases, the
dense decode kernel and its int8/int4 entry at the flat engine's and
generate()'s shapes, at Sq 4, and in seven edge cases of its split kv
walk in bf16, int8 and int4 (position 0, 63/64/65, split edges +- 1,
Sq 16 at groups 2 and 1, L 1000, L 1001 with a row parked at 1000, rows
at or past L), and its D 64 instantiation at t5-base's decode (B 4,
H = KVH = 12, L 1024, positions 1, 32 and 63 of a 64-token generation;
position 0, 63/64/65, split edges +- 1 and B 1 as edge cases, on their
own generators). The fp16 entries of the paged decode, ragged prefill
and dense decode kernels and of their int8/int4 entries (each source's
second instantiation, ``*_f16``) are held against their plain versions
at the same shapes and cases, on generators of their own, D 64 included.
Each is timed beside its bound and one SDPA call in its own dtype (the
median of seven reads, with their spread). The flash and the ragged
prefill kernels run on the tensor cores: the SASS of each entry's own
instantiation's functions (bf16 and fp16) must hold warpgroup matrix
multiplies (HGMMA) and TMA tile loads (UTMALDG), or the run fails; the
eight decode entries (paged and dense, 16-bit and int8/int4, bf16 and
fp16) must hold mma.sync products (HMMA) and cp.async copies (LDGSTS),
and ptxas must report no spills in their functions; the dense library's
D 64 functions are gated on their own, in each element type (HMMA and
LDGSTS in its split kernels, no spill in them or their merge pass).
Then it drives twenty-four
paths at full width, each with the launch counters reset just before
each run and read just after. Every decode step, verify step and decode
burst of those paths runs as the replay of a CUDA graph
(``accelerate_tpu_torch/utils/cuda_graphs.py``): each engine captures
its step when it warms up, before the counters are reset, and each
generate() call captures its decode step after its prefill; a replay
adds the launches its capture recorded, so the counts read as the eager
steps' did. Each capture prints its seconds and the memory reserved
after it. The zeroed-kernel controls build their engine or call inside
the patch, so their graphs replay the zeroed wrapper:

- serving: the paged ``ServingEngine`` on small_1b over random weights
  from a seed, the generated tokens checked against a teacher-forced
  cache-free forward;
- flat serving: the same requests through the flat-arena engine
  (``page_size=None``), checked alike, with a control run whose dense
  decode output is zeroed and must fail the check;
- quantized serving: the same requests on the int8 and the int4 paged
  arena (the quantized kernel entries only), tokens checked against a
  teacher-forced quantized single-stream replay with plain kernels, a
  zeroed-kernel control, arena bytes against bf16; then the drift
  harness (``kv_quant_drift``) on small_1b;
- speculative verify: ``spec_draft_len=4`` on the bf16 and the int8
  paged arena, one paged decode launch per layer per verify step,
  tokens checked teacher-forced, timed beside the run without spec;
- fp16 serving (``fp16_serve_path``): small_1b built in fp16 and served
  paged, flat, paged int8 and int4, flat int8 and with spec K 4, on the
  fp16 entries only (no bf16 serving entry may launch), tokens gated as
  the bf16 paths', zeroed-kernel controls failing, TTFT / step / tokens/s
  beside the bf16 paged run's;
- decode bursts: the main path's requests at ``steps_per_call`` 4 and
  8, whose tokens, decode steps, prefill dispatches and launches must
  equal the main path's, then the replica's concurrent wave once more
  at ``steps_per_call`` 4, beside the wave at 1 of the replica path;
- multi-tenant scheduling: small_1b's paged bf16 engine under
  ``scheduler=`` and ``faults=``, a batch tenant whose requests ask 1.5x
  the arena's pages and an interactive tenant that preempts it, with a
  page squeeze (a watermark shed), a poisoned request, a request with
  ``timeout_s=0`` and the ITL controller; every request terminal,
  preemption with its resumption, tokens teacher-forced against a
  zeroed paged-decode control, no graph captured after warmup, no page
  leaked; the storm runs three times with a telemetry session and three
  times without, in alternating pairs, the traced runs held to the same
  gates and to the telemetry's (one request record per submission equal
  to its request, no capture in flight, histogram counts the engine's
  first tokens and gaps, per-tenant decode tokens the emitted ones), the
  traced median tokens/s at least 0.70x the untraced, and one more
  traced storm times every hook entry point; then the interactive
  requests alone and the preempted ones uninterrupted (exact-match
  counts printed);
- the telemetry replica: a session-attached engine behind
  ``ReplicaServer``, concurrent streams, ``/metrics`` carrying the
  session's TTFT / ITL histograms and usage meters with the right
  counts, and ``POST /v1/flight`` writing a bundle that parses;
- the fleet: two small_1b ``ReplicaServer`` engines A and B on loopback
  HTTP over one model, page 16: a bf16 handoff A -> B over
  ``/v1/kv/export`` and ``/v1/kv/import`` (B's tokens and first-step
  logits equal A's warm hits, B prefills only the tails), an int8
  handoff (pages bit-equal, payloads and scales), a prefix demoted to
  the host tier by another prompt and restored (tokens of a never-evicted
  hit, pages back to baseline, no graph captured after warmup), a fresh
  engine restoring from the disk blobs (a truncated copy rejected), a
  peer pull through A's directory, then a ``RouterServer`` and its
  ``FleetCollector`` over A and B: sessions held to their replica, A
  drained (its sessions move to B with their KV), then killed with
  streams in flight (re-queued onto B, each exactly its budget), A down
  within one poll; the handoff's MB and MB/s, B's TTFT cold and after
  the import, the restore batches' ms and the router's TTFT / ITL are
  printed, its launches on their own line;
- fleet operations: one seeded two-tenant workload (``FLEET_OPS_SPEC``)
  replayed closed loop on an in-process small_1b engine with a telemetry
  session (one schedule digest, a scorecard that conserves against
  ``serving/requests_terminal``, tokens teacher-forced, #4 / #6 launches
  from the engine's own steps and dispatches, no capture after warmup,
  the capacity gauges), then open loop by ``loadtest run --url`` through
  a router over two ``serve replica --invariant-prefill`` processes
  (every waterfall summing to its client TTFT), canary goldens recorded
  on an idle replica and passing on both under that load, a third
  replica over ``--init-seed 1`` failing every golden, firing
  ``canary_failing``, dumping its flight recorder and reconstructed as
  an incident, a layout control, and the autoscaler spawning a
  ``serve replica`` through a load ramp, gating, placing, then draining
  and reaping it with its conservation ledger (``fleet_ops_path``; its
  launches on their own line);
- the replica: the paged engine behind the port's ``ReplicaServer`` on
  loopback HTTP, a sequential pass whose tokens and launches must equal
  the in-process engine's fed one request at a time, a concurrent wave
  from 9 client threads (teacher-forced, launches from the replica
  engine's own steps and dispatches; client-side tokens/s, TTFT and
  ITL), then ``python -m accelerate_tpu_torch.commands.serve replica``
  as a subprocess on the int8 arena (tokens against the in-process int8
  engine, a cancel mid-stream, exit code 0 after SIGTERM) and
  ``--config tiny`` refused on CUDA by the decode kernels' gate;
- training: ``Accelerator(mixed_precision="bf16")`` over fp32 master
  weights, a few steps of the eager loop and of ``build_train_step``,
  launch counts of layers x micro-batches per step, a falling loss on a
  fixed batch, one step held against plain attention, throughput, MFU,
  peak memory and a step profile; the peak memory of each remat policy;
- fp16 training (``train_fp16_path``): ``DecoderConfig(dtype=float16)``
  under ``mixed_precision="fp16"`` through both entry points on the fp16
  flash entries only, one step against plain fp16 attention with the
  dQ-, dK- and dV-zeroed controls, a falling loss, the cost of the
  unscale and finite check; an overflow walk from an init_scale of 2^40
  whose skipped updates leave every parameter bitwise and whose scale
  follows a host replay of the reference's rule; dropout 0.1 under no
  remat and the three policies (one seed, one loss; each policy's
  gradients against no remat's; peak memory, flash forward launches);
  a telemetry session with a JSONL tracker (``sys/mfu_pct`` against the
  phase's own reckoning, the loss scale and skipped flag, the
  exposition, ``metrics.jsonl``);
- fp8 training and inference (``train_fp8_path``): the fp8 products
  (``ops/fp8.py``: ``torch._scaled_mm`` on the fp8 tensor cores, no TPU
  kernel) of small_1b's four projection shapes at 16384 tokens, forward
  and both backward products, against their plain version (within 2^-7
  of the output's largest |entry|), the quantizers bit-equal to the
  CPU's, each timed beside bf16 ``torch.matmul`` and its fp8 bound;
  ``mixed_precision="fp8"`` on small_1b: 8 current-scaling steps with a
  falling loss, 448 products and 16 launches of each flash kernel a
  step, the first step within 1% (loss) and 10% (grad norm) of the bf16
  control on the same weights, throughput, MFU and a profile; the
  delayed recipe over two micro-batches an update (every history one
  slot on, ``fp8_amax_health``'s ``stale_frac`` 0, user ``loss_fn``
  updates leaving the histories); generate() on an fp8 model captured
  and uncaptured with equal tokens, its teacher-forced logits within
  0.25 of the largest |logit| of the bf16 model's; a delayed
  ``save_state`` / ``load_state`` resume at 2 layers bit for bit;
- checkpoints: small_1b trained as above over the port's shuffled
  ``DataLoader``, saved twice mid-epoch (``save_state`` with automatic
  naming, ``total_limit=1``) and resumed from the newest checkpoint by a
  fresh Accelerator over other weights: losses, learning rates, a CUDA
  draw and every parameter equal the uninterrupted run's bit for bit,
  each resumed micro-step launches the three flash kernels once per
  layer, and two controls (no optimizer state, no loader position) end
  elsewhere; then ``save_model`` shards the trained weights, and the
  export, read into a fresh model, greedily generates the trained
  model's tokens; a telemetry session around the last save and the
  resume holds one ``checkpoint/save`` and one ``checkpoint/restore``
  span, and its goodput ledger's checkpoint seconds equal the two calls'
  walls within 5%;
- generation: ``generate()`` on llama_7b (8 of its 32 layers: the depth
  cut to give the run's time back) with bf16, int8 and int4 KV caches,
  launch counts per call, every step's logits held against the plain
  forward (and a zeroed-kernel control), decode ms/token by
  differential timing beside the weight-read bound, with the decode step
  captured (as generate() runs it) and uncaptured, and a decode-step
  profile of both;
- big-model dispatch: generate()'s llama_7b weights written as the
  reference's stacked bf16 checkpoint (sharded, with an index) in a
  temporary directory, then ``load_checkpoint_and_dispatch`` and
  ``generate_dispatched`` (a) all on the card, tokens identical to
  generate() on the in-memory model, TTFT split into the load's phases
  and the prefill; (b) on three tiers under an explicit ``max_memory``,
  tokens identical to (a), peak device memory under its limit, ms/token
  against the host-tier bytes over a measured pinned H2D rate, and a
  control whose streamer skips one layer's copies; (c) quantized on load
  (int8, NF4 + double quant), tokens identical to generate() on the
  dequantized weights, packed bytes and the weight bytes a step reads;
  (a), (b) and (c)'s int8 load also served by the paged engine through
  ``ServingEngine.from_dispatched``, (b)'s tokens equal to (a)'s;
- seq2seq (``seq2seq_path``): ``generate_seq2seq`` greedy on t5-base
  (``Seq2SeqConfig()``: 12 + 12 layers, E 768, D 64) over B 4 sources of
  512 tokens, two right-padded to 384 and 200, 64 new tokens: 12 x 63
  dense decode launches (the D 64 instantiation) and no flash launch,
  tokens teacher-forced against the uncached plain forward, TTFT
  (encoder + prefill), ms/token and the decode step captured against
  eager; ``seq2seq_dispatch``: the same weights written as the
  reference's stacked checkpoint and dispatched with the decoder's MLP
  leaves on the pinned-host tier (tokens equal bit for bit) and int8 on
  load (teacher-forced);
- seq2seq and encoder training (``seq2seq_train_path``,
  ``encoder_train_path``): t5-base at B 8, source 512, target 128 and
  bert-base at bench.py's row (B 64 x 128, dropout 0.1,
  ``steps_per_call=10``), bf16 over fp32 masters through
  ``build_train_step``: a finite (t5: falling) loss, no kernel launch
  (attention at head_dim 64 is plain, as the reference routes it), step
  ms, throughput, MFU and a profiled step.
- MoE serving (``moe_serve_path``): small_1b with 8 experts, top-2
  (4.70B parameters, 9.39 GB bf16) on the paged arena, the flat arena,
  int8 KV and spec K 4, #4 / #5 / #6 only on their entries; each run
  recorded again eager (its tokens equal to the served run's) and
  replayed with the plain kernels in the run's own routing groups and
  expert choices, every read row within TOP2_MARGIN of the replay's
  argmax; a control with each layer's most chosen expert's w_down
  zeroed fails that gate; tokens/s, TTFT and ms/step beside the dense
  paged run, the step's weight-read bound, the token-slots prefill
  drops; ``moe_generate_path``: its generate() at B 4 x 512 (#1 in the
  prefill, #5 a step), held alike, ms/token captured and eager;
- MoE training (``moe_train_path``): that model at 8 of its 16 layers,
  B 8 x 2048, bf16 over fp32 masters, AdamW through
  ``build_train_step``: the flash kernels per layer a step, a finite
  aux_loss, a falling loss, one step against plain attention in the
  flash step's expert choices with the dQ-, dK- and dV-zeroed controls
  beyond, tokens/s and MFU on the FLOPs a token uses;
- ResNet training (``resnet_train_path``): ResNet-50 at bench.py's row
  (B 64, 224^2, SGD 0.1 momentum 0.9, 12 steps as
  ``build_train_step(steps_per_call=4)``), bf16 channels_last on cuDNN:
  a falling loss, every BatchNorm statistic moved, finite eval logits,
  samples/s and MFU on the convolutions' FLOPs;
- the single-process surface (``accelerate_surface_path``): small_1b at
  B 8 x 2048 under ``PartialState`` and the Accelerator's process API
  on the card; ``find_executable_batch_size`` from B 128 against the
  card's own out-of-memory error, the allocated memory back within 64
  MiB after each failed try and a control that keeps the failed try's
  exception failing that gate; ``Accelerator.profile`` around two fused
  steps, the Chrome trace's #1-#3 kernel events equal to the launch
  counters; 16 steps over a prepared ``DataLoader`` with
  ``prefetch_depth=3``, every batch equal on the card to the loader's
  without prefetch, ``end_of_dataloader`` on the last only, no producer
  thread left after the epoch or an early break.

The decode profiles (paged bf16, flat, int8, verify; generate() at B 1
bf16 and B 4 int8) read wall, device busy and idle share per step for
the uncaptured step body (this script hands the engine, or generate(),
the body in place of its graph), the captured step, and bursts of 4.

Prints each phase's wall seconds and their total on one line, the
card, the per-kernel numbers, and as its last line
``{"ok": true, "device": {"platform": "gpu", ...}}``.

Exits non-zero, with no result line, when CUDA is absent, when the
package is not beside this script, or when any phase fails.

fp32 matmuls and convolutions are kept at full fp32 (TF32 off) so the
plain versions are exact fp32 references.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound's rates
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# kernel vs plain, both bf16 out: |kernel - plain| <= ATOL + RTOL*|plain|.
# The two paths round p to bf16 at different points of the online
# softmax and each rounds its output to bf16, whose spacing is 2^-7
# relative at worst: RTOL allows two such ulps of the output, ATOL two
# ulps of p's rounding over a convex combination of |v| <~ 1
KERNEL_ATOL = 2.0 ** -6
KERNEL_RTOL = 2.0 ** -6
# teacher-forced check: a generated token is the plain forward's argmax
# or within this many logits of it. Both runs keep activations in bf16
# (relative 2^-8 per rounding) through 16 layers; logits of these random
# weights have a spread of ~1, so 0.25 leaves room for accumulated
# rounding while still catching a wrong path (which lands anywhere)
TOP2_MARGIN = 0.25

PAGE = 16
H, KVH, D = 16, 8, 128
# the main path's TTFT p50 in three runs of this script with the ragged
# prefill kernel on the CUDA cores (before its tensor-core design), NVIDIA
# H100 80GB HBM3 at 700 W: host-clock readings, which move ~1.5x between
# runs, printed beside this run's for scale
CUDA_CORE_PREFILL_TTFT_MS = (75.27, 48.92, 70.03)
MAX_CACHE = 2048


# every CUDA graph capture's own seconds (warm-up included), in order:
# main() installs the logging capture that appends them
CAPTURE_SECONDS = []


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


# cycles the card spins (torch.cuda._sleep) before a timed run: ~60 ms at
# an H100's clocks, longer than the host takes to queue the run's launches
TIMING_SLEEP_CYCLES = 100_000_000


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time on the card of one call of ``fn``: CUDA events around
    ``iters`` calls queued behind a spin of the card, so the card runs
    them back to back and the host's own cost per call (tens of
    microseconds of Python, ctypes and tensor-map encoding, more than a
    short kernel takes) is not read as the kernel's time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(TIMING_SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# The yardstick of every kernel row: one PyTorch call for the same
# function (SDPA). Its time moves between reads in one run (a single
# 20-launch mean of the ragged prefill's SDPA read 0.0654 ms in one run,
# 0.3436 in another), so a library time is the median of LIBRARY_READS
# separate reads, each after its own warmup, printed with their spread
LIBRARY_READS = 7


def library_ms(fn, reads: int = LIBRARY_READS, **kw):
    """``(median, min, max)`` of ``reads`` separate ``cuda_time_ms`` reads
    of ``fn``, each after its own warmup (``kw`` goes to each read)."""
    times = sorted(cuda_time_ms(fn, **kw) for _ in range(reads))
    return times[len(times) // 2], times[0], times[-1]


def library_text(lib) -> str:
    return f"{lib[0]:.4f} ms (median of {LIBRARY_READS} reads, {lib[1]:.4f}-{lib[2]:.4f})"


def check_close(name: str, got, want) -> float:
    """Max abs error of ``got`` vs ``want``; fails past the stated tolerance."""
    diff = (got.float() - want.float()).abs()
    limit = KERNEL_ATOL + KERNEL_RTOL * want.float().abs()
    err = diff.max().item()
    if not math.isfinite(err) or bool((diff > limit).any()):
        fail(f"{name} vs plain: max abs err {err} exceeds {KERNEL_ATOL} + "
             f"{KERNEL_RTOL} * |plain|")
    return err


# the kernels' element types as their template instantiations are mangled
# (by entry-point suffix): a library holds both its bf16 and its fp16
# entry, and each entry's SASS and spill gates read its own functions only
DTYPE_MANGLED = {"": "13__nv_bfloat16", "_f16": "6__half"}
SASS_FUNCTIONS = {name + sfx: mangled
                  for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_decode",
                               "paged_decode_quant", "dense_decode", "dense_decode_quant",
                               "ragged_prefill", "ragged_prefill_quant")
                  for sfx, mangled in DTYPE_MANGLED.items()}


def name_holds(name: str, fragment) -> bool:
    """Whether a mangled function name holds ``fragment`` (a string, or a
    tuple of strings it must all hold)."""
    return all(f in name for f in ((fragment,) if isinstance(fragment, str) else fragment))


def sass_of(text: str, fragment) -> str:
    """The SASS of the functions of a ``cuobjdump -sass`` listing whose
    (mangled) name holds ``fragment`` (``name_holds``); the whole listing
    without one."""
    if fragment is None:
        return text
    parts = text.split("Function : ")
    return "".join(p for p in parts[1:] if name_holds(p.split("\n", 1)[0], fragment))


@functools.lru_cache(maxsize=None)
def sass_listing(lib: Path) -> str:
    """The ``cuobjdump -sass`` listing of a built library, with the
    cuobjdump of nvcc's toolkit, read once (the bf16 and fp16 entries of
    a source share its library)."""
    from accelerate_tpu_torch.ops import kernels

    tool = Path(kernels.nvcc_path()).parent / "cuobjdump"
    res = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -sass {lib.name} failed: {res.stderr.strip()[-500:]}")
    return res.stdout


def sass_gate(names, ops, what: str, fragment=None, label: str = "") -> dict:
    """Count each of ``ops`` in the SASS of each built library of
    ``names`` (of each entry, its own instantiation's functions:
    ``SASS_FUNCTIONS``; with ``fragment``, the functions whose mangled
    name holds it, printed under the name plus ``label``), read from its
    ``sass_listing``; fails unless every one is present in each (the
    kernel does not ``what``)."""
    from accelerate_tpu_torch.ops import kernels

    counts = {}
    for name in names:
        text = sass_of(sass_listing(kernels.library_path(name)),
                       fragment or SASS_FUNCTIONS.get(name))
        counts[name + label] = {op: text.count(op) for op in ops}
        print(f"{name}{label} SASS: "
              + ", ".join(f"{op} {n}" for op, n in counts[name + label].items()))
    for name, found in counts.items():
        if not all(found.values()):
            fail(f"{name} does not {what}: SASS counts {found}")
    return counts


# the decode kernels' entries (csrc/decode_common.cuh: paged and dense,
# each 16-bit and int8/int4, in bf16 and in fp16) run their products on
# mma.sync (HMMA in SASS) over tiles staged by cp.async (LDGSTS)
DECODE_KERNELS = ("paged_decode", "paged_decode_quant", "dense_decode", "dense_decode_quant")
DECODE_KERNELS_F16 = tuple(name + "_f16" for name in DECODE_KERNELS)


def spill_gate(reports: dict, name: str, fragments, label: str = ""):
    """Fail if ptxas reported a spill in a function of kernel ``name``'s
    library whose mangled name holds one of ``fragments`` (``name_holds``),
    or no such function was compiled (``reports``: ``kernels.build()``'s
    ptxas output of what this run compiled); prints the count and the
    spill bytes under the name plus ``label``."""
    import re

    report = reports.get(name)
    if report is None:
        print(f"{name}{label}: library reused from an earlier build, no ptxas report")
        return
    spills = []
    for part in report.split("Compiling entry function")[1:]:
        if any(name_holds(part.split("\n", 1)[0], f) for f in fragments):
            spills += [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", part)]
    print(f"{name}{label} ptxas: {len(spills) // 2} kernels, spill bytes {sum(spills)}")
    if not spills or any(spills):
        fail(f"{name}{label}: ptxas reports spills (or no such function): {spills}")


def decode_spill_gate(reports: dict):
    """Fail if ptxas reported a spill in any decode entry's own functions
    (each entry's instantiation: ``SASS_FUNCTIONS``)."""
    for name in DECODE_KERNELS + DECODE_KERNELS_F16:
        spill_gate(reports, name, (SASS_FUNCTIONS[name],))


# the dense decode kernel's D 64 instantiation (csrc/decode_common.cuh
# launch_d<64, ...>: the split kernel at each row tile, and its merge pass),
# as its template functions are mangled: t5-base's cached decode runs it
D64_SPLIT, D64_FUNCTIONS = "split_kernelILi64E", ("split_kernelILi64E", "merge_kernelILi64E")


def d64_spill_gate(reports: dict):
    """Fail if ptxas reported a spill in a function of the dense decode
    library's D 64 instantiation (``D64_FUNCTIONS``) of either entry, bf16
    and fp16, or none was compiled."""
    for sfx, mangled in DTYPE_MANGLED.items():
        spill_gate(reports, "dense_decode" + sfx, [(f, mangled) for f in D64_FUNCTIONS],
                   " (D 64)")


def dtype_suffix(dtype) -> str:
    """The entry-point suffix of a kernel's element type (None: bf16):
    "" or "_f16"."""
    import torch

    from accelerate_tpu_torch.ops import kernels

    return kernels.KERNEL_DTYPES[dtype or torch.bfloat16]


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------


# the paged-serving decode shape: 8 live slots of these lengths plus one
# parked at position 2047 (all-parking table row), shuffled page ids
PAGED_LENGTHS = [17, 130, 256, 511, 700, 1024, 1300, 1500]
SPEC_K = 4  # speculative draft length of the spec path: verify reads Sq = 5


def paged_case(dev, sq: int):
    """Page table [9, 128] and query positions [9, sq] of the paged decode
    shape: live slot s holds PAGED_LENGTHS[s] + sq - 1 tokens on pages
    drawn from a shuffled range and queries its last sq positions (sq 1 a
    decode step, sq K + 1 a verify step); the parked slot queries 2047 on
    every row. Returns ``(table, pos, num_pages)``."""
    import torch

    p_per_slot = MAX_CACHE // PAGE
    b = len(PAGED_LENGTHS) + 1
    live_pages = [-(-(n + sq - 1) // PAGE) for n in PAGED_LENGTHS]
    num_pages = 1 + sum(live_pages)
    host_gen = torch.Generator().manual_seed(0)
    perm = (torch.randperm(num_pages - 1, generator=host_gen) + 1).tolist()
    table = torch.zeros((b, p_per_slot), dtype=torch.int32)
    pos = torch.full((b, sq), MAX_CACHE - 1, dtype=torch.int32)
    at = 0
    for s, n in enumerate(PAGED_LENGTHS):
        table[s, : live_pages[s]] = torch.tensor(perm[at: at + live_pages[s]])
        at += live_pages[s]
        pos[s] = n - 1 + torch.arange(sq)
    return table.to(dev), pos.to(dev), num_pages


def paged_work(table, pos, row_bytes: int, heads: int = H):
    """(bytes, flops) of one paged decode call: q and out, the tables and
    positions once, every distinct page the slots' live ranges touch once
    (``row_bytes`` per token and kv head, K and V), and QK + PV over each
    query row's attended positions."""
    b, sq = pos.shape
    pages_read = set()
    for s in range(b):
        n_pages = int(pos[s].max().item()) // PAGE + 1
        pages_read.update(table[s, :n_pages].tolist())
    kv_bytes = len(pages_read) * KVH * PAGE * row_bytes * 2
    nbytes = 2 * b * heads * sq * D * 2 + kv_bytes + table.numel() * 4 + pos.numel() * 4
    attended = sum(int(p) + 1 for p in pos.flatten().tolist())  # kv per query row
    return nbytes, 4 * D * heads * attended


def paged_library_ms(q, k_pages, v_pages, table, pos):
    """SDPA with a boolean mask over each slot's pages gathered into dense
    K/V beforehand (the gather is left out of the time): ``library_ms``'s
    ``(median, min, max)``."""
    import torch
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops.attention import gather_kv_pages

    k_full = gather_kv_pages(k_pages, table)
    v_full = gather_kv_pages(v_pages, table)
    mask = (torch.arange(k_full.shape[2], device=q.device)[None, None, None, :]
            <= pos[:, None, :, None])
    return library_ms(lambda: F.scaled_dot_product_attention(
        q, k_full, v_full, attn_mask=mask, scale=1.0 / math.sqrt(D), enable_gqa=True))


def counted(name: str, fn):
    """Run ``fn`` once and fail unless kernel ``name`` counted one launch."""
    import torch

    from accelerate_tpu_torch.ops import kernels

    before = kernels.launch_counts[name]
    out = fn()
    torch.cuda.synchronize()
    if kernels.launch_counts[name] != before + 1:
        fail(f"{name} wrapper did not count its launch")
    return out


def paged_inputs(gen, dev, sq: int, dtype=None):
    """q [9, H, sq, D] and K/V pages of ``paged_case(dev, sq)`` in
    ``dtype`` (None: bf16), drawn from ``gen`` in that order. Returns
    ``(q, k_pages, v_pages, table, pos)``."""
    import torch

    table, pos, num_pages = paged_case(dev, sq)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype or torch.bfloat16)

    q = rnd(pos.shape[0], H, sq, D)
    return q, rnd(num_pages, KVH, PAGE, D), rnd(num_pages, KVH, PAGE, D), table, pos


# edge cases of the paged decode kernel's split kv walk, each checked (not
# timed) in bf16, int8 and int4 against the plain version, drawn from a
# generator of their own so no later phase's inputs move: (tag, query
# heads, Sq, page size, the last query position of each live slot as a
# function of the split length E in tokens); each slot queries its last Sq
# positions (from 0), and one parked slot (all rows at 2047 on the
# parking page) is added to every case
DECODE_EDGE_SEED = 6
DECODE_EDGES = [
    ("a: Sq 1, pos 0, tile and split edges +-1", H, 1, PAGE,
     lambda e: [0, 63, 64, e - 1, e, e + 1, 2 * e]),
    ("b: Sq 5 across split, tile and page edges", H, SPEC_K + 1, PAGE,
     lambda e: [4, 18, 66, e - 1, e + 2, e + 4, 2 * e + 1]),
    ("c: Sq 16, group 2 (R 32)", H, 16, PAGE, lambda e: [15, e + 7, e + 15, 1015]),
    ("d: group 1 (H = KVH = 8), Sq 5", KVH, SPEC_K + 1, PAGE,
     lambda e: [4, 18, 66, e - 1, e + 2, e + 4, 2 * e + 1]),
    ("e: page 8, Sq 1", H, 1, 8, lambda e: [0, 63, 64, e - 1, e, e + 1, 2 * e]),
    ("f: page 32, Sq 5", H, SPEC_K + 1, 32,
     lambda e: [4, 18, 66, e - 1, e + 2, e + 4, 2 * e + 1]),
]


def decode_edge_inputs(dev, dtype=None):
    """The DECODE_EDGES cases: ``[(tag, E, q, k_pages, v_pages, table,
    pos)]`` with pages in ``dtype`` (None: bf16), live slots on shuffled
    pages, from one generator seeded DECODE_EDGE_SEED."""
    import torch

    from accelerate_tpu_torch.ops import kernels

    gen = torch.Generator(device=dev).manual_seed(DECODE_EDGE_SEED)
    host_gen = torch.Generator().manual_seed(DECODE_EDGE_SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = []
    for tag, heads, sq, ps, lasts_of in DECODE_EDGES:
        n_live = len(lasts_of(0))
        b, p_per_slot = n_live + 1, MAX_CACHE // ps
        per_split, _ = kernels.decode_split_plan(b, KVH, MAX_CACHE, sms)
        e = per_split * kernels.DECODE_TILE
        lasts = lasts_of(e)
        need = [last // ps + 1 for last in lasts]
        num_pages = 1 + sum(need)
        perm = (torch.randperm(num_pages - 1, generator=host_gen) + 1).tolist()
        table = torch.zeros((b, p_per_slot), dtype=torch.int32)
        pos = torch.full((b, sq), MAX_CACHE - 1, dtype=torch.int32)
        at = 0
        for s, last in enumerate(lasts):
            table[s, : need[s]] = torch.tensor(perm[at: at + need[s]])
            at += need[s]
            pos[s] = (last - sq + 1 + torch.arange(sq)).clamp(min=0)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype or torch.bfloat16)

        q = rnd(b, heads, sq, D)
        cases.append((tag, e, q, rnd(num_pages, KVH, ps, D), rnd(num_pages, KVH, ps, D),
                      table.to(dev), pos.to(dev)))
    return cases


def decode_edge_checks(dev, bits_list, dtype=None) -> float:
    """Hold the paged decode kernel (``bits`` 0: 16-bit pages; 8 / 4: its
    quantized entry on pages quantized by the port's quantize_kv), in
    ``dtype`` (None: bf16; fp16: the ``_f16`` entries), against its plain
    version on every DECODE_EDGES case. Returns the max abs error."""
    from accelerate_tpu_torch.ops.attention import paged_decode_attention, paged_decode_reference
    from accelerate_tpu_torch.utils.quantization import quantize_kv

    worst = 0.0
    for tag, e, q, k_pages, v_pages, table, pos in decode_edge_inputs(dev, dtype):
        errs = []
        for bits in bits_list:
            kw, kp, vp = {}, k_pages, v_pages
            if bits:
                (kp, ks), (vp, vs) = quantize_kv(k_pages, bits), quantize_kv(v_pages, bits)
                kw = dict(k_scale=ks, v_scale=vs, kv_quant_bits=bits)
            name = ("paged_decode_quant" if bits else "paged_decode") + dtype_suffix(dtype)
            got = counted(name, lambda: paged_decode_attention(
                q, kp, vp, page_table=table, q_positions=pos, **kw))
            want = paged_decode_reference(q, kp, vp, table, pos, 1.0 / math.sqrt(D), **kw)
            errs.append(check_close(f"{name} ({entry(bits, dtype)}, edge case {tag})", got,
                                    want))
        worst = max(worst, *errs)
        print(f"kernel paged_decode{dtype_suffix(dtype)} edge case {tag} (split {e} tokens, "
              f"H {q.shape[1]}, page {k_pages.shape[2]}, slots' last positions "
              f"{pos[:, -1].tolist()}): "
              + ", ".join(f"{entry(bits, dtype)} max_abs_err {err:.3e}"
                          for bits, err in zip(bits_list, errs))
              + f" (tol {KERNEL_ATOL} + {KERNEL_RTOL}*|plain|)")
    return worst


def decode_phase(gen, dev, gen_spec, dtype=None):
    """Paged decode: 8 live slots of mixed length + one parked slot, at Sq
    1 (a decode step; inputs from ``gen``) and Sq K + 1 (a verify step;
    inputs from ``gen_spec``), in ``dtype`` (None: bf16; fp16: the
    ``paged_decode_f16`` entry, SDPA in fp16 too)."""
    from accelerate_tpu_torch.ops.attention import paged_decode_attention, paged_decode_reference

    kname = "paged_decode" + dtype_suffix(dtype)
    q, k_pages, v_pages, table, pos1 = paged_inputs(gen, dev, 1, dtype)
    spec = paged_inputs(gen_spec, dev, SPEC_K + 1, dtype)
    scale = 1.0 / math.sqrt(D)

    def run_kernel(q=q, k_pages=k_pages, v_pages=v_pages, table=table, pos=pos1):
        return paged_decode_attention(q, k_pages, v_pages, page_table=table, q_positions=pos)

    def run_plain(q=q, k_pages=k_pages, v_pages=v_pages, table=table, pos=pos1):
        return paged_decode_reference(q, k_pages, v_pages, table, pos, scale)

    b = pos1.shape[0]
    err = check_close(kname, counted(kname, run_kernel), run_plain())
    err_spec = check_close(f"{kname} (Sq {SPEC_K + 1})",
                           counted(kname, lambda: run_kernel(*spec)),
                           run_plain(*spec))
    err_edges = decode_edge_checks(dev, (0,), dtype)
    ms = cuda_time_ms(run_kernel)
    plain_ms = cuda_time_ms(run_plain)
    spec_ms = cuda_time_ms(lambda: run_kernel(*spec))
    spec_plain_ms = cuda_time_ms(lambda: run_plain(*spec))
    q_live, table_live, pos_live = q[:-1], table[:-1], pos1[:-1]
    live_ms = cuda_time_ms(lambda: paged_decode_attention(
        q_live, k_pages, v_pages, page_table=table_live, q_positions=pos_live))
    library = paged_library_ms(q, k_pages, v_pages, table, pos1)
    spec_library = paged_library_ms(*spec)
    bound_ms, bound_by = bound(*paged_work(table, pos1, D * 2))
    spec_bound_ms, _ = bound(*paged_work(spec[3], spec[4], D * 2))
    print(f"kernel {kname}: slots {b} (lengths {PAGED_LENGTHS} + parked), "
          f"max_abs_err {err:.3e} (tol {KERNEL_ATOL} + {KERNEL_RTOL}*|plain|), kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by}), "
          f"library sdpa {library_text(library)}; kernel without the parked slot "
          f"{live_ms:.4f} ms; Sq {SPEC_K + 1} (verify, per-row positions): max_abs_err "
          f"{err_spec:.3e}, kernel {spec_ms:.4f} ms, plain {spec_plain_ms:.4f} ms, bound "
          f"{spec_bound_ms * 1e3:.2f} us, library sdpa {library_text(spec_library)}; kernel / "
          f"sdpa {ms / library[0]:.3f}x (Sq 1), {spec_ms / spec_library[0]:.3f}x (Sq "
          f"{SPEC_K + 1})")
    return {"name": kname, "route": "cuda",
            "source": "accelerate_tpu_torch/csrc/paged_decode.cu",
            "replaces": "accelerate_tpu/ops/attention.py:926",
            "max_abs_err": max(err, err_spec, err_edges), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library[0]}


def paged_decode_quant_phase(gen, dev, dtype=None):
    """The paged decode kernel's int8 / int4 entry at the paged-serving
    shape (payloads from the port's quantize_kv), Sq 1 and Sq K + 1, with
    q in ``dtype`` (None: bf16; fp16: the ``paged_decode_quant_f16``
    entry, dequantizing to fp16). Returns the kernel's row (int8 at Sq 1
    timed; errors over all cases)."""
    import torch

    from accelerate_tpu_torch.ops.attention import paged_decode_attention, paged_decode_reference
    from accelerate_tpu_torch.utils.quantization import dequantize_kv, quantize_kv

    dt = dtype or torch.bfloat16
    kname = "paged_decode_quant" + dtype_suffix(dtype)
    q_spec, k_pages, v_pages, table, pos = paged_inputs(gen, dev, SPEC_K + 1, dtype)
    q, pos1 = q_spec[:, :, :1].contiguous(), pos[:, :1].contiguous()  # Sq 1: the first row
    b = pos.shape[0]
    scale = 1.0 / math.sqrt(D)
    rows, errs = {}, []
    for bits in (8, 4):
        (kq, ks), (vq, vs) = quantize_kv(k_pages, bits), quantize_kv(v_pages, bits)
        kw = dict(k_scale=ks, v_scale=vs, kv_quant_bits=bits)

        def run_kernel(q=q, pos=pos1):
            return paged_decode_attention(q, kq, vq, page_table=table, q_positions=pos, **kw)

        def run_plain(q=q, pos=pos1):
            return paged_decode_reference(q, kq, vq, table, pos, scale, **kw)

        errs.append(check_close(f"{kname} (int{bits})", counted(kname, run_kernel),
                                run_plain()))
        errs.append(check_close(f"{kname} (int{bits}, Sq {SPEC_K + 1})",
                                counted(kname, lambda: run_kernel(q_spec, pos)),
                                run_plain(q_spec, pos)))
        ms, plain_ms = cuda_time_ms(run_kernel), cuda_time_ms(run_plain)
        spec_ms = cuda_time_ms(lambda: run_kernel(q_spec, pos))
        k_deq = dequantize_kv(kq, ks, bits, dt)
        v_deq = dequantize_kv(vq, vs, bits, dt)
        library = paged_library_ms(q, k_deq, v_deq, table, pos1)
        spec_library = paged_library_ms(q_spec, k_deq, v_deq, table, pos)
        row_bytes = (D // 2 if bits == 4 else D) + 4
        bound_ms, bound_by = bound(*paged_work(table, pos1, row_bytes))
        spec_bound_ms, _ = bound(*paged_work(table, pos, row_bytes))
        print(f"kernel {kname} (int{bits}): slots {b}, Sq 1, max_abs_err "
              f"{errs[-2]:.3e} (tol {KERNEL_ATOL} + {KERNEL_RTOL}*|plain|), kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by}), library "
              f"sdpa {library_text(library)} (on K/V gathered and dequantized beforehand: "
              f"leaves out the gather and the dequant); Sq {SPEC_K + 1}: max_abs_err "
              f"{errs[-1]:.3e}, kernel {spec_ms:.4f} ms, bound {spec_bound_ms * 1e3:.2f} us, "
              f"library sdpa {library_text(spec_library)}; kernel / sdpa "
              f"{ms / library[0]:.3f}x (Sq 1), {spec_ms / spec_library[0]:.3f}x (Sq {SPEC_K + 1})")
        rows[bits] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": library[0]}
    errs.append(decode_edge_checks(dev, (8, 4), dtype))
    return dict(name=kname, route="cuda",
                source="accelerate_tpu_torch/csrc/paged_decode_quant.cu",
                replaces="accelerate_tpu/ops/attention.py:889", max_abs_err=max(errs),
                **rows[8])


# packed ragged prefill: a 512-row pack of three slots — one with an
# arena prefix (hist > 0), one ending mid-block on pad rows, and one
# whole pad block. (slot, hist, tail)
PREFILL_CAP = 512
PREFILL_PACKS = [(0, 300, 256), (1, 0, 243)]
# two more packs, each checked in every entry, from their own generators
# (so the inputs of the phases after them do not move): (a) 64-row tiles
# of 2-3 slots each with slot boundaries mid-tile, tails ending mid-block,
# arena prefixes across tile and page edges, a last partial tile of one
# slot and a pad block, at a CAP that is not a multiple of 64; (b) one
# long arena prefix under a whole-pack tail, where the operations, not the
# bytes, set the bound. (CAP, packs, trailing pad block, seed)
PREFILL_CASES = {
    "a: 2-3 slots a tile, CAP 208": (
        208, [(0, 37, 20), (1, 0, 27), (2, 100, 13), (3, 69, 40), (4, 0, 30), (5, 250, 18),
              (6, 3, 21), (7, 0, 5)], True, 3),
    "b: hist 1536 + 512 fresh": (512, [(0, 1536, 512)], False, 4),
}


def prefill_case(dev, packs=PREFILL_PACKS, cap=PREFILL_CAP, pad_block=True):
    """Page table [max slot + 2, P] (P pages cover hist + tail of every
    pack, at least 64), row_slot / row_pos [cap] and slot_hist of
    ``packs``, each slot's rows padded to the token block (pads keep the
    slot, position -1), then pad rows (slot -1) to ``cap``; with
    ``pad_block`` at least one whole pad block. Returns those and the page
    count."""
    import torch

    from accelerate_tpu_torch.ops.attention import PREFILL_TOKEN_BLOCK

    bt = PREFILL_TOKEN_BLOCK
    n_slots = max(slot for slot, _, _ in packs) + 2
    p_per_slot = max(64, max(-(-(hist + tail) // PAGE) for _, hist, tail in packs))
    table = torch.zeros((n_slots, p_per_slot), dtype=torch.int32)
    row_slot = torch.full((cap,), -1, dtype=torch.int32)
    row_pos = torch.full((cap,), -1, dtype=torch.int32)
    slot_hist = torch.zeros((n_slots,), dtype=torch.int32)
    next_page, r = 1, 0
    for slot, hist, tail in packs:
        need = -(-(hist + tail) // PAGE)
        table[slot, :need] = torch.arange(next_page, next_page + need)
        next_page += need
        nb = -(-tail // bt)
        row_slot[r: r + nb * bt] = slot
        row_pos[r: r + tail] = torch.arange(hist, hist + tail)
        slot_hist[slot] = hist
        r += nb * bt
    if r > cap or (pad_block and cap - r < bt):
        fail(f"prefill pack {packs} does not fit {cap} rows with a pad block ({pad_block})")
    rows = dict(page_table=table, row_slot=row_slot, row_pos=row_pos, slot_hist=slot_hist)
    return {k: t.to(dev) for k, t in rows.items()}, next_page


def prefill_inputs(gen, dev, cap, num_pages, dtype=None):
    """q [1, H, cap, D], k_new / v_new [1, KVH, cap, D] and K/V pages
    [num_pages, KVH, PAGE, D] in ``dtype`` (None: bf16), drawn from
    ``gen`` in that order."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype or torch.bfloat16)

    return (rnd(1, H, cap, D), rnd(1, KVH, cap, D), rnd(1, KVH, cap, D),
            rnd(num_pages, KVH, PAGE, D), rnd(num_pages, KVH, PAGE, D))


def prefill_library_ms(q, k_new, v_new, k_pages, v_pages, rows, packs=PREFILL_PACKS):
    """SDPA over a dense layout holding each slot's gathered arena prefix
    (bf16 pages, built beforehand) followed by the packed fresh rows,
    masked as the kernel masks: ``library_ms``'s ``(median, min, max)``."""
    import torch
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops.attention import gather_kv_pages

    dev = q.device
    table, row_slot, row_pos = rows["page_table"], rows["row_slot"], rows["row_pos"]
    ctx_k, ctx_v, ctx_slot, ctx_pos = [], [], [], []
    kf, vf = gather_kv_pages(k_pages, table), gather_kv_pages(v_pages, table)
    for slot, hist, _ in packs:
        if hist:
            ctx_k.append(kf[slot, :, :hist])
            ctx_v.append(vf[slot, :, :hist])
            ctx_slot.append(torch.full((hist,), slot, device=dev))
            ctx_pos.append(torch.arange(hist, device=dev))
    k_dense = torch.cat(ctx_k + [k_new[0]], dim=1)[None]
    v_dense = torch.cat(ctx_v + [v_new[0]], dim=1)[None]
    col_slot = torch.cat(ctx_slot + [row_slot.long()])
    col_pos = torch.cat(ctx_pos + [row_pos.long()])
    mask = ((col_slot[None, :] == row_slot[:, None]) & (col_pos[None, :] >= 0)
            & (col_pos[None, :] <= row_pos[:, None]))
    mask[:, 0] |= ~mask.any(dim=1)  # pad rows: keep SDPA finite
    return library_ms(lambda: F.scaled_dot_product_attention(
        q, k_dense, v_dense, attn_mask=mask[None, None], scale=1.0 / math.sqrt(D),
        enable_gqa=True))


def prefill_work(rows, row_bytes: int, out_bytes_per_row: int = 0, packs=PREFILL_PACKS):
    """(bytes, flops) of one packed prefill call over ``packs`` with the
    row maps ``rows``: q, the fresh bf16 K/V and out once, the arena
    prefix's pages once (``row_bytes`` per token and kv head, K and V),
    ``out_bytes_per_row`` more per packed row and kv head for K and V (the
    quantized payload and scale), the row maps and tables; QK + PV over
    every attended (query, key) pair."""
    cap = rows["row_slot"].numel()
    hist_pages = sum(-(-hist // PAGE) for _, hist, _ in packs)
    nbytes = (2 * H * cap * D * 2 + 2 * KVH * cap * D * 2
              + hist_pages * KVH * PAGE * row_bytes * 2
              + 2 * cap * KVH * out_bytes_per_row
              + (rows["page_table"].numel() + 2 * cap + rows["slot_hist"].numel()) * 4)
    attended = sum((hist + tail) * (hist + tail + 1) // 2 - hist * (hist + 1) // 2
                   for _, hist, tail in packs)
    return nbytes, 4 * D * H * attended


def prefill_check(name: str, got, want, rows, quant: bool) -> float:
    """Hold one ragged prefill call against its plain version: out within
    the tolerance, pad rows exactly 0, and (quantized) payloads and scales
    of every packed row bit for bit. Returns out's max abs error."""
    err = check_close(name, got[0], want[0])
    pads = rows["row_pos"] < 0
    if bool(pads.any()) and got[0][0][:, pads].abs().max().item() != 0.0:
        fail(f"{name}: pad rows are not exactly 0")
    if quant:
        differ = {what: int((g != w).sum().item()) for what, g, w in zip(
            ("k payload", "k scale", "v payload", "v scale"), got[1:], want[1:])}
        if any(differ.values()):
            fail(f"{name}: values that differ from the plain version's (must be "
                 f"bit-exact): {differ}")
    return err


def prefill_entry(name: str, dev, inputs, rows, packs, bits: int = 0, timed: bool = True):
    """One entry of the ragged prefill kernel (``bits`` 0: 16-bit pages; 8
    / 4: quantized, the arena pages quantized by the port's quantize_kv),
    in the inputs' dtype (bf16, or fp16: the ``_f16`` entries), on one
    pack: checked by ``prefill_check`` and, when ``timed``, timed beside
    its plain version, SDPA (on K/V dequantized beforehand when quantized)
    and its bound. Returns the phase's numbers."""
    from accelerate_tpu_torch.ops.attention import ragged_prefill_attention, ragged_prefill_reference
    from accelerate_tpu_torch.utils.quantization import dequantize_kv, quantize_kv

    q, k_new, v_new, k_pages, v_pages = inputs
    kernel = ("ragged_prefill_quant" if bits else "ragged_prefill") + dtype_suffix(q.dtype)
    kw, k_lib, v_lib = {}, k_pages, v_pages
    if bits:
        (k_pages, ks), (v_pages, vs) = quantize_kv(k_pages, bits), quantize_kv(v_pages, bits)
        kw = dict(k_scale=ks, v_scale=vs, kv_quant_bits=bits)
        k_lib = dequantize_kv(k_pages, ks, bits, q.dtype)
        v_lib = dequantize_kv(v_pages, vs, bits, q.dtype)

    def run_kernel():
        return ragged_prefill_attention(q, k_new, v_new, k_pages, v_pages, **rows, **kw)

    def run_plain():
        return ragged_prefill_reference(q, k_new, v_new, k_pages, v_pages, *rows.values(),
                                        1.0 / math.sqrt(D), **kw)

    err = prefill_check(name, counted(kernel, run_kernel), run_plain(), rows, bool(bits))
    if not timed:
        return {"max_abs_err": err}
    pd = D // 2 if bits == 4 else D
    work = prefill_work(rows, pd + 4, pd + 4, packs) if bits else prefill_work(rows, D * 2,
                                                                               packs=packs)
    bound_ms, bound_by = bound(*work)
    return {"max_abs_err": err, "ms": cuda_time_ms(run_kernel),
            "plain_ms": cuda_time_ms(run_plain, iters=5, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library": prefill_library_ms(q, k_new, v_new, k_lib, v_lib, rows, packs)}


def entry(bits: int, dtype=None) -> str:
    """A kernel case's label: its KV's bits, or its 16-bit type."""
    import torch

    return f"int{bits}" if bits else ("fp16" if dtype == torch.float16 else "bf16")


def prefill_phases(gen, gen_quant, dev, dtype=None):
    """The ragged prefill kernel's three entries (16-bit with inputs from
    ``gen``, int8 and int4 on one input from ``gen_quant``) at
    PREFILL_PACKS and a pad block, then at PREFILL_CASES, in ``dtype``
    (None: bf16; fp16: the ``_f16`` entries); (a) checked, the others
    timed too. Returns the 16-bit and the quantized kernel rows (int8 at
    PREFILL_PACKS timed; errors over every case and entry)."""
    import torch

    sfx = dtype_suffix(dtype)
    rows, num_pages = prefill_case(dev)
    main = {0: prefill_inputs(gen, dev, PREFILL_CAP, num_pages, dtype)}
    main[8] = main[4] = prefill_inputs(gen_quant, dev, PREFILL_CAP, num_pages, dtype)
    res = {(bits, "main"): prefill_entry(f"ragged_prefill{sfx} ({entry(bits, dtype)})", dev,
                                         main[bits], rows, PREFILL_PACKS, bits)
           for bits in (0, 8, 4)}
    for tag, (cap, packs, pad_block, seed) in PREFILL_CASES.items():
        case_rows, case_pages = prefill_case(dev, packs, cap, pad_block)
        inputs = prefill_inputs(torch.Generator(device=dev).manual_seed(seed), dev, cap,
                                case_pages, dtype)
        for bits in (0, 8, 4):
            res[bits, tag] = prefill_entry(f"ragged_prefill{sfx} ({entry(bits, dtype)}, {tag})",
                                           dev, inputs, case_rows, packs, bits,
                                           timed=tag.startswith("b"))
    for (bits, tag), r in res.items():
        what = f"cap {PREFILL_CAP}, packs (slot, hist, tail) {PREFILL_PACKS} + pad block" \
            if tag == "main" else tag
        line = (f"kernel {'ragged_prefill_quant' if bits else 'ragged_prefill'}{sfx} "
                f"({entry(bits, dtype)}, {what}): out max_abs_err "
                f"{r['max_abs_err']:.3e} (tol {KERNEL_ATOL} + {KERNEL_RTOL}*|plain|)"
                + (", payloads and scales bit-exact" if bits else ""))
        if "ms" in r:
            line += (f", kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                     f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), library sdpa "
                     f"{library_text(r['library'])}"
                     + (" (on K/V gathered and dequantized beforehand: leaves out the gather, "
                        "the dequant and the quantize-on-write)" if bits else ""))
        print(line)
    out = []
    for name, bits, line in (("ragged_prefill", 0, 1469), ("ragged_prefill_quant", 8, 1458)):
        r = res[bits, "main"]
        errs = [v["max_abs_err"] for (b, _), v in res.items() if bool(b) == bool(bits)]
        out.append({"name": name + sfx, "route": "cuda",
                    "source": f"accelerate_tpu_torch/csrc/{name}.cu",
                    "replaces": f"accelerate_tpu/ops/attention.py:{line}",
                    "max_abs_err": max(errs), "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": r["library"][0]})
    return out


# flash kernels (training path): the main path's attention shape
TRAIN_B, TRAIN_S = 8, 2048
# kernel vs plain for the flash kernels: |kernel - plain| <= FLASH_ATOL *
# rms(plain) + KERNEL_RTOL * |plain|. Both versions round at the same
# sites (p to bf16 before PV, dS to bf16 before dS K / dS^T q) and write
# bf16; they differ by fp32 summation order (~1e-6 relative), where
# the forward's p is rounded (running vs final max, 2^-9 relative per
# term) and in the dV product's p (fp32 in the plain version, bf16 hi +
# lo, ~2^-17 relative, in the kernel), so an element may land one bf16
# ulp (2^-8 relative) apart. The
# gradients' scale depends on the inputs, hence an atol relative to the
# tensor's rms (2^-6 of it) rather than an absolute one
FLASH_ATOL = 2.0 ** -6
# lse is fp32 in both versions: m + log(l) with l summed in another order
LSE_ATOL = 1e-3


def check_close_rel(name: str, got, want) -> float:
    """Max abs error of ``got`` vs ``want`` under the flash tolerance."""
    want32 = want.float()
    diff = (got.float() - want32).abs()
    rms = want32.square().mean().sqrt().item()
    limit = FLASH_ATOL * rms + KERNEL_RTOL * want32.abs()
    err = diff.max().item()
    if not math.isfinite(err) or bool((diff > limit).any()):
        fail(f"{name} vs plain: max abs err {err} exceeds {FLASH_ATOL} * rms "
             f"({rms:.4g}) + {KERNEL_RTOL} * |plain|")
    return err


def flash_inputs(gen, dev, b, s, causal=True, kv_mask=None, seg=None, d=D, skv=None,
                 dtype=None):
    import torch

    dtype = dtype or torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    skv = skv or s
    q, k, v = rnd(b, H, s, d), rnd(b, KVH, skv, d), rnd(b, KVH, skv, d)
    do = rnd(b, H, s, d)
    to_int = (lambda t: None if t is None else t.to(dev, torch.int32).contiguous())
    masks = (to_int(kv_mask), to_int(seg), to_int(seg))
    return dict(q=q, k=k, v=v, do=do, masks=masks, causal=causal,
                scale=1.0 / math.sqrt(d))


def flash_masked_cases(gen, dev, dtype=None, seed_e: int = 2):
    """B 2, S 512, in ``dtype`` (bf16 by default): (a) causal, a kv_mask whose batch row 0 is fully masked
    and whose row 1 is left-padded by 100 positions; (b) causal, three
    segments per row, of other lengths in each row; (c) the kv_mask of (a)
    without causal masking. Then the kernels' other shapes: (d) head_dim
    64, causal, Sq 256 over Skv 512 (top-left aligned); (e) head_dim 128,
    causal, Sq 192 over Skv 320: 64-multiples that are not 128-multiples,
    so they cut the kernels' 128-row tiles. (e) draws from its own
    generator (seed ``seed_e``), so the other cases' inputs do not move."""
    import torch

    s = 512
    kv_mask = torch.ones((2, s), dtype=torch.int32)
    kv_mask[0] = 0
    kv_mask[1, :100] = 0
    seg = torch.zeros((2, s), dtype=torch.int32)
    seg[0, 200:] = 1
    seg[0, 300:] = 2
    seg[1, 64:] = 1
    seg[1, 450:] = 2
    kw = {"dtype": dtype}
    return {"S 512, causal, kv_mask": flash_inputs(gen, dev, 2, s, kv_mask=kv_mask, **kw),
            "S 512, causal, segments": flash_inputs(gen, dev, 2, s, seg=seg, **kw),
            "S 512, full, kv_mask": flash_inputs(gen, dev, 2, s, causal=False, kv_mask=kv_mask,
                                                 **kw),
            "causal, D 64, Sq 256 < Skv 512": flash_inputs(gen, dev, 2, 256, d=64, skv=512,
                                                           **kw),
            "causal, D 128, Sq 192 < Skv 320": flash_inputs(
                torch.Generator(device=dev).manual_seed(seed_e), dev, 2, 192, skv=320, **kw)}


def flash_attended_pairs(x) -> int:
    """(query, key) pairs this input attends, counted from its masks."""
    import torch

    from accelerate_tpu_torch.ops.attention import _flash_valid

    q, k = x["q"], x["k"]
    valid = _flash_valid(q, k, x["masks"], x["causal"])
    b, h, s = q.shape[0], q.shape[1], q.shape[2]
    if valid is None:
        return b * h * s * k.shape[2]
    per_b = torch.broadcast_to(valid, (b, 1, 1, s, k.shape[2])).sum().item()
    return int(per_b) * h


def flash_phases(gen, dev, dtype=None):
    """The flash forward, dQ and dK/dV kernels against their plain
    versions at the main path's shape (B 8, S 2048, H 16, KVH 8, D 128,
    causal) and in the masked cases, each timed beside its bound and SDPA
    in the same dtype: bf16 (the default), or fp16 (the ``_f16`` entries,
    their masked case (e) from seed 4). Returns the three kernel rows."""
    import torch
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.ops.attention import (
        NEG_INF, flash_bwd_dkv_reference, flash_bwd_dq_reference, flash_delta,
        flash_fwd_reference,
    )

    dtype = dtype or torch.bfloat16
    sfx = kernels.KERNEL_DTYPES[dtype]
    tname = "bf16" if dtype == torch.bfloat16 else "fp16"

    def fwd_kernel(x):
        return kernels.flash_fwd(x["q"], x["k"], x["v"], x["masks"], x["causal"], x["scale"])

    def fwd_plain(x):
        return flash_fwd_reference(x["q"], x["k"], x["v"], x["masks"], x["causal"], x["scale"])

    def bwd_args(x):
        return (x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"], x["masks"],
                x["causal"], x["scale"])

    def check_case(x, tag):
        """Hold all three kernels against the plain versions on one
        input; the backward's lse and delta come from the plain forward
        and are fed to both versions. Returns {kernel: max abs err}."""
        tag = f"{tname}, {tag}"
        out_k, lse_k = counted("flash_fwd" + sfx, lambda: fwd_kernel(x))
        out_p, lse_p = fwd_plain(x)
        errs = {"flash_fwd": check_close_rel(f"flash_fwd ({tag})", out_k, out_p)}
        lse_err = (lse_k - lse_p).abs().max().item()
        if not lse_err <= LSE_ATOL:
            fail(f"flash_fwd ({tag}) lse vs plain: max abs err {lse_err} > {LSE_ATOL}")
        x["lse"], x["delta"] = lse_p, flash_delta(out_p, x["do"])
        dq_k = counted("flash_bwd_dq" + sfx, lambda: kernels.flash_bwd_dq(*bwd_args(x)))
        dk_k, dv_k = counted("flash_bwd_dkv" + sfx,
                             lambda: kernels.flash_bwd_dkv(*bwd_args(x)))
        dq_p = flash_bwd_dq_reference(*bwd_args(x))
        dk_p, dv_p = flash_bwd_dkv_reference(*bwd_args(x))
        errs["flash_bwd_dq"] = check_close_rel(f"flash_bwd_dq ({tag})", dq_k, dq_p)
        errs["flash_bwd_dkv"] = max(check_close_rel(f"flash_bwd_dkv dk ({tag})", dk_k, dk_p),
                                    check_close_rel(f"flash_bwd_dkv dv ({tag})", dv_k, dv_p))
        empty = lse_p <= NEG_INF / 2  # rows with no attended key
        if bool(empty.any()):
            if out_k.float().abs()[empty].max().item() != 0.0 or bool(
                    (lse_k[empty] != NEG_INF).any()):
                fail(f"flash_fwd ({tag}): a fully masked row is not exactly 0 / NEG_INF")
            if dq_k.float().abs()[empty].max().item() != 0.0:
                fail(f"flash_bwd_dq ({tag}): a fully masked row has a nonzero dq")
        print(f"flash kernels vs plain ({tag}): max abs err fwd "
              f"{errs['flash_fwd']:.3e} (lse {lse_err:.2e}), dq "
              f"{errs['flash_bwd_dq']:.3e}, dk/dv {errs['flash_bwd_dkv']:.3e}; "
              f"{int(empty.sum().item())} fully masked rows")
        return errs

    x = flash_inputs(gen, dev, TRAIN_B, TRAIN_S, dtype=dtype)
    errs = check_case(x, f"B {TRAIN_B}, S {TRAIN_S}, causal")
    cases = flash_masked_cases(gen, dev, dtype, seed_e=2 if dtype == torch.bfloat16 else 4)
    for tag, case in cases.items():
        check_case(case, f"B 2, {tag}")

    ms = {"flash_fwd": cuda_time_ms(lambda: fwd_kernel(x), iters=10, warmup=2),
          "flash_bwd_dq": cuda_time_ms(lambda: kernels.flash_bwd_dq(*bwd_args(x)),
                                       iters=10, warmup=2),
          "flash_bwd_dkv": cuda_time_ms(lambda: kernels.flash_bwd_dkv(*bwd_args(x)),
                                        iters=10, warmup=2)}
    plain = {name: cuda_time_ms(fn, iters=3, warmup=1) for name, fn in (
        ("flash_fwd", lambda: fwd_plain(x)),
        ("flash_bwd_dq", lambda: flash_bwd_dq_reference(*bwd_args(x))),
        ("flash_bwd_dkv", lambda: flash_bwd_dkv_reference(*bwd_args(x))))}

    # yardstick: SDPA, forward alone and its backward alone (the backward
    # computes dq, dk and dv in one call: the library time of both rows)
    q, k, v = (x[n].detach().requires_grad_() for n in ("q", "k", "v"))
    sdpa = dict(is_causal=True, scale=x["scale"], enable_gqa=True)
    sdpa_fwd = library_ms(lambda: F.scaled_dot_product_attention(
        x["q"], x["k"], x["v"], **sdpa), iters=10, warmup=2)
    out_lib = F.scaled_dot_product_attention(q, k, v, **sdpa)
    sdpa_bwd = library_ms(lambda: torch.autograd.grad(
        out_lib, (q, k, v), x["do"], retain_graph=True), iters=10, warmup=2)
    library = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd, "flash_bwd_dkv": sdpa_bwd}

    pairs = flash_attended_pairs(x)
    elt = x["q"].numel() * 2  # one bf16 [B, H, S, D] tensor, bytes
    kv_elt = x["k"].numel() * 2
    row = TRAIN_B * H * TRAIN_S * 4  # one fp32 [B, H, S] tensor
    work = {  # (bytes moved, flops): inputs read once, outputs written once
        "flash_fwd": (2 * elt + 2 * kv_elt + row, 4 * D * pairs),
        "flash_bwd_dq": (3 * elt + 2 * kv_elt + 2 * row, 6 * D * pairs),
        "flash_bwd_dkv": (2 * elt + 4 * kv_elt + 2 * row, 8 * D * pairs),
    }
    rows = []
    for name, src, line in (("flash_fwd", "flash_fwd.cu", 400),
                            ("flash_bwd_dq", "flash_bwd_dq.cu", 440),
                            ("flash_bwd_dkv", "flash_bwd_dkv.cu", 488)):
        bound_ms, bound_by = bound(*work[name])
        print(f"kernel {name + sfx}: B {TRAIN_B}, S {TRAIN_S}, H {H}, KVH {KVH}, D {D}, "
              f"causal {tname}, {pairs} attended pairs, max_abs_err {errs[name]:.3e} "
              f"(tol {FLASH_ATOL}*rms + {KERNEL_RTOL}*|plain|), kernel "
              f"{ms[name]:.4f} ms, plain {plain[name]:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), library sdpa {library_text(library[name])}")
        rows.append({"name": name + sfx, "route": "cuda",
                     "source": f"accelerate_tpu_torch/csrc/{src}",
                     "replaces": f"accelerate_tpu/ops/attention.py:{line}",
                     "max_abs_err": errs[name], "ms": ms[name], "plain_ms": plain[name],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library[name][0]})
    return rows


# dense decode kernels (#5): the flat engine's arena (small_1b, 8 live
# slots + one parked, L 2048) and the generate path's cache (llama_7b:
# H = KVH = 32, prompt 512 + 64 new tokens right-sized to L 768)
FLAT_LENGTHS = [17, 130, 256, 511, 700, 1024, 1300, 1500]
GEN_HEADS, GEN_CACHE, GEN_POS = 32, 768, 575


def dense_case(gen, dev, tag, q, k, v, pos, bits=0):
    """Hold the dense decode kernel (``bits`` 0) or its quantized entry
    (``bits`` 8 / 4, payloads from the port's quantize_kv), in q's dtype
    (bf16, or fp16: the ``_f16`` entries), against the
    plain version on one input, and time kernel, plain version and SDPA
    over the same arena with the boolean mask (quantized: on K/V
    dequantized beforehand, so SDPA's time leaves the dequant out).
    Returns the phase's numbers."""
    import torch
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops.attention import decode_attention, decode_attention_reference
    from accelerate_tpu_torch.utils.quantization import dequantize_kv, quantize_kv

    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    name = ("dense_decode_quant" if bits else "dense_decode") + dtype_suffix(q.dtype)
    kw, k_lib, v_lib = {}, k, v
    if bits:
        (k, ks), (v, vs) = quantize_kv(k, bits), quantize_kv(v, bits)
        kw = dict(k_scale=ks, v_scale=vs, kv_quant_bits=bits)
        k_lib = dequantize_kv(k, ks, bits, q.dtype)
        v_lib = dequantize_kv(v, vs, bits, q.dtype)

    def run_kernel():
        return decode_attention(q, k, v, q_positions=pos, **kw)

    def run_plain():
        return decode_attention_reference(q, k, v, pos, scale, **kw)

    err = check_close(f"{name} ({tag})", counted(name, run_kernel), run_plain())
    ms = cuda_time_ms(run_kernel)
    plain_ms = cuda_time_ms(run_plain, iters=5, warmup=1)
    length = k.shape[2]
    mask = (torch.arange(length, device=dev)[None, None, None, :] <= pos[:, None, :, None])
    library = library_ms(lambda: F.scaled_dot_product_attention(
        q, k_lib, v_lib, attn_mask=mask, scale=scale, enable_gqa=True))

    # bytes: q and out once, each batch row's live K/V rows (positions
    # 0 .. max of its query positions: payload and scale when quantized)
    # once, the positions; flops: QK and PV over each query row's
    # attended positions
    b, h, sq, _ = q.shape
    kvh = k.shape[1]
    row_bytes = {0: d * 2, 8: d + 4, 4: d // 2 + 4}[bits]
    live = sum(min(int(p.max()) + 1, length) for p in pos)
    nbytes = 2 * q.numel() * 2 + live * kvh * row_bytes * 2 + pos.numel() * 4
    attended = sum(int(p) + 1 for p in pos.flatten().tolist())
    bound_ms, bound_by = bound(nbytes, 4 * d * h * attended)
    print(f"kernel {name} ({tag}): B {b}, H {h}, KVH {kvh}, Sq {sq}, L {length}, D {d}, "
          f"max_abs_err {err:.3e} (tol {KERNEL_ATOL} + {KERNEL_RTOL}*|plain|), kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us "
          f"({bound_by}), library sdpa {library_text(library)}"
          + (" (on K/V dequantized beforehand)" if bits else "")
          + f"; kernel / sdpa {ms / library[0]:.3f}x")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library[0]}


# edge cases of the dense decode kernel's split kv walk, each checked (not
# timed) in bf16, int8 and int4 against the plain version, drawn from a
# generator of their own so no other phase's inputs move: (tag, query
# heads, Sq, cache length L, the last query position of each batch row as
# a function of the split length E in tokens); each row queries its last
# Sq positions (from 0), and a position at or past L attends all L
DENSE_EDGE_SEED = 7
DENSE_EDGES = [
    ("a: Sq 1, pos 0, 63/64/65, split edges +-1, parked at L - 1", H, 1, MAX_CACHE,
     lambda e: [0, 63, 64, 65, e - 1, e, e + 1, MAX_CACHE - 1]),
    ("b: Sq 4 across tile and split edges", H, 4, MAX_CACHE,
     lambda e: [3, 65, e - 1, e + 2, 2 * e + 1, MAX_CACHE - 1]),
    ("c: Sq 16, group 2 (R 32)", H, 16, MAX_CACHE, lambda e: [15, e + 7, e + 15, 1015]),
    ("d: Sq 16, group 1 (H = KVH = 8)", KVH, 16, MAX_CACHE,
     lambda e: [15, e + 7, 1015, MAX_CACHE - 1]),
    ("e: L 1000 (not a tile multiple), a row past L", H, 1, 1000,
     lambda e: [0, 64, e - 1, e + 1, 999, 1200]),
    ("f: L 1001 (not a multiple of 4), parked at 1000", H, 1, 1001,
     lambda e: [0, 65, e + 1, 1000]),
    ("g: Sq 4 rows at or past L (L 1001)", H, 4, 1001, lambda e: [1002, 1500, 64, 999]),
]


def dense_edge_inputs(dev, dtype=None):
    """The DENSE_EDGES cases: ``[(tag, E, q, k, v, pos)]`` with K/V
    [B, KVH, L, D] in ``dtype`` (None: bf16), from one generator seeded
    DENSE_EDGE_SEED."""
    import torch

    from accelerate_tpu_torch.ops import kernels

    gen = torch.Generator(device=dev).manual_seed(DENSE_EDGE_SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = []
    for tag, heads, sq, length, lasts_of in DENSE_EDGES:
        b = len(lasts_of(0))
        per_split, _ = kernels.decode_split_plan(b, KVH, length, sms)
        e = per_split * kernels.DECODE_TILE
        lasts = torch.tensor(lasts_of(e), dtype=torch.int32)
        pos = (lasts[:, None] - sq + 1 + torch.arange(sq, dtype=torch.int32)).clamp(min=0)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype or torch.bfloat16)

        cases.append((tag, e, rnd(b, heads, sq, D), rnd(b, KVH, length, D),
                      rnd(b, KVH, length, D), pos.to(dev)))
    return cases


def dense_edge_checks(dev, dtype=None) -> dict:
    """Hold the dense decode kernel (16-bit K/V) and its quantized entry
    (int8, int4 on K/V quantized by the port's quantize_kv), in ``dtype``
    (None: bf16; fp16: the ``_f16`` entries), against the plain version on
    every DENSE_EDGES case. Returns the max abs error of each ``bits`` (0,
    8, 4)."""
    from accelerate_tpu_torch.ops.attention import decode_attention, decode_attention_reference
    from accelerate_tpu_torch.utils.quantization import quantize_kv

    sfx = dtype_suffix(dtype)
    worst = {0: 0.0, 8: 0.0, 4: 0.0}
    for tag, e, q, k, v, pos in dense_edge_inputs(dev, dtype):
        errs = {}
        for bits in worst:
            kw, kq, vq = {}, k, v
            if bits:
                (kq, ks), (vq, vs) = quantize_kv(k, bits), quantize_kv(v, bits)
                kw = dict(k_scale=ks, v_scale=vs, kv_quant_bits=bits)
            name = ("dense_decode_quant" if bits else "dense_decode") + sfx
            got = counted(name, lambda: decode_attention(q, kq, vq, q_positions=pos, **kw))
            want = decode_attention_reference(q, kq, vq, pos, 1.0 / math.sqrt(D), **kw)
            errs[bits] = check_close(f"{name} ({entry(bits, dtype)}, edge case {tag})", got,
                                     want)
            worst[bits] = max(worst[bits], errs[bits])
        print(f"kernel dense_decode{sfx} edge case {tag} (split {e} tokens, H {q.shape[1]}, "
              f"Sq {q.shape[2]}, L {k.shape[2]}, rows' last positions {pos[:, -1].tolist()}): "
              + ", ".join(f"{entry(bits, dtype)} max_abs_err {err:.3e}"
                          for bits, err in errs.items())
              + f" (tol {KERNEL_ATOL} + {KERNEL_RTOL}*|plain|)")
    return worst


def dense_decode_phases(gen, dev, dtype=None):
    """The dense decode kernel and its int8 / int4 entry at the paths'
    shapes: (a) the flat engine's decode step on small_1b (B 9 = 8 live
    slots of lengths 17..1500 + one parked at 2047, H 16, KVH 8, L 2048);
    (b) generate()'s decode step on llama_7b (B 1 and B 4, H = KVH = 32,
    L 768, position 575); (c) Sq 4 with per-row positions on (a)'s arena;
    (d) int8 and int4 at (a); then the DENSE_EDGES cases (their own
    inputs). In ``dtype`` (None: bf16; fp16: the ``_f16`` entries).
    Returns the two kernel rows."""
    import torch

    from accelerate_tpu_torch.ops.attention import decode_attention

    sfx = dtype_suffix(dtype)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype or torch.bfloat16)

    b = len(FLAT_LENGTHS) + 1
    pos_a = torch.tensor([n - 1 for n in FLAT_LENGTHS] + [MAX_CACHE - 1],
                         dtype=torch.int32, device=dev)[:, None]
    q_a, k_a, v_a = rnd(b, H, 1, D), rnd(b, KVH, MAX_CACHE, D), rnd(b, KVH, MAX_CACHE, D)
    flat = dense_case(gen, dev, "a: small_1b flat arena, 8 live + parked", q_a, k_a, v_a, pos_a)
    live_ms = cuda_time_ms(lambda: decode_attention(
        q_a[:-1], k_a[:-1], v_a[:-1], q_positions=pos_a[:-1]))
    print(f"kernel dense_decode{sfx} (a) without the parked slot: {live_ms:.4f} ms")
    errs = [flat["max_abs_err"]]
    for gb in (1, 4):
        pos_b = torch.full((gb, 1), GEN_POS, dtype=torch.int32, device=dev)
        errs.append(dense_case(
            gen, dev, f"b: llama_7b generate, B {gb}", rnd(gb, GEN_HEADS, 1, D),
            rnd(gb, GEN_HEADS, GEN_CACHE, D), rnd(gb, GEN_HEADS, GEN_CACHE, D),
            pos_b)["max_abs_err"])
    pos_c = (pos_a - 3 + torch.arange(4, dtype=torch.int32, device=dev)[None]).clamp(min=0)
    errs.append(dense_case(gen, dev, "c: Sq 4, per-row positions", rnd(b, H, 4, D), k_a, v_a,
                           pos_c)["max_abs_err"])
    quant = {bits: dense_case(gen, dev, f"d: int{bits}, arena of (a)", q_a, k_a, v_a, pos_a,
                              bits=bits) for bits in (8, 4)}
    edges = dense_edge_checks(dev, dtype)
    rows = [dict(name="dense_decode" + sfx, route="cuda",
                 source="accelerate_tpu_torch/csrc/dense_decode.cu",
                 replaces="accelerate_tpu/ops/attention.py:977", **flat)]
    rows[0]["max_abs_err"] = max(*errs, edges[0])
    rows.append(dict(name="dense_decode_quant" + sfx, route="cuda",
                     source="accelerate_tpu_torch/csrc/dense_decode_quant.cu",
                     replaces="accelerate_tpu/ops/attention.py:898", **quant[8]))
    rows[1]["max_abs_err"] = max(quant[8]["max_abs_err"], quant[4]["max_abs_err"], edges[8],
                                 edges[4])
    return rows


# the fp16 serving entries' kernel phases draw from generators of their
# own (so no bf16 phase's inputs move): the paged decode's Sq 1 and Sq 5,
# its quantized entry, the ragged prefill's 16-bit and quantized inputs,
# the dense decode's
F16_KERNEL_SEEDS = (21, 22, 23, 24, 25, 26)


def serving_kernel_phases_f16(dev):
    """The fp16 entries of the paged decode (#4), ragged prefill (#6) and
    dense decode (#5) kernels at the bf16 phases' own shapes, cases and
    tolerance, each against its plain version and timed beside its bound
    (the bf16 row's: both types move 2 bytes a value), its plain version
    and SDPA in fp16: #4 at Sq 1 and 5 and its six edge cases, int8 and
    int4; #6 at PREFILL_PACKS and both PREFILL_CASES, int8 and int4 with
    payloads and scales bit for bit; #5 at the flat arena, generate()'s
    shapes, Sq 4, its edge cases, int8 and int4, and its D 64
    instantiation at t5-base's decode (its error joins the
    ``dense_decode_f16`` row, whose launches come from the flat fp16
    run). Returns the six fp16 rows."""
    import torch

    f16 = torch.float16
    g = [torch.Generator(device=dev).manual_seed(seed) for seed in F16_KERNEL_SEEDS]
    rows = [decode_phase(g[0], dev, g[1], f16), paged_decode_quant_phase(g[2], dev, f16),
            *prefill_phases(g[3], g[4], dev, f16)]
    dense = dense_decode_phases(g[5], dev, f16)
    d64 = t5_decode_phase(dev, f16)
    dense[0]["max_abs_err"] = max(dense[0]["max_abs_err"], d64["max_abs_err"])
    print(f"kernel dense_decode_f16 (D 64): t5-base decode B 4, position 63: kernel "
          f"{d64['ms']:.4f} ms, plain {d64['plain_ms']:.4f} ms, bound {d64['bound_ms'] * 1e3:.3f} "
          f"us ({d64['bound_by']}), library sdpa fp16 {d64['library_ms']:.4f} ms, max_abs_err "
          f"{d64['max_abs_err']:.3e} over its cases (joins the dense_decode_f16 row)")
    return rows + dense


# CUPTI reports launch-queue stalls as events of this name; they are no
# work of the card and are left out of its busy time
PROFILER_MARKERS = ("Command Buffer Full",)


def device_time(prof):
    """``(busy ms, [(ms, calls, name)])`` from the profiler's device-side
    events alone: the kernels, copies and sets the card ran, busy time
    being the union of their intervals. (Summing every row's self device
    time instead counts each kernel twice: once as itself, once under the
    CPU op that launched it.) Annotation ranges drawn on the device
    timeline, such as the optimizer's step, span gaps between kernels and
    are left out too."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA or e.name in PROFILER_MARKERS
                or getattr(e, "is_user_annotation", False)):
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (end - start) / 1e3, calls + 1)
    busy_us, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy_us += end - start
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
    rows = sorted(((ms, n, name) for name, (ms, n) in by_name.items()), reverse=True)
    return busy_us / 1e3, rows


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def teacher_forced(model, reqs, new_tokens: int, dev):
    """Each request's generated tokens against the cache-free plain
    forward of its prompt + continuation (at these lengths, none a
    128-multiple: mha_reference, causal): ``(worst gap, exact, total)``,
    the gap being how many logits a token sits below that forward's
    argmax."""
    import torch

    worst_gap, exact, total = 0.0, 0, 0
    with torch.no_grad():
        for r in reqs:
            seq = torch.as_tensor(r.result(), dtype=torch.long, device=dev)[None]
            n = r.prompt.size
            rows = model(seq)[0][n - 1: n - 1 + new_tokens]
            toks = torch.as_tensor(r.tokens, device=dev)
            gap = rows.max(dim=-1).values - rows.gather(1, toks[:, None])[:, 0]
            worst_gap = max(worst_gap, gap.max().item())
            exact += int((gap == 0).sum().item())
            total += new_tokens
    return worst_gap, exact, total


def zeroed(real):
    """A kernel wrapper that launches the real kernel (and counts it) but
    hands back zeros: the controls' broken attention."""
    import torch

    def wrapper(*args):
        return torch.zeros_like(real(*args))

    return wrapper


def main_path(dev, card: str):
    """Serve small_1b at full width through the paged ServingEngine.
    Returns its launches and what the flat path runs beside it."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.models.configs import DecoderConfig
    from accelerate_tpu_torch.models.convert import random_params
    from accelerate_tpu_torch.models.decoder import DecoderLM
    from accelerate_tpu_torch.serving.engine import ServingEngine

    cfg = DecoderConfig.small_1b()
    t0 = time.perf_counter()
    model = DecoderLM(cfg, device=dev)
    model.load_params(random_params(cfg, seed=0, device=dev))
    torch.cuda.synchronize()
    print(f"main path: small_1b ({cfg.num_layers} layers, E {cfg.embed_dim}, "
          f"H {cfg.num_heads}, KVH {cfg.num_kv_heads}, D {cfg.head_dim}, "
          f"vocab {cfg.vocab_size}, bf16), random weights seed 0, "
          f"built in {time.perf_counter() - t0:.1f} s")
    eng_kw = dict(num_slots=8, page_size=PAGE, max_cache_len=MAX_CACHE,
                  prefill_chunks=(128, 512), device=dev)

    rng = np.random.RandomState(0)
    vocab = cfg.vocab_size

    def prompt(n):
        return rng.randint(3, vocab, (n,)).astype(np.int32)

    # warm-up wave (cuBLAS handles, allocator) on its own engine: not
    # part of the measured run, and run before the counts are reset
    warm = ServingEngine(model, **eng_kw)
    warm.generate_batched([prompt(40), prompt(300)], max_new_tokens=4)
    del warm

    shared = prompt(256)
    first_shared = np.concatenate([shared, prompt(144)])
    second_shared = np.concatenate([shared, prompt(144)])
    long_prompt = prompt(1000)
    prompts = [first_shared, prompt(40), prompt(40), prompt(400), prompt(40),
               prompt(400), long_prompt, prompt(40), second_shared]
    new_tokens = 32
    engine, reqs, wall, launches = serve_counted(model, prompts, new_tokens, **eng_kw)
    m = engine.metrics()
    steps, dispatches = engine.step_count, engine.prefill_dispatches
    if launches["paged_decode"] != steps * cfg.num_layers:
        fail(f"paged_decode launches {launches['paged_decode']} != "
             f"{steps} decode steps x {cfg.num_layers} layers")
    if launches["ragged_prefill"] != dispatches * cfg.num_layers:
        fail(f"ragged_prefill launches {launches['ragged_prefill']} != "
             f"{dispatches} prefill dispatches x {cfg.num_layers} layers")
    if reqs[-1].prefix_hit != shared.size:
        fail(f"shared-prefix request hit {reqs[-1].prefix_hit} cached tokens, "
             f"expected {shared.size}")
    if reqs[6].prefill_dispatches < 2:
        fail("the 1000-token prompt did not continue mid-tail over an arena prefix")

    worst_gap, exact, total = teacher_forced(model, reqs, new_tokens, dev)
    if not math.isfinite(worst_gap) or worst_gap > TOP2_MARGIN:
        fail(f"a generated token is {worst_gap} logits below the plain "
             f"forward's argmax (margin {TOP2_MARGIN})")

    tps = m["serving/generated_tokens"] / wall
    print(f"main path: {len(reqs)} requests x {new_tokens} tokens, prompts "
          f"{[int(p.size) for p in prompts]}, {steps} decode steps, "
          f"{dispatches} prefill dispatches, prefix hit {reqs[-1].prefix_hit} "
          f"tokens, launches {launches}")
    print(f"main path: teacher-forced check: {exact}/{total} tokens are the "
          f"plain argmax, worst gap {worst_gap:.4f} (margin {TOP2_MARGIN})")
    print(f"main path on {card}: {tps:.1f} tokens/s over {wall:.3f} s, TTFT p50 "
          f"{m['serving/ttft_ms_p50']:.2f} ms (with the CUDA-core ragged prefill kernel: "
          f"{' / '.join(f'{t:.2f}' for t in CUDA_CORE_PREFILL_TTFT_MS)} ms), decode "
          f"{m['serving/decode_step_ms_p50']:.3f} ms/step (p50)")
    profile_decode(model, eng_kw, prompt, card)
    profile_prefill(model, eng_kw, prompts, new_tokens, card)
    paged = {"tokens_per_s": tps, "ttft_ms_p50": m["serving/ttft_ms_p50"],
             "step_ms_p50": m["serving/decode_step_ms_p50"], "arena_bytes": engine.arena_bytes}
    main = {"tokens": [list(r.tokens) for r in reqs], "steps": steps,
            "dispatches": dispatches, "launches": dict(launches), "tokens_per_s": tps,
            "step_ms_p50": m["serving/decode_step_ms_p50"]}
    return launches, {"model": model, "prompts": prompts, "prompt": prompt, "paged": paged,
                      "main": main}


def flat_path(dev, card: str, model, prompts, prompt, paged: dict) -> int:
    """Serve the same requests on the same small_1b through the flat-arena
    ServingEngine (page_size=None): chunked prefill against slot views,
    the dense decode kernel in every decode step. Tokens are checked
    teacher-forced, and the same run with the kernel's output zeroed must
    fail that check. Returns dense_decode's launches on this path."""
    from unittest import mock

    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.serving.engine import ServingEngine

    cfg = model.config
    eng_kw = dict(num_slots=8, page_size=None, max_cache_len=MAX_CACHE,
                  prefill_chunks=(128, 512), device=dev)
    new_tokens = 32
    warm = ServingEngine(model, **eng_kw)
    warm.generate_batched([prompt(40), prompt(300)], max_new_tokens=4)
    del warm

    engine, reqs, wall, launches = serve_counted(model, prompts, new_tokens, **eng_kw)
    steps = engine.step_count
    if launches["dense_decode"] != steps * cfg.num_layers:
        fail(f"flat path: dense_decode launches {launches['dense_decode']} != "
             f"{steps} decode steps x {cfg.num_layers} layers")
    others = {k: n for k, n in launches.items() if n and k != "dense_decode"}
    if others:
        fail(f"flat path launched other kernels: {others}")
    worst_gap, exact, total = teacher_forced(model, reqs, new_tokens, dev)
    if not math.isfinite(worst_gap) or worst_gap > TOP2_MARGIN:
        fail(f"flat path: a generated token is {worst_gap} logits below the plain "
             f"forward's argmax (margin {TOP2_MARGIN})")
    m = engine.metrics()
    arena_bytes, chunks = engine.arena_bytes, engine.prefill_dispatches
    del engine
    with mock.patch.object(kernels, "dense_decode", zeroed(kernels.dense_decode)):
        control, creqs, _, _ = serve_counted(model, prompts, new_tokens, **eng_kw)
    del control
    gap_c, exact_c, _ = teacher_forced(model, creqs, new_tokens, dev)
    if not gap_c > TOP2_MARGIN:
        fail(f"flat path control: with the dense decode output zeroed every token is "
             f"within {TOP2_MARGIN} of the plain argmax (worst {gap_c}): the check is blind")
    tps = m["serving/generated_tokens"] / wall
    print(f"flat path: {len(reqs)} requests x {new_tokens} tokens, {steps} decode steps, "
          f"{chunks} prefill chunks, launches {launches}")
    print(f"flat path: teacher-forced check: {exact}/{total} tokens are the plain argmax, "
          f"worst gap {worst_gap:.4f} (margin {TOP2_MARGIN}); control (dense decode output "
          f"zeroed): {exact_c}/{total} exact, worst gap {gap_c:.4f}, fails the check")
    print(f"flat path on {card}: {tps:.1f} tokens/s over {wall:.3f} s, TTFT p50 "
          f"{m['serving/ttft_ms_p50']:.2f} ms, decode {m['serving/decode_step_ms_p50']:.3f} "
          f"ms/step (p50), arena {arena_bytes / 1e9:.3f} GB; paged path (same run): "
          f"{paged['tokens_per_s']:.1f} tokens/s, TTFT p50 {paged['ttft_ms_p50']:.2f} ms, "
          f"decode {paged['step_ms_p50']:.3f} ms/step, arena {paged['arena_bytes'] / 1e9:.3f} GB")
    profile_decode(model, eng_kw, prompt, card, label="flat profile")
    return launches["dense_decode"]


def serve_counted(model, prompts, new_tokens: int, **eng_kw):
    """Serve ``prompts`` (request i seeded i; greedy unless ``eng_kw``
    sets a temperature) on a fresh engine, warmed up first (its
    kernels built and its step's CUDA graph captured, as ``serve replica``
    does before it binds a port), with the launch counts reset just before
    and read just after. Returns ``(engine, requests, wall seconds,
    launches)``; fails unless every request finished with its budget."""
    import torch

    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.serving.engine import ServingEngine

    engine = ServingEngine(model, **eng_kw)
    engine.warmup()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new_tokens=new_tokens, seed=i) for i, p in enumerate(prompts)]
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    for r in reqs:
        if r.outcome != "finished" or len(r.tokens) != new_tokens:
            fail(f"request {r.id} ended {r.outcome} with {len(r.tokens)} tokens "
                 f"({eng_kw.get('kv_cache_dtype')}, spec {eng_kw.get('spec_draft_len', 0)})")
    return engine, reqs, wall, launches


def expect_launches(what: str, launches: dict, want: dict):
    """Fail unless the kernels launched are exactly ``want`` (name: count)."""
    got = {k: n for k, n in launches.items() if n}
    if got != {k: n for k, n in want.items() if n} or not all(want.values()):
        fail(f"{what}: launches {got}, expected {want}")


def quant_replay(model, reqs, kv: str, new_tokens: int, dev):
    """Each request's tokens against a teacher-forced replay through the
    quantized single-stream path (``init_cache(1, L, kv)``, whole-prompt
    prefill, then ``decode=True`` steps) with every kernel it reaches
    patched to its plain version: the same storage math as the paged
    engine on another route. ``(worst gap, exact, total)``, the gap being
    how many logits a token sits below the replay's argmax."""
    from unittest import mock

    import torch

    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.ops.attention import decode_attention_reference, flash_fwd_reference

    def dense_quant_plain(q, k, v, k_scale, v_scale, pos, sm_scale, bits):
        return decode_attention_reference(q, k, v, pos, sm_scale, k_scale=k_scale,
                                          v_scale=v_scale, kv_quant_bits=bits)

    worst_gap, exact, total = 0.0, 0, 0
    with mock.patch.object(kernels, "dense_decode_quant", dense_quant_plain), \
            mock.patch.object(kernels, "flash_fwd", flash_fwd_reference), torch.no_grad():
        for r in reqs:
            seq = torch.as_tensor(r.result(), dtype=torch.long, device=dev)[None]
            n = r.prompt.size
            cache = model.init_cache(1, n + new_tokens, kv)
            rows = [model(seq[:, :n], torch.arange(n, device=dev), cache=cache)[0, -1]]
            for p in range(n, n + new_tokens - 1):
                rows.append(model(seq[:, p:p + 1], torch.arange(p, p + 1, device=dev),
                                  cache=cache, decode=True)[0, -1])
            gap, n_exact = token_gaps(torch.stack(rows)[None],
                                      torch.as_tensor(r.tokens, device=dev)[None])
            worst_gap = max(worst_gap, gap)
            exact += n_exact
            total += new_tokens
    return worst_gap, exact, total


def quant_path(dev, card: str, model, prompts, prompt, paged: dict) -> dict:
    """Serve the main path's requests on the int8 and then the int4 paged
    arena: the quantized entries of the paged decode and ragged prefill
    kernels in every step and dispatch (16 launches each), no bf16 one;
    the prefix hit and the mid-tail continuation on quantized pages;
    tokens held against the quantized single-stream replay, and the same
    run with paged_decode_quant's output zeroed must fail that check.
    Returns the quantized kernels' launches on this path."""
    from unittest import mock

    from accelerate_tpu_torch.ops import kernels

    cfg = model.config
    new_tokens = 32
    eng_kw = dict(num_slots=8, page_size=PAGE, max_cache_len=MAX_CACHE,
                  prefill_chunks=(128, 512), device=dev)
    launches = {"paged_decode_quant": 0, "ragged_prefill_quant": 0}
    for kv, min_ratio in (("int8", 1.8), ("int4", 3.0)):
        serve_counted(model, [prompt(40), prompt(300)], 4, kv_cache_dtype=kv, **eng_kw)
        engine, reqs, wall, got = serve_counted(model, prompts, new_tokens, kv_cache_dtype=kv,
                                                **eng_kw)
        steps, dispatches = engine.step_count, engine.prefill_dispatches
        expect_launches(f"quant path ({kv})", got, {
            "paged_decode_quant": steps * cfg.num_layers,
            "ragged_prefill_quant": dispatches * cfg.num_layers})
        for name in launches:
            launches[name] += got[name]
        if reqs[-1].prefix_hit != 256:
            fail(f"quant path ({kv}): the shared-prefix request hit {reqs[-1].prefix_hit} "
                 "cached tokens, expected 256")
        if reqs[6].prefill_dispatches < 2:
            fail(f"quant path ({kv}): the 1000-token prompt did not continue mid-tail")
        ratio = paged["arena_bytes"] / engine.arena_bytes
        if not ratio >= min_ratio:
            fail(f"quant path ({kv}): arena {engine.arena_bytes} bytes is {ratio:.3f}x "
                 f"smaller than bf16's, below {min_ratio}x")
        m = engine.metrics()
        del engine
        gap, exact, total = quant_replay(model, reqs, kv, new_tokens, dev)
        if not math.isfinite(gap) or gap > TOP2_MARGIN:
            fail(f"quant path ({kv}): a token is {gap} logits below the argmax of the "
                 f"quantized single-stream replay (margin {TOP2_MARGIN})")
        print(f"quant path ({kv} KV): {len(reqs)} requests x {new_tokens} tokens, {steps} "
              f"decode steps, {dispatches} prefill dispatches, prefix hit "
              f"{reqs[-1].prefix_hit} tokens, launches { {k: n for k, n in got.items() if n} }")
        print(f"quant path ({kv} KV): vs the {kv} single-stream replay with plain kernels: "
              f"{exact}/{total} tokens its argmax, worst gap {gap:.4f} (margin {TOP2_MARGIN})")
        print(f"quant path ({kv} KV) on {card}: {m['serving/generated_tokens'] / wall:.1f} "
              f"tokens/s over {wall:.3f} s, TTFT p50 {m['serving/ttft_ms_p50']:.2f} ms, decode "
              f"{m['serving/decode_step_ms_p50']:.3f} ms/step (p50), arena "
              f"{m['serving/arena_bytes'] / 1e9:.4f} GB ({ratio:.3f}x smaller than bf16, "
              f"min {min_ratio}); bf16 paged path: {paged['tokens_per_s']:.1f} tokens/s, TTFT "
              f"p50 {paged['ttft_ms_p50']:.2f} ms, decode {paged['step_ms_p50']:.3f} ms/step, "
              f"arena {paged['arena_bytes'] / 1e9:.4f} GB")
        if kv == "int8":
            with mock.patch.object(kernels, "paged_decode_quant",
                                   zeroed(kernels.paged_decode_quant)):
                control, creqs, _, _ = serve_counted(model, prompts, new_tokens,
                                                     kv_cache_dtype=kv, **eng_kw)
            del control
            cgap, cexact, _ = quant_replay(model, creqs, kv, new_tokens, dev)
            if not cgap > TOP2_MARGIN:
                fail(f"quant path control: with paged_decode_quant's output zeroed every "
                     f"token is within {TOP2_MARGIN} of the replay's argmax (worst {cgap}): "
                     "the check is blind")
            print(f"quant path control (int8, paged_decode_quant output zeroed): "
                  f"{cexact}/{total} tokens the replay's argmax, worst gap {cgap:.4f}: fails "
                  "the check")
            profile_decode(model, {**eng_kw, "kv_cache_dtype": kv}, prompt, card,
                           label="int8 profile")
    return launches


def drift_phase(model, prompts, card: str):
    """The port's kv_quant_drift on small_1b: int8 and int4 against one
    bf16 baseline on the paged arena, over 4 of the main path's prompts.
    Random weights say nothing of quality: the gate is finite values."""
    from accelerate_tpu_torch.serving import kv_quant_drift

    t0 = time.perf_counter()
    base = None
    for kv in ("int8", "int4"):
        r = kv_quant_drift(model, prompts[:4], kv_cache_dtype=kv, max_new_tokens=16,
                           page_size=PAGE, num_slots=4, max_cache_len=512,
                           prefill_chunks=(128, 512), baseline=base)
        base = r["baseline"]
        keys = ("token_match_rate", "exact_streams", "logit_mse", "logit_rel_err",
                "arena_bytes_ratio")
        if not all(math.isfinite(float(r[k])) for k in keys):
            fail(f"drift ({kv}): non-finite result {[(k, r[k]) for k in keys]}")
        print(f"drift ({kv} vs bf16, small_1b, 4 prompts x 16 tokens, paged arena) on {card}: "
              f"token_match_rate {r['token_match_rate']:.4f} over {r['tokens_compared']} "
              f"tokens, exact_streams {r['exact_streams']}/{r['sequences']}, logit_mse "
              f"{r['logit_mse']:.4e}, logit_rel_err {r['logit_rel_err']:.4e}, "
              f"arena_bytes_ratio {r['arena_bytes_ratio']:.3f}")
    print(f"drift: {time.perf_counter() - t0:.1f} s")


def spec_path(dev, card: str, model, prompt):
    """Speculative verify (spec_draft_len 4) on the bf16 and the int8
    paged arena, greedy, over prompts that repeat a 16-token pattern so
    the n-gram drafter has something to propose. Each verify step is one
    paged decode launch per layer at Sq 5; tokens are held teacher-forced
    (bf16: the cache-free plain forward; int8: the quantized single-stream
    replay) and timed beside the same requests without spec."""
    import numpy as np

    cfg = model.config
    new_tokens = 32
    prompts = [np.concatenate([prompt(8 + 8 * i), np.tile(prompt(16), 4 + i)])
               for i in range(8)]
    eng_kw = dict(num_slots=8, page_size=PAGE, max_cache_len=MAX_CACHE,
                  prefill_chunks=(128, 512), device=dev)
    for kv in ("bf16", "int8"):
        decode, prefill = (("paged_decode", "ragged_prefill") if kv == "bf16"
                           else ("paged_decode_quant", "ragged_prefill_quant"))
        serve_counted(model, prompts[:2], 4, kv_cache_dtype=kv, spec_draft_len=SPEC_K,
                      **eng_kw)  # warm-up
        plain, _, plain_wall, _ = serve_counted(model, prompts, new_tokens, kv_cache_dtype=kv,
                                                **eng_kw)
        pm = plain.metrics()
        del plain
        engine, reqs, wall, got = serve_counted(model, prompts, new_tokens, kv_cache_dtype=kv,
                                                spec_draft_len=SPEC_K, **eng_kw)
        steps, dispatches = engine.step_count, engine.prefill_dispatches
        expect_launches(f"spec path ({kv})", got, {decode: steps * cfg.num_layers,
                                                   prefill: dispatches * cfg.num_layers})
        m = engine.metrics()
        del engine
        if not m["serving/spec_proposed"] > 0:
            fail(f"spec path ({kv}): the drafter proposed nothing")
        if kv == "bf16":
            gap, exact, total = teacher_forced(model, reqs, new_tokens, dev)
            against = "the cache-free plain forward"
        else:
            gap, exact, total = quant_replay(model, reqs, kv, new_tokens, dev)
            against = "the int8 single-stream replay with plain kernels"
        if not math.isfinite(gap) or gap > TOP2_MARGIN:
            fail(f"spec path ({kv}): a token is {gap} logits below the argmax of {against} "
                 f"(margin {TOP2_MARGIN})")
        print(f"spec path ({kv} KV, K {SPEC_K}): {len(reqs)} requests x {new_tokens} tokens, "
              f"prompts {[int(p.size) for p in prompts]}, {steps} verify steps (Sq "
              f"{SPEC_K + 1}), {dispatches} prefill dispatches, launches "
              f"{ {k: n for k, n in got.items() if n} }; proposed {m['serving/spec_proposed']}, "
              f"accepted {m['serving/spec_accepted']} (rate "
              f"{m['serving/spec_accept_rate']:.4f}); vs {against}: {exact}/{total} tokens its "
              f"argmax, worst gap {gap:.4f} (margin {TOP2_MARGIN})")
        print(f"spec path ({kv} KV) on {card}: spec {m['serving/generated_tokens'] / wall:.1f} "
              f"tokens/s, decode {m['serving/decode_step_ms_p50']:.3f} ms/verify step (p50), "
              f"{steps} steps; without spec {pm['serving/generated_tokens'] / plain_wall:.1f} "
              f"tokens/s, {pm['serving/decode_step_ms_p50']:.3f} ms/step, "
              f"{pm['serving/decode_steps']} steps")
        if kv == "bf16":
            profile_decode(model, {**eng_kw, "spec_draft_len": SPEC_K}, prompt, card,
                           label="spec profile")


# the serving kernels' entries: the bf16 ones an fp16 model must never
# launch, and their fp16 counterparts
SERVING_KERNELS = ("paged_decode", "paged_decode_quant", "ragged_prefill", "ragged_prefill_quant",
                   "dense_decode", "dense_decode_quant")


def fp16_serve_path(dev, card: str, prompts, prompt, paged: dict) -> dict:
    """Serve ``DecoderConfig.small_1b(dtype=float16)`` at full width and
    depth (random weights from seed 0, made on the card) with the main
    path's engine settings and requests (9 x 32 tokens), greedy, in six
    runs: (1) paged with an fp16 cache; (2) flat (``page_size=None``);
    (3) paged int8, paged int4, then flat int8; (4) speculative verify, K
    4, on the paged fp16 cache (spec_path's repeated-pattern prompts, so
    the drafter proposes: each verify step reads #4 at Sq 5). Each run's
    engine is warmed up (``serve_counted``; a warm-up wave comes before
    the first run), then served with the counts reset just before and read
    just after: exactly the fp16 entries its arena needs launch, one per layer
    a decode or verify step and a prefill dispatch, and no bf16 serving
    entry. Tokens are gated as the bf16 paths' are: the cache-free plain
    forward (fp16 KV) or the teacher-forced quantized single-stream replay
    with plain kernels (int8 / int4), within TOP2_MARGIN of its argmax;
    zeroed-kernel controls (paged, flat, paged int8) must fail that gate.
    TTFT p50, decode ms/step p50 and tokens/s print beside the bf16 paged
    run's of this call (``paged``). Returns the fp16 entries' launches:
    #4 / #6 from the paged and spec runs, their quantized entries from the
    paged int8 and int4 runs, #5 from the flat run and its quantized entry
    from the flat int8 run."""
    from unittest import mock

    import numpy as np
    import torch

    from accelerate_tpu_torch.models.configs import DecoderConfig
    from accelerate_tpu_torch.models.convert import random_params
    from accelerate_tpu_torch.models.decoder import DecoderLM
    from accelerate_tpu_torch.ops import kernels

    cfg = DecoderConfig.small_1b(dtype=torch.float16)
    t0 = time.perf_counter()
    model = DecoderLM(cfg, device=dev).load_params(random_params(cfg, seed=0, device=dev))
    torch.cuda.synchronize()
    print(f"fp16 serve path: small_1b in fp16 ({cfg.num_layers} layers, E {cfg.embed_dim}, "
          f"H {cfg.num_heads}, KVH {cfg.num_kv_heads}, D {cfg.head_dim}), random weights "
          f"seed 0, built in {time.perf_counter() - t0:.1f} s")
    new_tokens = 32
    base = dict(num_slots=8, page_size=PAGE, max_cache_len=MAX_CACHE,
                prefill_chunks=(128, 512), device=dev)
    spec_prompts = [np.concatenate([prompt(8 + 8 * i), np.tile(prompt(16), 4 + i)])
                    for i in range(8)]
    runs = (("paged fp16", {}, prompts), ("flat fp16", {"page_size": None}, prompts),
            ("paged int8", {"kv_cache_dtype": "int8"}, prompts),
            ("paged int4", {"kv_cache_dtype": "int4"}, prompts),
            ("flat int8", {"kv_cache_dtype": "int8", "page_size": None}, prompts),
            (f"spec K {SPEC_K} fp16", {"spec_draft_len": SPEC_K}, spec_prompts))
    launches = {name + "_f16": 0 for name in SERVING_KERNELS}
    controls = {"paged fp16": "paged_decode_f16", "flat fp16": "dense_decode_f16",
                "paged int8": "paged_decode_quant_f16"}

    def gate(reqs, kv):
        if kv in ("int8", "int4"):
            return quant_replay(model, reqs, kv, new_tokens, dev) + (
                f"the {kv} single-stream replay with plain kernels",)
        return teacher_forced(model, reqs, new_tokens, dev) + ("the cache-free plain forward",)

    for label, kw, reqs_prompts in runs:
        eng_kw = {**base, **kw}
        kv = kw.get("kv_cache_dtype", "bf16")
        quant = "_quant" if kv != "bf16" else ""
        decode = ("paged_decode" if eng_kw["page_size"] else "dense_decode") + quant + "_f16"
        if label == runs[0][0]:
            # the fp16 GEMMs' first calls (cuBLAS handles, the allocator):
            # a warm-up wave before the first measured run, as main_path's
            serve_counted(model, reqs_prompts[:2], 4, **eng_kw)
        engine, reqs, wall, got = serve_counted(model, reqs_prompts, new_tokens, **eng_kw)
        steps, dispatches = engine.step_count, engine.prefill_dispatches
        want = {decode: steps * cfg.num_layers}
        if eng_kw["page_size"]:
            want["ragged_prefill" + quant + "_f16"] = dispatches * cfg.num_layers
        expect_launches(f"fp16 serve path ({label})", got, want)
        bf16 = {k: got.get(k, 0) for k in SERVING_KERNELS if got.get(k, 0)}
        if bf16:
            fail(f"fp16 serve path ({label}): bf16 serving entries launched: {bf16}")
        for name, n in want.items():
            launches[name] += n
        m = engine.metrics()
        if kw.get("spec_draft_len") and not m["serving/spec_proposed"] > 0:
            fail(f"fp16 serve path ({label}): the drafter proposed nothing")
        del engine
        gap, exact, total, against = gate(reqs, kv)
        if not math.isfinite(gap) or gap > TOP2_MARGIN:
            fail(f"fp16 serve path ({label}): a token is {gap} logits below the argmax of "
                 f"{against} (margin {TOP2_MARGIN})")
        tps = m["serving/generated_tokens"] / wall
        spec = (f"; proposed {m['serving/spec_proposed']}, accepted "
                f"{m['serving/spec_accepted']}" if kw.get("spec_draft_len") else "")
        print(f"fp16 serve path ({label}): {len(reqs)} requests x {new_tokens} tokens, "
              f"{steps} {'verify' if kw.get('spec_draft_len') else 'decode'} steps, "
              f"{dispatches} prefill dispatches, launches {want}, no bf16 entry{spec}; vs "
              f"{against}: {exact}/{total} tokens its argmax, worst gap {gap:.4f} (margin "
              f"{TOP2_MARGIN})")
        print(f"fp16 serve path ({label}) on {card}: {tps:.1f} tokens/s over {wall:.3f} s, "
              f"TTFT p50 {m['serving/ttft_ms_p50']:.2f} ms, decode "
              f"{m['serving/decode_step_ms_p50']:.3f} ms/step (p50), arena "
              f"{m['serving/arena_bytes'] / 1e9:.4f} GB; bf16 paged run of this call: "
              f"{paged['tokens_per_s']:.1f} tokens/s, TTFT p50 {paged['ttft_ms_p50']:.2f} ms, "
              f"decode {paged['step_ms_p50']:.3f} ms/step")
        if label in controls:
            name = controls[label]
            wrapper = name.removesuffix("_f16")  # the wrapper routes by dtype
            with mock.patch.object(kernels, wrapper, zeroed(getattr(kernels, wrapper))):
                control, creqs, _, _ = serve_counted(model, reqs_prompts, new_tokens, **eng_kw)
            del control
            cgap, cexact, _, _ = gate(creqs, kv)
            if not cgap > TOP2_MARGIN:
                fail(f"fp16 serve path control ({label}, {name} output zeroed): every token "
                     f"is within {TOP2_MARGIN} of the argmax (worst {cgap}): the gate is blind")
            print(f"fp16 serve path control ({label}, {name} output zeroed): {cexact}/{total} "
                  f"tokens the argmax, worst gap {cgap:.4f}: fails the gate")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# replica path: the engine behind loopback HTTP, as `serve replica` runs it
# ---------------------------------------------------------------------------

REPLICA_HTTP_TIMEOUT = 300  # seconds for one HTTP call
REPLICA_START_TIMEOUT = 300  # the CLI's start: imports, weights, CUDA context
REPLICA_EXIT_TIMEOUT = 60    # SIGTERM to exit code


def http_stream(url: str, body: dict, on_token=None):
    """POST a streamed ``/v1/submit``: ``(events, t_sent, token_times)``, the
    host clock at the request and at each token event's arrival.
    ``on_token(i)`` runs as token event i arrives."""
    import http.client
    from urllib.parse import urlparse

    u = urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=REPLICA_HTTP_TIMEOUT)
    try:
        t_sent = time.perf_counter()
        conn.request("POST", "/v1/submit", body=json.dumps({**body, "stream": True}),
                     headers={"Content-Type": "application/json"})
        events, times = [], []
        for line in conn.getresponse():
            events.append(json.loads(line))
            if events[-1]["event"] == "token":
                times.append(time.perf_counter())
                if on_token is not None:
                    on_token(len(times) - 1)
        return events, t_sent, times
    finally:
        conn.close()


def http_json(url: str, body=None):
    """GET (``body`` None) or POST JSON; the decoded JSON answer."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=REPLICA_HTTP_TIMEOUT) as resp:
        return json.loads(resp.read())


def replica_stream_done(what: str, events, new_tokens: int, outcome: str = "finished"):
    """The tokens of a stream that must end ``done`` with ``outcome`` and,
    when finished, ``new_tokens`` tokens equal to its token events."""
    if not events or events[-1]["event"] != "done":
        fail(f"{what}: the stream broke off without its done event")
    done = events[-1]
    toks = [e["token"] for e in events[:-1]]
    if done["outcome"] != outcome or toks != done["tokens"]:
        fail(f"{what}: outcome {done['outcome']} ({done['finish_reason']}), {len(toks)} "
             f"streamed tokens against {len(done['tokens'])} in done; expected {outcome}")
    if outcome == "finished" and len(toks) != new_tokens:
        fail(f"{what}: {len(toks)} tokens, expected {new_tokens}")
    return toks


def serve_one_at_a_time(model, prompts, new_tokens: int, **eng_kw):
    """The in-process twin of a sequential replica pass: a fresh engine fed
    ``prompts`` one at a time, each run to completion. ``(tokens,
    launches)`` with the counts reset just before and read just after."""
    import torch

    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.serving.engine import ServingEngine

    engine = ServingEngine(model, **eng_kw)
    engine.warmup()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tokens = []
    for p in prompts:
        r = engine.submit(p, max_new_tokens=new_tokens)
        engine.run()
        if r.outcome != "finished":
            fail(f"in-process twin: request ended {r.outcome}")
        tokens.append(list(r.tokens))
    torch.cuda.synchronize()
    return tokens, dict(kernels.launch_counts)


def replica_path(dev, card: str, model, prompts):
    """Serve small_1b through the port's ReplicaServer over loopback HTTP.
    (a) In process, bf16: a sequential pass whose tokens and launch counts
    must be those of the in-process engine fed the same requests one at a
    time (one request at a time on both sides: the same schedule, shapes
    and kernels), then a concurrent wave from 9 client threads held as
    main_path holds itself (teacher-forced, launches = the replica engine's
    own steps and dispatches x layers; a concurrent wave packs and batches
    as its arrivals fall, so its counts are not main_path's). (b) The CLI
    (``python -m accelerate_tpu_torch.commands.serve replica``) as a
    subprocess on the int8 paged arena: 4 requests with the tokens of the
    in-process int8 engine on the same seed, a cancel mid-stream, and exit
    code 0 after SIGTERM. (c) ``--config tiny`` on CUDA fails the decode
    kernels' gate at build. Returns the launches of (a)'s passes and the
    wave's numbers."""
    import argparse
    import tempfile
    import threading

    import torch

    from accelerate_tpu_torch.commands import serve as serve_cli
    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.serving import ReplicaServer
    from accelerate_tpu_torch.serving.engine import ServingEngine

    new_tokens = 32
    eng_kw = dict(num_slots=8, page_size=PAGE, max_cache_len=MAX_CACHE,
                  prefill_chunks=(128, 512), device=dev)
    bodies = [{"prompt": [int(t) for t in p], "max_new_tokens": new_tokens} for p in prompts]

    # (a) sequential: the replica against its in-process twin
    twin_tokens, twin_launches = serve_one_at_a_time(model, prompts, new_tokens, **eng_kw)
    seq_engine = ServingEngine(model, **eng_kw)
    seq_engine.warmup()
    server = ReplicaServer(seq_engine, name="chip-seq").start()
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        seq_tokens = [replica_stream_done(f"replica sequential request {i}",
                                          http_stream(f"{server.url}/v1/submit", b)[0],
                                          new_tokens)
                      for i, b in enumerate(bodies)]
        torch.cuda.synchronize()
        seq_launches = dict(kernels.launch_counts)
    finally:
        server.close()
    if seq_tokens != twin_tokens:
        bad = [i for i, (a, b) in enumerate(zip(seq_tokens, twin_tokens)) if a != b]
        fail(f"replica sequential pass: requests {bad} streamed other tokens than the "
             "in-process engine fed one request at a time")
    if seq_launches != twin_launches:
        fail(f"replica sequential pass: launches {seq_launches} != the in-process "
             f"engine's {twin_launches}")
    print(f"replica path (sequential, bf16): {len(bodies)} requests x {new_tokens} tokens "
          "over loopback HTTP, tokens identical to the in-process engine fed one request "
          f"at a time; launches identical: { {k: n for k, n in seq_launches.items() if n} }")

    # (a) concurrent wave, one client thread per request
    wave = replica_wave(model, prompts, new_tokens, "chip-wave", **eng_kw)
    wave_launches = wave.pop("launches")
    print(f"replica wave on {card}: " + wave_text(wave))

    # (b) the CLI as a subprocess, int8 KV, against the in-process int8 engine
    cli_prompts = prompts[:4]
    twin_int8, _ = serve_one_at_a_time(model, cli_prompts, new_tokens,
                                       kv_cache_dtype="int8", **eng_kw)
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.serve", "replica",
           "--config", "small_1b", "--page-size", str(PAGE), "--num-slots", "8",
           "--max-cache-len", str(MAX_CACHE), "--prefill-chunks", "128,512",
           "--kv-cache-dtype", "int8", "--init-seed", "0", "--port", "0"]
    t0 = time.perf_counter()
    with tempfile.TemporaryFile(mode="w+") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            line = []
            reader = threading.Thread(target=lambda: line.append(proc.stdout.readline()),
                                      daemon=True)
            reader.start()
            reader.join(timeout=REPLICA_START_TIMEOUT)
            if not line or not line[0].strip():
                err.seek(0)
                fail(f"replica CLI printed no startup line: {err.read()[-2000:]}")
            url = json.loads(line[0])["url"]
            started = time.perf_counter() - t0
            cli_tokens = [replica_stream_done(
                f"replica CLI request {i}",
                http_stream(f"{url}/v1/submit", {**bodies[i], "request_id": f"cli-{i}"})[0],
                new_tokens) for i in range(len(cli_prompts))]
            if cli_tokens != twin_int8:
                bad = [i for i, (a, b) in enumerate(zip(cli_tokens, twin_int8)) if a != b]
                fail(f"replica CLI (int8): requests {bad} streamed other tokens than the "
                     "in-process int8 engine on the same seed")

            def cancel_at(i):
                if i == 3:
                    http_json(f"{url}/v1/cancel", {"request_id": "cli-cancel"})

            events, _, _ = http_stream(f"{url}/v1/submit", {
                **bodies[1], "max_new_tokens": 1000, "request_id": "cli-cancel"},
                on_token=cancel_at)
            replica_stream_done("replica CLI cancel", events, 0, outcome="cancelled")
            health = http_json(f"{url}/v1/health")
            if health["free_slots"] != 8 or health["queue_depth"] != 0:
                fail(f"replica CLI: after the cancel /v1/health reads {health}")
            proc.terminate()  # SIGTERM: drain, then exit
            try:
                rc = proc.wait(timeout=REPLICA_EXIT_TIMEOUT)
            except subprocess.TimeoutExpired:
                fail(f"replica CLI did not exit within {REPLICA_EXIT_TIMEOUT} s of SIGTERM")
            if rc != 0:
                err.seek(0)
                fail(f"replica CLI exited {rc} after SIGTERM: {err.read()[-2000:]}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            proc.stdout.close()
    print(f"replica CLI (small_1b, int8 KV, subprocess): started in {started:.1f} s; "
          f"{len(cli_prompts)} requests x {new_tokens} tokens identical to the in-process "
          f"int8 engine; a cancel after {len(events) - 1} tokens ended "
          f"{events[-1]['outcome']}, /v1/health free_slots {health['free_slots']}; exit code "
          "0 after SIGTERM")

    # (c) tiny has no kernel path on the card: the gate refuses it at build
    parser = argparse.ArgumentParser()
    serve_cli.register(parser)
    try:
        serve_cli.build_replica_engine(parser.parse_args(["replica", "--config", "tiny"]))
    except ValueError as exc:
        if "gate" not in str(exc):
            fail(f"replica CLI --config tiny on CUDA raised another error: {exc}")
        print(f"replica CLI --config tiny on CUDA refused at build: {exc}")
    else:
        fail("replica CLI --config tiny on CUDA built an engine")
    launches = {name: {k: n for k, n in counts.items() if n}
                for name, counts in (("sequential", seq_launches), ("wave", wave_launches))}
    return launches, wave


def replica_wave(model, prompts, new_tokens: int, name: str, **eng_kw) -> dict:
    """A concurrent wave through the port's ReplicaServer over loopback
    HTTP, one client thread per request, on an engine warmed up first (as
    ``serve replica`` does before it binds a port). Held as main_path holds
    itself: every stream finished with its budget, tokens teacher-forced,
    launches the replica engine's own steps and dispatches x layers.
    Returns the client-side and engine numbers, with the launches."""
    import threading

    import numpy as np
    import torch

    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.serving import ReplicaServer
    from accelerate_tpu_torch.serving.engine import Request, ServingEngine

    cfg = model.config
    bodies = [{"prompt": [int(t) for t in p], "max_new_tokens": new_tokens} for p in prompts]
    engine = ServingEngine(model, **eng_kw)
    engine.warmup()
    server = ReplicaServer(engine, name=name).start()
    results = [None] * len(bodies)

    def client(i):
        results[i] = http_stream(f"{server.url}/v1/submit", bodies[i])

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(bodies))]
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=REPLICA_HTTP_TIMEOUT)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
        if any(t.is_alive() for t in threads) or None in results:
            fail(f"{name}: a client thread did not finish")
        m = engine.metrics()
    finally:
        server.close()
    reqs = []
    for i, (events, _, _) in enumerate(results):
        toks = replica_stream_done(f"{name} request {i}", events, new_tokens)
        reqs.append(Request(prompt=np.asarray(prompts[i], np.int32),
                            max_new_tokens=new_tokens, tokens=toks))
    expect_launches(name, launches, {
        "paged_decode": engine.step_count * cfg.num_layers,
        "ragged_prefill": engine.prefill_dispatches * cfg.num_layers})
    worst_gap, exact, total = teacher_forced(model, reqs, new_tokens, eng_kw["device"])
    if not math.isfinite(worst_gap) or worst_gap > TOP2_MARGIN:
        fail(f"{name}: a streamed token is {worst_gap} logits below the plain "
             f"forward's argmax (margin {TOP2_MARGIN})")
    ttft = [times[0] - sent for _, sent, times in results]
    itl = [b - a for _, _, times in results for a, b in zip(times, times[1:])]
    n_tok = sum(len(times) for _, _, times in results)
    print(f"{name} (bf16, steps_per_call {engine.steps_per_call}): {len(bodies)} concurrent "
          f"streams, {engine.step_count} decode steps, {engine.prefill_dispatches} prefill "
          f"dispatches, launches { {k: n for k, n in launches.items() if n} }; "
          f"teacher-forced: {exact}/{total} tokens the plain argmax, worst gap "
          f"{worst_gap:.4f} (margin {TOP2_MARGIN})")
    out = {"steps_per_call": engine.steps_per_call, "tokens_per_s": n_tok / wall,
           "wall_s": wall, "ttft_ms_p50": 1e3 * float(np.median(ttft)),
           "itl_ms_p50": 1e3 * float(np.median(itl)),
           "engine_tokens_per_s": m["serving/tokens_per_s"],
           "engine_ttft_ms_p50": m["serving/ttft_ms_p50"],
           "engine_itl_ms_p50": m["serving/itl_p50_ms"],
           "step_ms_p50": m["serving/decode_step_ms_p50"], "launches": launches}
    del engine, server
    gc.collect()
    torch.cuda.empty_cache()
    return out


def wave_text(w: dict) -> str:
    return (f"steps_per_call {w['steps_per_call']}: client side {w['tokens_per_s']:.1f} "
            f"tokens/s over {w['wall_s']:.3f} s, TTFT p50 {w['ttft_ms_p50']:.2f} ms, ITL p50 "
            f"{w['itl_ms_p50']:.3f} ms; engine gauges {w['engine_tokens_per_s']:.1f} tokens/s "
            f"(decode steps only), TTFT p50 {w['engine_ttft_ms_p50']:.2f} ms, ITL p50 "
            f"{w['engine_itl_ms_p50']:.3f} ms, decode {w['step_ms_p50']:.3f} ms/step (p50)")


BURST_KS = (4, 8)  # steps_per_call of the burst path's runs


def burst_path(dev, card: str, model, prompts, main: dict, wave: dict):
    """Decode bursts on the main path's traffic: the same 9 requests x 32
    tokens through small_1b's paged bf16 engine at steps_per_call 4 and 8.
    A burst waits while an admission is in flight or can start, and while
    a budget would overshoot, so the schedule is main_path's: greedy
    tokens, decode steps, prefill dispatches and launches must equal
    main_path's, and at least one burst must run. Sampled, tokens at K 4
    must equal K 1's on the same seeds. Then the replica's
    concurrent wave once more at steps_per_call 4, printed beside the
    wave at 1 from this run's replica path."""
    new_tokens = 32
    eng_kw = dict(num_slots=8, page_size=PAGE, max_cache_len=MAX_CACHE,
                  prefill_chunks=(128, 512), device=dev)
    for k in BURST_KS:
        engine, reqs, wall, launches = serve_counted(model, prompts, new_tokens,
                                                     steps_per_call=k, **eng_kw)
        if [list(r.tokens) for r in reqs] != main["tokens"]:
            bad = [i for i, (r, t) in enumerate(zip(reqs, main["tokens"])) if list(r.tokens) != t]
            fail(f"burst path (K {k}): requests {bad} got other tokens than main path's")
        got = (engine.step_count, engine.prefill_dispatches)
        if got != (main["steps"], main["dispatches"]):
            fail(f"burst path (K {k}): {got} decode steps and prefill dispatches, main "
                 f"path {(main['steps'], main['dispatches'])}")
        if launches != main["launches"]:
            fail(f"burst path (K {k}): launches {launches} != main path's {main['launches']}")
        bursts = [n for _, _, n in engine._step_samples]
        if k not in bursts:
            fail(f"burst path (K {k}): no burst of {k} ran")
        m = engine.metrics()
        print(f"burst path (K {k}): {len(reqs)} requests x {new_tokens} tokens identical to "
              f"main path's; {bursts.count(k)} bursts of {k} and {bursts.count(1)} single "
              f"steps, {engine.step_count} decode steps and {engine.prefill_dispatches} prefill "
              f"dispatches as main path's, launches identical: "
              f"{ {name: n for name, n in launches.items() if n} }")
        print(f"burst path (K {k}) on {card}: {m['serving/generated_tokens'] / wall:.1f} "
              f"tokens/s over {wall:.3f} s, TTFT p50 {m['serving/ttft_ms_p50']:.2f} ms, decode "
              f"{m['serving/decode_step_ms_p50']:.3f} ms/step (p50 of burst wall / steps), ITL "
              f"p50 {m['serving/itl_p50_ms']:.3f} ms; main path (K 1, this run): "
              f"{main['tokens_per_s']:.1f} tokens/s, {main['step_ms_p50']:.3f} ms/step")
        del engine
    # sampled (temperature 1.0, top_k 8; request i seeded i): each slot's
    # generator draws on the device between replays, outside the graph,
    # once a step in step order, so K 4 must give K 1's tokens
    sampled = {}
    for k in (1, 4):
        engine, reqs, wall, launches = serve_counted(
            model, prompts, new_tokens, steps_per_call=k, temperature=1.0, top_k=8, **eng_kw)
        expect_launches(f"burst path (sampled, K {k})", launches, {
            "paged_decode": engine.step_count * model.config.num_layers,
            "ragged_prefill": engine.prefill_dispatches * model.config.num_layers})
        m = engine.metrics()
        sampled[k] = [list(r.tokens) for r in reqs]
        print(f"burst path (sampled, K {k}) on {card}: {m['serving/generated_tokens'] / wall:.1f} "
              f"tokens/s over {wall:.3f} s, decode {m['serving/decode_step_ms_p50']:.3f} "
              f"ms/step (p50), {engine.step_count} decode steps; greedy (K 1, main path, this "
              f"run) {main['step_ms_p50']:.3f} ms/step")
        del engine
    if sampled[4] != sampled[1]:
        bad = [i for i, (a, b) in enumerate(zip(sampled[4], sampled[1])) if a != b]
        fail(f"burst path (sampled): requests {bad} got other tokens at K 4 than at K 1")
    print(f"burst path (sampled): {len(prompts)} requests x {new_tokens} tokens identical at "
          "K 4 and K 1")
    wave4 = replica_wave(model, prompts, new_tokens, "chip-wave-k4", steps_per_call=4,
                         **eng_kw)
    wave4.pop("launches")
    print(f"replica wave on {card}: " + wave_text(wave4))
    print(f"replica wave on {card} (replica path, this run): " + wave_text(wave))


# the scheduled path's traffic: (requests, ~prompt tokens, new tokens) a tenant
SCHED_BATCH = (6, 400, 64)
SCHED_INTERACTIVE = (6, 40, 32)
SCHED_OVERCOMMIT = 1.5      # the batch tenant's pages over the arena's
SCHED_ITL_SLO_MS = 20.0     # the prefill-budget controller's ITL p99 SLO
SCHED_BATCH_QUOTA = 256.0   # the batch tenant's tokens a quota window (1 s)
SCHED_SQUEEZE = (4, 12, 2)  # decode step it fires at, pages it holds, steps it holds them
SCHED_STORM_AT = 48         # the oldest batch request's tokens when the interactive submit
SCHED_TIMEOUT_BATCH = 5     # the batch request submitted with timeout_s=0
SCHED_POISON_INTERACTIVE = 2  # the interactive request whose on_token raises
SCHED_PAIRS = 3             # storms with and without a telemetry session, in pairs
SCHED_TRACED_MIN_RATIO = 0.70  # traced / untraced tokens/s: the reference's witness


def latency_text(reqs, stamps) -> str:
    """TTFT and ITL p50 / p99 of ``reqs`` from their token stamps (host
    clock at each on_token call), in ms."""
    import numpy as np

    ttft = [1e3 * (stamps[r.id][0] - r.submit_t) for r in reqs if stamps.get(r.id)]
    gaps = [1e3 * (b - a) for r in reqs
            for a, b in zip(stamps.get(r.id, []), stamps.get(r.id, [])[1:])]
    if not ttft or not gaps:
        return "no tokens"
    return (f"TTFT p50 {np.percentile(ttft, 50):.2f} / p99 {np.percentile(ttft, 99):.2f} ms, "
            f"ITL p50 {np.percentile(gaps, 50):.3f} / p99 {np.percentile(gaps, 99):.3f} ms "
            f"({len(ttft)} requests, {len(gaps)} gaps)")


def scheduled_path(dev, card: str, model):
    """Multi-tenant scheduling and fault injection on small_1b's paged bf16
    engine (page 16, 8 slots): a batch tenant (priority 0, weight 1, a
    token quota) whose requests ask SCHED_OVERCOMMIT times the pages the
    arena holds, then an interactive tenant (priority 5, weight 4) once the
    batch has taken every slot and page it can and its oldest request is
    halfway, under the ITL controller, one page squeeze (while batch
    requests still queue), one poisoned request and one request with
    timeout_s=0. Gates: (a) every request terminal, preemptions >= 1 and
    every preempted request that finished resumed; (b) every finished
    token within TOP2_MARGIN of the teacher-forced plain forward, and the
    same storm with paged_decode's output zeroed fails that check; (c) no
    graph captured after warmup(), #4 launched step_count x layers and #6
    prefill_dispatches x layers; (d) no page leaked once the prefix cache
    is cleared; (e) the controller observed the run and itl_budget is
    reported. The storm runs SCHED_PAIRS times with a telemetry session
    attached and as often without, in alternating pairs; every run is held
    to (a), (c), (d) and (e), the first traced one to (b) too, and each
    traced run to the telemetry gates: one request record per submission
    whose outcome, finish reason, tenant, token count and preemptions are
    its Request's, ``compiles_in_flight`` 0 on every record, the TTFT and
    ITL histogram counts the engine's first tokens and gaps, and each
    tenant's ``decode_tokens`` its emitted tokens; the traced runs' median
    tokens/s must hold SCHED_TRACED_MIN_RATIO of the untraced runs'. The
    same interactive requests then run alone on an idle engine of the same
    shape, and the preempted ones uninterrupted."""
    import collections
    import os
    import shutil
    import tempfile
    from unittest import mock

    import numpy as np
    import torch

    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.serving import (
        FaultInjector,
        SchedulerConfig,
        ServingEngine,
        TenantConfig,
    )
    from accelerate_tpu_torch.serving.faults import poison_on_token
    from accelerate_tpu_torch.telemetry import TelemetryConfig, TelemetrySession
    from accelerate_tpu_torch.utils import cuda_graphs

    cfg = model.config
    rng = np.random.RandomState(15)
    (n_b, len_b, new_b), (n_i, len_i, new_i) = SCHED_BATCH, SCHED_INTERACTIVE
    batch = [rng.randint(3, cfg.vocab_size, (len_b + int(rng.randint(-24, 25)),)).astype(np.int32)
             for _ in range(n_b)]
    inter = [rng.randint(3, cfg.vocab_size, (len_i + int(rng.randint(-8, 9)),)).astype(np.int32)
             for _ in range(n_i)]
    token_bytes = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * 2
    ask = sum(-(-(p.size + new_b) // PAGE) for p in batch)
    usable = int(round(ask / SCHED_OVERCOMMIT))
    eng_kw = dict(num_slots=8, page_size=PAGE, max_cache_len=MAX_CACHE,
                  prefill_chunks=(128, 512), device=dev)
    print(f"scheduled path: KV {cfg.num_layers} layers x 2 x {cfg.num_kv_heads} KV heads x "
          f"{cfg.head_dim} x 2 B = {token_bytes / 1024:.0f} KiB a token, "
          f"{token_bytes * PAGE / 2**20:.2f} MiB a page of {PAGE}; the batch tenant's {n_b} "
          f"requests (prompts {[int(p.size) for p in batch]} + {new_b} new) ask {ask} pages, the "
          f"arena holds {usable} + the parking page: {ask / usable:.2f}x; interactive "
          f"{n_i} x (prompts {[int(p.size) for p in inter]} + {new_i} new)")

    def sched():
        return SchedulerConfig(
            tenants={"batch": TenantConfig(weight=1.0, quota=SCHED_BATCH_QUOTA),
                     "interactive": TenantConfig(weight=4.0)},
            itl_slo_ms=SCHED_ITL_SLO_MS)

    def storm(session=None):
        """One seeded storm on a fresh, warmed-up engine, fed to
        ``session`` when one is given. Returns the engine, its requests
        (batch, then interactive), token stamps, the launches and captures
        of the run, the budget trajectory and the host seconds of each
        preemption and of each resume's prefill."""
        at, pages, hold = SCHED_SQUEEZE
        faults = FaultInjector(seed=0).squeeze_pages(at_step=at, pages=pages, hold_steps=hold)
        engine = ServingEngine(model, scheduler=sched(), faults=faults, num_pages=usable + 1,
                               telemetry=session, **eng_kw)
        if engine.telemetry is not session:
            fail("scheduled path: the engine attached another telemetry session")
        engine.warmup()
        torch.cuda.synchronize()
        stamps = {}

        def stamp(tok, req):
            stamps.setdefault(req.id, []).append(time.perf_counter())

        out = {"preempt_s": [], "resume_s": [], "evictions": 0, "captures": 0}
        real_preempt, real_advance = engine._preempt, engine._ragged_advance
        real_evict, real_capture = engine._prefix.evict_lru, cuda_graphs.capture

        def preempt(slot, req):
            t = time.perf_counter()
            real_preempt(slot, req)
            out["preempt_s"].append(time.perf_counter() - t)

        def advance():
            resume = engine._admitting[0]._resume
            t = time.perf_counter()
            done = real_advance()
            if resume:
                out["resume_s"].append(time.perf_counter() - t)
            return done

        def evict():
            evicted = real_evict()
            out["evictions"] += int(evicted)
            return evicted

        def capture(*args, **kw):
            out["captures"] += 1
            return real_capture(*args, **kw)

        engine._preempt, engine._ragged_advance = preempt, advance
        engine._prefix.evict_lru = evict
        in_use0 = engine._allocator.in_use
        traj = [(0, engine._controller.budget)]

        def step():
            engine.step()
            if engine._controller.budget != traj[-1][1]:
                traj.append((engine.step_count, engine._controller.budget))

        kernels.reset_launch_counts()
        with mock.patch.object(cuda_graphs, "capture", capture):
            t0 = time.perf_counter()
            breqs = [engine.submit(p, max_new_tokens=new_b, seed=i, tenant="batch", priority=0,
                                   on_token=stamp,
                                   timeout_s=0.0 if i == SCHED_TIMEOUT_BATCH else None)
                     for i, p in enumerate(batch)]
            # the batch takes every slot and page it can (none of it queued or
            # admitting any more) and its oldest request is halfway
            while (engine._queued_depth() or engine._admitting is not None
                   or (engine._slot_req and max(len(r.tokens) for r in breqs) < SCHED_STORM_AT)):
                step()
            out["batch_live"] = len(engine._slot_req)
            out["free_pages_at_storm"] = engine._allocator.free_count
            ireqs = [engine.submit(p, max_new_tokens=new_i, seed=100 + i, tenant="interactive",
                                   priority=5,
                                   on_token=poison_on_token if i == SCHED_POISON_INTERACTIVE
                                   else stamp)
                     for i, p in enumerate(inter)]
            while engine._pending():
                step()
            torch.cuda.synchronize()
            out["wall_s"] = time.perf_counter() - t0
        out["launches"] = dict(kernels.launch_counts)
        out["traj"] = traj
        out["metrics"] = engine.metrics()
        faults.release_all(engine)
        engine._prefix.clear()
        out["leaked"] = engine._allocator.in_use - in_use0
        return engine, breqs, ireqs, stamps, out

    def checked(reqs):
        """(worst gap, exact, total) of the teacher-forced check over every
        finished request's tokens."""
        worst, exact, total = 0.0, 0, 0
        for r in reqs:
            if r.outcome == "finished":
                g, e, t = teacher_forced(model, [r], len(r.tokens), dev)
                worst, exact, total = max(worst, g), exact + e, total + t
        return worst, exact, total

    def gates(engine, breqs, ireqs, out, what):
        """Gates (a), (c), (d) and (e) on one storm."""
        reqs = breqs + ireqs
        # (a) every request terminal; preemption happened, and resumed
        bad = [(r.id, r.outcome) for r in reqs
               if not r.done or r.outcome not in ("finished", "shed", "cancelled")]
        if bad:
            fail(f"{what}: requests not terminal: {bad}")
        preempted = [r for r in reqs if r.preemptions]
        if engine.preemptions < 1:
            fail(f"{what}: no preemption ran")
        unresumed = [r.id for r in preempted if r.outcome == "finished" and r._resume]
        resumed_need = sum(r.preemptions for r in preempted if r.outcome == "finished")
        if unresumed or engine.resumptions < resumed_need:
            fail(f"{what}: preempted requests {unresumed} finished without a resume "
                 f"({engine.resumptions} resumptions, {resumed_need} needed)")
        if reqs[SCHED_TIMEOUT_BATCH].finish_reason != "timeout":
            fail(f"{what}: the timeout_s=0 request ended {reqs[SCHED_TIMEOUT_BATCH].outcome}")
        poisoned = ireqs[SCHED_POISON_INTERACTIVE]
        if poisoned.finish_reason != "callback_error":
            fail(f"{what}: the poisoned request ended {poisoned.finish_reason}")
        # (c) no capture after warmup; launches from this run's steps and
        # dispatches
        if out["captures"] or len(engine._graphs) != 1:
            fail(f"{what}: {out['captures']} graph captures after warmup(), graphs "
                 f"{sorted(engine._graphs)}")
        expect_launches(what, out["launches"], {
            "paged_decode": engine.step_count * cfg.num_layers,
            "ragged_prefill": engine.prefill_dispatches * cfg.num_layers})
        # (d) no leak; (e) the controller observed the run
        if out["leaked"]:
            fail(f"{what}: {out['leaked']} pages still in use after the prefix cache "
                 "was cleared")
        if engine._itl_observed < 1 or "serving/itl_budget" not in out["metrics"]:
            fail(f"{what}: the ITL controller observed nothing or itl_budget is missing")

    def telemetry_gates(engine, reqs, session, trace_dir, what):
        """The traced storm's records, histograms and usage against the
        engine's own requests and counters."""
        recs = [json.loads(line)
                for line in open(os.path.join(trace_dir, "requests-host0.jsonl"))]
        by_id = {r["request_id"]: r for r in recs}
        if len(recs) != len(reqs) or sorted(by_id) != sorted(r.id for r in reqs):
            fail(f"{what}: {len(recs)} request records for {len(reqs)} submissions")
        for r in reqs:
            rec = by_id[r.id]
            got = (rec["outcome"], rec["finish_reason"], rec["tenant"], rec["tokens"],
                   rec.get("preemptions", 0))
            want = (r.outcome, r.finish_reason, r.tenant, len(r.tokens), r.preemptions)
            if got != want:
                fail(f"{what}: request {r.id}'s record says {got}, the request {want}")
        inflight = [r["request_id"] for r in recs if r["compiles_in_flight"]]
        if inflight:
            fail(f"{what}: graphs captured while requests {inflight} were in flight")
        if sum(r.get("preemptions", 0) for r in recs) != engine.preemptions:
            fail(f"{what}: the records' preemptions differ from the engine's "
                 f"{engine.preemptions}")
        firsts = sum(r.first_token_t is not None for r in reqs)
        counts = {k: h.count for k, h in session.hists.items()}
        if (counts.get("serving/ttft"), counts.get("serving/itl")) != \
                (firsts, engine._itl_emitted):
            fail(f"{what}: histogram counts {counts} against {firsts} first tokens and "
                 f"{engine._itl_emitted} gaps")
        for tenant in ("batch", "interactive"):
            emitted = sum(len(r.tokens) for r in reqs if r.tenant == tenant)
            metered = session.usage.tenants[tenant].decode_tokens
            if metered != emitted:
                fail(f"{what}: usage/{tenant}/decode_tokens {metered}, emitted {emitted}")
        return len(recs), counts

    def attribute(session):
        """Wrap the session's hook entry points (the step record, the
        tracer's and the usage meters' methods) to sum their host seconds
        and calls; returns the two counters."""
        spent, calls = collections.Counter(), collections.Counter()

        def wrap(obj, name, label):
            real = getattr(obj, name)

            def call(*args, **kw):
                t = time.perf_counter()
                try:
                    return real(*args, **kw)
                finally:
                    spent[label] += time.perf_counter() - t
                    calls[label] += 1
            setattr(obj, name, call)

        wrap(session, "on_step", "on_step")
        for name in ("on_submit", "on_admission", "on_prefill_chunk", "on_preempt",
                     "on_resume", "on_first_token", "on_token", "on_finish"):
            wrap(session.requests, name, f"tracer.{name}")
        for name in ("note_submit", "note_outcome", "note_preempt", "note_prefill",
                     "note_decode", "note_prefix_hit", "note_compute", "note_pages"):
            wrap(session.usage, name, f"usage.{name}")
        return spent, calls

    def run(traced: bool, attributed: bool = False):
        """One storm, with a fresh session when ``traced`` (its hooks
        timed when ``attributed``); returns the storm's results and,
        traced, the telemetry gates' numbers."""
        session = trace_dir = None
        if traced:
            trace_dir = tempfile.mkdtemp(prefix="telemetry-")
            session = TelemetrySession(TelemetryConfig(trace_dir=trace_dir))
            if attributed:
                hook_s = attribute(session)
        try:
            engine, breqs, ireqs, stamps, out = storm(session)
            what = f"scheduled path ({'traced' if traced else 'untraced'})"
            gates(engine, breqs, ireqs, out, what)
            if traced:
                out["telemetry"] = telemetry_gates(engine, breqs + ireqs, session, trace_dir,
                                                   what)
                out["goodput"] = session.goodput.rollup_keys()
            if attributed:
                out["hooks"] = hook_s
        finally:
            if session is not None:
                session.close()
                shutil.rmtree(trace_dir, ignore_errors=True)
        reqs = breqs + ireqs
        out["tokens_per_s"] = sum(len(r.tokens) for r in reqs) / out["wall_s"]
        out["step_ms_p50"] = out["metrics"]["serving/decode_step_ms_p50"]
        gaps = [1e3 * (b - a) for r in ireqs
                for a, b in zip(stamps.get(r.id, []), stamps.get(r.id, [])[1:])]
        out["itl_ms"] = (float(np.percentile(gaps, 50)), float(np.percentile(gaps, 99)))
        return engine, breqs, ireqs, stamps, out

    runs = {False: [], True: []}
    kept = None
    for i in range(SCHED_PAIRS):
        for traced in ((False, True) if i % 2 == 0 else (True, False)):
            result = run(traced)
            runs[traced].append(result[4])
            if traced and kept is None:
                kept = result
            del result
            gc.collect()
    # one more traced storm with every hook entry point timed: where the
    # traced storms' extra host time goes (the timers' own cost included)
    attributed = run(True, attributed=True)[4]
    gc.collect()
    engine, breqs, ireqs, stamps, out = kept
    del kept
    reqs = breqs + ireqs
    m = out["metrics"]
    preempted = [r for r in reqs if r.preemptions]
    # (b) finished tokens teacher-forced, against a zeroed-kernel control
    worst, exact, total = checked(reqs)
    if not math.isfinite(worst) or worst > TOP2_MARGIN:
        fail(f"scheduled path: a generated token is {worst} logits below the plain forward's "
             f"argmax (margin {TOP2_MARGIN})")
    med = {t: float(np.median([o["tokens_per_s"] for o in runs[t]])) for t in runs}
    ratio = med[True] / med[False]
    for traced in (False, True):
        rows = runs[traced]
        print(f"scheduled path on {card}: {'traced' if traced else 'untraced'} storms: "
              f"tokens/s {[round(o['tokens_per_s'], 1) for o in rows]} (median "
              f"{med[traced]:.1f}), decode ms/step p50 "
              f"{[round(o['step_ms_p50'], 4) for o in rows]}, interactive ITL p50 / p99 ms "
              f"{[(round(a, 3), round(b, 3)) for a, b in (o['itl_ms'] for o in rows)]}, "
              f"run wall s {[round(o['wall_s'], 3) for o in rows]}")
    n_recs, counts = out["telemetry"]
    print(f"scheduled path: telemetry: {n_recs} request records = submissions, outcomes / "
          f"reasons / tenants / tokens / preemptions equal the requests', compiles_in_flight 0 "
          f"on every record, histogram counts {counts}, usage decode_tokens = emitted per "
          f"tenant; goodput {out['goodput']}")
    print(f"scheduled path on {card}: traced / untraced tokens/s (medians over "
          f"{SCHED_PAIRS} pairs) {ratio:.4f}")
    spent, calls = attributed["hooks"]
    top = ", ".join(f"{k} {1e3 * v:.2f} ms / {calls[k]} = {1e6 * v / calls[k]:.1f} us"
                    for k, v in spent.most_common(6))
    walls = {t: float(np.median([o["wall_s"] for o in runs[t]])) for t in runs}
    print(f"scheduled path on {card}: telemetry hooks in a timed traced storm: "
          f"{1e3 * sum(spent.values()):.2f} ms of host time over {sum(calls.values())} calls "
          f"(run wall {attributed['wall_s']:.3f} s; traced - untraced median wall "
          f"{1e3 * (walls[True] - walls[False]):.2f} ms); top: {top}")
    if not ratio >= SCHED_TRACED_MIN_RATIO:
        fail(f"scheduled path: traced storms serve {ratio:.4f}x the untraced tokens/s "
             f"(gate {SCHED_TRACED_MIN_RATIO})")
    sheds = collections.Counter(r.shed_reason for r in reqs if r.outcome == "shed")
    ends = collections.Counter((r.tenant, r.outcome) for r in reqs)
    print(f"scheduled path: batch live at the storm {out['batch_live']}, "
          f"{out['free_pages_at_storm']} pages free; {engine.step_count} decode steps, "
          f"{engine.prefill_dispatches} prefill dispatches, {engine.preemptions} preemptions, "
          f"{engine.resumptions} resumptions, sheds by reason {dict(sheds)}, outcomes "
          f"{ {f'{t}/{o}': n for (t, o), n in sorted(ends.items())} }, {out['evictions']} "
          f"prefix-cache LRU evictions, fault log {engine._faults.log}")
    print(f"scheduled path: teacher-forced check: {exact}/{total} finished tokens are the plain "
          f"argmax, worst gap {worst:.4f} (margin {TOP2_MARGIN}); no graph captured after "
          f"warmup(); launches {out['launches']['paged_decode']} paged_decode = "
          f"{engine.step_count} x {cfg.num_layers}, {out['launches']['ragged_prefill']} "
          f"ragged_prefill = {engine.prefill_dispatches} x {cfg.num_layers}; no page leaked")
    traj = out["traj"]
    print(f"scheduled path: ITL budget (SLO {SCHED_ITL_SLO_MS} ms) at (decode step, budget): "
          f"{[(s, round(b, 4)) for s, b in traj[:24]]}{' ...' if len(traj) > 24 else ''}, "
          f"final {m['serving/itl_budget']}, {m['serving/itl_slo_breaches']} breaches, "
          f"{m['serving/itl_budget_adjustments']} adjustments, engine ITL p99 (last 128) "
          f"{m['serving/itl_recent_p99_ms']} ms")
    ps, rs = out["preempt_s"], out["resume_s"]
    print(f"scheduled path on {card}: host seconds of _preempt: {len(ps)} calls, mean "
          f"{1e3 * np.mean(ps):.3f} ms, max {1e3 * max(ps):.3f} ms; of a resume's prefill "
          f"dispatch: {len(rs)} calls, mean "
          f"{1e3 * np.mean(rs) if rs else float('nan'):.3f} ms, max "
          f"{1e3 * max(rs) if rs else float('nan'):.3f} ms; run wall {out['wall_s']:.3f} s")
    print(f"scheduled path on {card}: interactive under the storm: "
          f"{latency_text(ireqs, stamps)}; batch: {latency_text(breqs, stamps)}")
    del engine

    # the same interactive requests alone on an idle engine of the same shape
    alone = ServingEngine(model, scheduler=sched(), num_pages=usable + 1, **eng_kw)
    alone.warmup()
    astamps = {}
    areqs = [alone.submit(p, max_new_tokens=new_i, seed=100 + i, tenant="interactive",
                          priority=5,
                          on_token=lambda tok, req: astamps.setdefault(req.id, []).append(
                              time.perf_counter()))
             for i, p in enumerate(inter)]
    alone.run()
    print(f"scheduled path on {card}: interactive alone: {latency_text(areqs, astamps)}")
    same = sum(a.tokens == r.tokens for a, r in zip(areqs, ireqs) if r.outcome == "finished")
    print(f"scheduled path: {same}/{sum(r.outcome == 'finished' for r in ireqs)} finished "
          "interactive requests have their tokens alone")
    del alone

    # the preempted requests uninterrupted: FIFO, pages for every slot
    fifo = ServingEngine(model, **eng_kw)
    fifo.warmup()
    ureqs = [fifo.submit(r.prompt, max_new_tokens=r.max_new_tokens,
                         seed=breqs.index(r) if r.tenant == "batch" else 100 + ireqs.index(r))
             for r in preempted]
    fifo.run()
    fin = [(u, r) for u, r in zip(ureqs, preempted) if r.outcome == "finished"]
    tok_same = sum(int(a == b) for u, r in fin for a, b in zip(u.tokens, r.tokens))
    print(f"scheduled path: {sum(u.tokens == r.tokens for u, r in fin)}/{len(fin)} preempted "
          f"and finished requests have exactly their uninterrupted run's tokens "
          f"({tok_same}/{sum(len(r.tokens) for _, r in fin)} tokens; bf16, the replay's last "
          "positions re-prefilled through #6 where a decode step wrote them)")
    del fifo

    # the control: the same storm with the paged decode output zeroed
    with mock.patch.object(kernels, "paged_decode", zeroed(kernels.paged_decode)):
        control, cb, ci, _, _ = storm()
    del control
    gap_c, exact_c, total_c = checked(cb + ci)
    if not gap_c > TOP2_MARGIN:
        fail(f"scheduled path control: with the paged decode output zeroed every finished "
             f"token is within {TOP2_MARGIN} of the plain argmax (worst {gap_c}): the check is "
             "blind")
    print(f"scheduled path: control (paged decode output zeroed): {exact_c}/{total_c} exact, "
          f"worst gap {gap_c:.4f}, fails the check")


def telemetry_replica_path(dev, card: str, model, prompts):
    """A ReplicaServer whose small_1b paged bf16 engine has a telemetry
    session serves ``prompts`` over loopback HTTP, concurrently. Gates:
    every stream ends ``finished``; ``/metrics`` carries the session's
    ``att_serving_ttft`` histogram with a count equal to the requests
    finished (and its ``+Inf`` bucket), the ITL histogram with the engine's
    gap count, and the usage meters; ``POST /v1/flight`` answers
    ``ok: true`` and the bundle it wrote parses, names the reason and
    holds the requests' finish events."""
    import glob
    import os
    import shutil
    import tempfile
    import threading

    import torch

    from accelerate_tpu_torch.serving import ReplicaServer
    from accelerate_tpu_torch.serving.engine import ServingEngine
    from accelerate_tpu_torch.telemetry import TelemetryConfig, TelemetrySession

    new_tokens = 16
    trace_dir = tempfile.mkdtemp(prefix="telemetry-replica-")
    session = TelemetrySession(TelemetryConfig(trace_dir=trace_dir))
    server = None
    try:
        engine = ServingEngine(model, num_slots=8, page_size=PAGE, max_cache_len=MAX_CACHE,
                               prefill_chunks=(128, 512), device=dev)
        if engine.telemetry is not session:
            fail("telemetry replica path: the engine did not pick up the current session")
        engine.warmup()
        torch.cuda.synchronize()
        server = ReplicaServer(engine, name="chip-telemetry").start()
        results = [None] * len(prompts)

        def client(i):
            body = {"prompt": [int(t) for t in prompts[i]], "max_new_tokens": new_tokens}
            results[i] = http_stream(f"{server.url}/v1/submit", body)[0]

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(REPLICA_HTTP_TIMEOUT)
        wall = time.perf_counter() - t0
        for i, events in enumerate(results):
            replica_stream_done(f"telemetry replica request {i}", events or [], new_tokens)
        import urllib.request

        with urllib.request.urlopen(f"{server.url}/metrics",
                                    timeout=REPLICA_HTTP_TIMEOUT) as resp:
            text = resp.read().decode()
        lines = dict(line.rsplit(" ", 1) for line in text.splitlines()
                     if line and not line.startswith("#") and " # " not in line)
        n = len(prompts)
        want = {"att_serving_ttft_seconds_count": n,
                'att_serving_ttft_seconds_bucket{le="+Inf"}': n,
                "att_serving_itl_seconds_count": engine._itl_emitted,
                "att_usage_default_finished": n,
                "att_usage_default_decode_tokens": n * new_tokens}
        got = {k: int(float(lines[k])) if k in lines else None for k in want}
        if got != want:
            fail(f"telemetry replica path: /metrics reads {got}, expected {want}")
        exemplars = sum(" # {request_id=" in line for line in text.splitlines())
        answer = http_json(f"{server.url}/v1/flight", {"reason": "chip-probe"})
        if answer != {"ok": True, "replica": "chip-telemetry", "reason": "chip-probe"}:
            fail(f"telemetry replica path: POST /v1/flight answered {answer}")
        bundles = sorted(glob.glob(os.path.join(trace_dir, "flightrec-host0-*.json")))
        if not bundles:
            fail("telemetry replica path: /v1/flight answered ok but wrote no bundle")
        with open(bundles[-1]) as fh:
            bundle = json.load(fh)
        finishes = sum(e.get("kind") == "request_finish" for e in bundle["events"])
        if bundle.get("reason") != "chip-probe" or finishes != n:
            fail(f"telemetry replica path: the bundle says reason {bundle.get('reason')}, "
                 f"{finishes} finish events for {n} requests")
        mem = bundle.get("device_memory", {})
        print(f"telemetry replica path on {card}: {n} concurrent streams of {new_tokens} "
              f"tokens in {wall:.3f} s; /metrics: {got}, {exemplars} bucket lines with an "
              f"exemplar, {len(text.splitlines())} lines; POST /v1/flight ok, bundle "
              f"{os.path.basename(bundles[-1])} ({os.path.getsize(bundles[-1])} B, "
              f"{len(bundle['events'])} ring events, compile counters "
              f"{bundle.get('compile_counters')}, device memory in use "
              f"{mem.get('sys/mem_bytes_in_use', 0) / 1e9:.3f} GB)")
    finally:
        if server is not None:
            server.close()
        session.close()
        shutil.rmtree(trace_dir, ignore_errors=True)


FLEET_PREFIX = 512      # tokens of the shared prefix the handoff moves (32 pages)
FLEET_TAIL = 32         # each prompt's own tail after it
FLEET_NEW = 16          # tokens generated a request in the handoff steps
FLEET_TIER = (128, 16)  # the tier steps' prefix and tail (9 cache entries a prompt)
FLEET_PREFIX_ENTRIES = 9  # the tier engine's prefix cache: one other prompt evicts the prefix
FLEET_SESSIONS = 4      # router wave: sessions, requests a session, tokens a request
FLEET_SESSION_REQS = 4
FLEET_WAVE_NEW = 24
FLEET_KILL_NEW = 1000   # the killed replica's in-flight streams: long enough to kill mid-stream


def fleet_prompts(rng, vocab: int):
    """The handoff steps' prompts: one shared prefix and its four tails."""
    import numpy as np

    shared = rng.randint(3, vocab, (FLEET_PREFIX,)).astype(np.int32)
    return shared, [np.concatenate([shared, rng.randint(3, vocab, (FLEET_TAIL,))
                                    .astype(np.int32)]) for _ in range(4)]


def first_logits(model):
    """A forward hook on ``model`` keeping the last row of every packed
    prefill's logits (the row a lone request's first token is sampled
    from): ``(rows, remove)``."""
    rows = []

    def hook(module, args, kwargs, out):
        if kwargs.get("ragged_slots") is not None:
            live = int((kwargs["cache_positions"][0] >= 0).sum().item())
            rows.append(out[0, live - 1].float().clone())

    handle = model.register_forward_hook(hook, with_kwargs=True)
    return rows, handle.remove


def serve_in_turn(engine, prompts, new_tokens: int):
    """Each prompt submitted after the previous one finished: the requests."""
    reqs = []
    for p in prompts:
        reqs.append(engine.submit(p, max_new_tokens=new_tokens))
        engine.run()
        if reqs[-1].outcome != "finished":
            fail(f"fleet path: a request ended {reqs[-1].outcome}")
    return reqs


def wait_done(reqs, what: str):
    """Poll requests a replica's loop thread serves until they finish."""
    deadline = time.perf_counter() + REPLICA_HTTP_TIMEOUT
    while not all(r.done for r in reqs):
        if time.perf_counter() > deadline:
            fail(f"fleet path: {what} did not finish")
        time.sleep(0.002)
    for r in reqs:
        if r.outcome != "finished":
            fail(f"fleet path: {what}: a request ended {r.outcome}")


def never_evicted(model, prompt, hit_len: int, new_tokens: int, **eng_kw):
    """The tokens of ``prompt`` admitted over a ``hit_len``-token prefix hit
    whose pages were never evicted: a fresh tierless engine prefills the
    whole prompt cold (as the evicting engine did), drops its cache entries
    deeper than ``hit_len``, and serves the prompt again."""
    from accelerate_tpu_torch.serving.engine import ServingEngine

    eng = ServingEngine(model, **eng_kw)
    serve_in_turn(eng, [prompt], 1)
    for key, entry in list(eng._prefix.entries.items()):
        if entry.token_len > hit_len:
            eng._prefix.evict(key)
    req = serve_in_turn(eng, [prompt], new_tokens)[0]
    if req.prefix_hit != hit_len:
        fail(f"fleet path: the never-evicted twin hit {req.prefix_hit}, not {hit_len}")
    return list(req.tokens)


def fleet_path(dev, card: str, model):
    """KV tiers, the KV handoff and the router on small_1b (page 16, the
    prefix cache, greedy), two in-process ReplicaServers A and B over one
    model on loopback HTTP. Six steps, each failing the run on a miss:
    (1) a bf16 handoff A -> B over ``/v1/kv/export`` and ``/v1/kv/import``:
    B's tokens equal A's warm hits, its first-step logits bit for bit, its
    prefill only the tails, #4 and #6 launched; (2) the same at int8 in
    process: B's gathered pages equal A's bit for bit, payloads and scales;
    (3) the host tier: a prefix evicted by other prompts, demoted, restored,
    tokens equal a never-evicted hit, pages back to baseline, no graph
    captured after warmup(); (4) the disk tier: a fresh engine over step 3's
    blobs restores from one; a truncated copy is rejected and counted; (5)
    the peer tier: an empty engine pulls the prefix through A's directory
    and export; (6) a RouterServer over A and B with a FleetCollector: a
    wave of sessions (affinity; held teacher-forced), A drained mid-wave
    (its sessions move to B with their KV), then killed with streams in
    flight (each continued on B after the tokens A delivered, exactly its
    budget, and held teacher-forced as one sequence), marked down within
    one poll. Returns the path's launches."""
    import base64
    import glob
    import os
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.serving import ReplicaServer
    from accelerate_tpu_torch.serving.engine import Request, ServingEngine
    from accelerate_tpu_torch.serving.pages import gather_pages
    from accelerate_tpu_torch.serving.router import Router, RouterConfig, RouterServer
    from accelerate_tpu_torch.serving.tiers import BLOB_SUFFIX, TierConfig, TieredStore
    from accelerate_tpu_torch.telemetry.fleet import DOWN_STATES
    from accelerate_tpu_torch.utils import cuda_graphs

    cfg = model.config
    rng = np.random.RandomState(17)
    eng_kw = dict(num_slots=8, page_size=PAGE, max_cache_len=MAX_CACHE,
                  prefill_chunks=(128, 512), device=dev)
    tmp = tempfile.mkdtemp(prefix="fleet-path-")
    servers, router, router_server = [], None, None
    kernels.reset_launch_counts()

    def since(mark):
        return {k: n - mark[k] for k, n in kernels.launch_counts.items()}

    try:
        # (1) the bf16 handoff over HTTP
        shared, prompts = fleet_prompts(rng, cfg.vocab_size)
        cold_prompt = fleet_prompts(rng, cfg.vocab_size)[1][0]
        eng_a, eng_b = ServingEngine(model, **eng_kw), ServingEngine(model, **eng_kw)
        for eng in (eng_a, eng_b):
            eng.warmup()
        torch.cuda.synchronize()
        serve_in_turn(eng_a, [shared], 1)
        rows, unhook = first_logits(model)
        try:
            warm_a = serve_in_turn(eng_a, prompts, FLEET_NEW)
            logits_a = list(rows)
            rows.clear()
            cold_b = serve_in_turn(eng_b, [cold_prompt], FLEET_NEW)[0]
            rows.clear()
            server_a = ReplicaServer(eng_a, name="A").start()
            server_b = ReplicaServer(eng_b, name="B").start()
            servers += [server_a, server_b]
            t0 = time.perf_counter()
            body = json.dumps({"tokens": [int(t) for t in shared]}).encode()
            import urllib.request

            with urllib.request.urlopen(urllib.request.Request(
                    f"{server_a.url}/v1/kv/export", data=body,
                    headers={"Content-Type": "application/json"}),
                    timeout=REPLICA_HTTP_TIMEOUT) as resp:
                wire = resp.read()
            export_ms = 1e3 * (time.perf_counter() - t0)
            handoff = json.loads(wire)
            t0 = time.perf_counter()
            with urllib.request.urlopen(urllib.request.Request(
                    f"{server_b.url}/v1/kv/import", data=wire,
                    headers={"Content-Type": "application/json"}),
                    timeout=REPLICA_HTTP_TIMEOUT) as resp:
                installed = json.loads(resp.read())
            import_ms = 1e3 * (time.perf_counter() - t0)
            n_pages = FLEET_PREFIX // PAGE
            if installed != {"installed_tokens": FLEET_PREFIX, "replica": "B"} or \
                    handoff["n_pages"] != n_pages:
                fail(f"fleet path: the handoff installed {installed}, {handoff['n_pages']} "
                     f"pages, expected {FLEET_PREFIX} tokens in {n_pages} pages")
            mark = dict(kernels.launch_counts)
            packed0 = eng_b.prefill_packed_tokens
            t_sub = time.perf_counter()
            warm_b = [eng_b.submit(p, max_new_tokens=FLEET_NEW) for p in prompts[:1]]
            wait_done(warm_b, "B's first imported hit")
            ttft_import_ms = 1e3 * (warm_b[0].first_token_t - t_sub)
            for p in prompts[1:]:
                warm_b.append(eng_b.submit(p, max_new_tokens=FLEET_NEW))
                wait_done(warm_b[-1:], "B's imported hits")
            b_launches = since(mark)
            logits_b = list(rows)
        finally:
            unhook()
        if [r.tokens for r in warm_b] != [r.tokens for r in warm_a]:
            fail("fleet path: B's tokens after the import differ from A's warm hits")
        if len(logits_a) != 4 or len(logits_b) != 4 or \
                not all(torch.equal(x, y) for x, y in zip(logits_a, logits_b)):
            fail("fleet path: B's first-step logits differ from A's warm hits")
        if any(r.prefix_hit != FLEET_PREFIX for r in warm_a + warm_b) or \
                eng_b.prefill_packed_tokens - packed0 != 4 * FLEET_TAIL:
            fail(f"fleet path: B prefilled {eng_b.prefill_packed_tokens - packed0} tokens "
                 f"for 4 tails of {FLEET_TAIL}; hits {[r.prefix_hit for r in warm_b]}")
        if not (b_launches["paged_decode"] and b_launches["ragged_prefill"]):
            fail(f"fleet path: #4 / #6 not launched on B: {b_launches}")
        mb = len(wire) / 1e6
        print(f"fleet path (1) bf16 handoff on {card}: {FLEET_PREFIX} tokens, {n_pages} pages, "
              f"{mb:.3f} MB of JSON ({sum(len(base64.b64decode(l['data'])) for l in handoff['leaves']) / 1e6:.3f} MB of pages); "
              f"export {export_ms:.1f} ms ({mb / export_ms * 1e3:.1f} MB/s), import "
              f"{import_ms:.1f} ms ({mb / import_ms * 1e3:.1f} MB/s); B's TTFT cold "
              f"{1e3 * (cold_b.first_token_t - cold_b.submit_t):.2f} ms ({cold_b.prompt.size} "
              f"tokens), after the import {ttft_import_ms:.2f} ms (prefix hit {FLEET_PREFIX}, "
              f"tail {FLEET_TAIL}); 4 prompts' tokens and first-step logits equal A's warm "
              f"hits; B launches {b_launches}")

        # (2) the int8 handoff, in process
        a8 = ServingEngine(model, kv_cache_dtype="int8", **eng_kw)
        b8 = ServingEngine(model, kv_cache_dtype="int8", **eng_kw)
        for eng in (a8, b8):
            eng.warmup()
        serve_in_turn(a8, [shared], 1)
        warm_a8 = serve_in_turn(a8, prompts, FLEET_NEW)
        h8 = json.loads(json.dumps(a8.export_prefix_kv(shared)))
        if b8.import_prefix_kv(h8) != FLEET_PREFIX:
            fail("fleet path: the int8 handoff was not installed")
        _, ea = a8._prefix.peek(shared)
        _, eb = b8._prefix.peek(shared)
        pa, pb = gather_pages(a8._arena, ea.pages), gather_pages(b8._arena, eb.pages)
        if len(pa) != 4 or not all(np.array_equal(x, y) for x, y in zip(pa, pb)):
            fail("fleet path: B's int8 pages (payloads, scales) differ from A's")
        mark = dict(kernels.launch_counts)
        warm_b8 = serve_in_turn(b8, prompts, FLEET_NEW)
        q_launches = since(mark)
        if [r.tokens for r in warm_b8] != [r.tokens for r in warm_a8]:
            fail("fleet path: int8 tokens after the import differ from A's warm hits")
        if not (q_launches["paged_decode_quant"] and q_launches["ragged_prefill_quant"]):
            fail(f"fleet path: the int8 entries of #4 / #6 were not launched: {q_launches}")
        print(f"fleet path (2) int8 handoff: {len(json.dumps(h8)) / 1e6:.3f} MB of JSON, "
              f"4 leaves ({', '.join(l['dtype'] for l in h8['leaves'])}) bit-equal after "
              f"the import, tokens equal; launches {q_launches}")
        del a8, b8, pa, pb, h8
        gc.collect()

        # (3) the host tier on one engine
        tier_kw = dict(eng_kw, num_pages=257, prefix_max_entries=FLEET_PREFIX_ENTRIES)
        disk = os.path.join(tmp, "kv")
        n_pre, n_tail = FLEET_TIER
        tier_prompt = rng.randint(3, cfg.vocab_size, (n_pre + n_tail,)).astype(np.int32)
        other = rng.randint(3, cfg.vocab_size, (n_pre + n_tail,)).astype(np.int32)
        eng_h = ServingEngine(model, kv_tiers=TierConfig(host_entries=4, disk_entries=64,
                                                         disk_dir=disk), **tier_kw)
        eng_h.warmup()
        captured = cuda_graphs.capture_counters()["count"]
        base_pages = eng_h._allocator.in_use
        serve_in_turn(eng_h, [tier_prompt, other], 1)
        if eng_h._tiers.demotions_host < 1:
            fail("fleet path: other prompts did not demote the prefix")
        # each restore batch's page installs, timed alone (the request's
        # kv_restore_ms also holds the demotions its insert triggers)
        from accelerate_tpu_torch.serving import engine as engine_mod

        batch_ms, real_install = [], engine_mod.install_pages

        def timed_install(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            real_install(*args)
            torch.cuda.synchronize()
            batch_ms.append(1e3 * (time.perf_counter() - t))

        engine_mod.install_pages = timed_install
        try:
            restored = serve_in_turn(eng_h, [tier_prompt], FLEET_NEW)[0]
        finally:
            engine_mod.install_pages = real_install
        if restored.kv_restore_tier != "host" or eng_h.kv_tier_hits["host"] < 1:
            fail(f"fleet path: the prefix came from {restored.kv_restore_tier}, not host")
        eng_h.drain()
        eng_h._prefix.clear()
        if eng_h._allocator.in_use != base_pages:
            fail(f"fleet path: {eng_h._allocator.in_use} pages allocated after the drain, "
                 f"{base_pages} before")
        if cuda_graphs.capture_counters()["count"] != captured:
            fail("fleet path: a graph was captured after the tier engine's warmup()")
        twin = never_evicted(model, tier_prompt, restored.prefix_hit, FLEET_NEW, **tier_kw)
        if restored.tokens != twin:
            fail("fleet path: the host-restored tokens differ from a never-evicted hit")
        print(f"fleet path (3) host tier: prefix hit {restored.prefix_hit} restored from host, "
              f"{restored.kv_restore_pages} pages in {len(batch_ms)} batches of "
              f"{eng_h._tiers.config.restore_batch_pages}: installs "
              f"{', '.join(f'{ms:.3f}' for ms in batch_ms)} ms a batch; kv_restore_ms "
              f"{restored.kv_restore_ms:.3f} (with the demotions the restored entries' "
              f"insert set off); {eng_h._tiers.demotions_host} host, "
              f"{eng_h._tiers.demotions_disk} disk demotions; tokens equal a never-evicted "
              f"hit; pages back to {base_pages}; no capture after warmup()")
        del eng_h
        gc.collect()

        # (4) the disk tier: a fresh engine over step 3's blobs
        eng_d = ServingEngine(model, kv_tiers=TierConfig(host_entries=4, disk_entries=64,
                                                         disk_dir=disk), **tier_kw)
        if not eng_d._tiers.disk.entries:
            fail("fleet path: the fresh engine found no blob of step 3's")
        eng_d.warmup()
        from_disk = serve_in_turn(eng_d, [tier_prompt], FLEET_NEW)[0]
        if from_disk.kv_restore_tier != "disk":
            fail(f"fleet path: the fresh engine restored from {from_disk.kv_restore_tier}")
        if from_disk.tokens != never_evicted(model, tier_prompt, from_disk.prefix_hit,
                                             FLEET_NEW, **tier_kw):
            fail("fleet path: the disk-restored tokens differ from a never-evicted hit")
        torn = os.path.join(tmp, "torn")
        os.makedirs(torn)
        blob = sorted(glob.glob(os.path.join(disk, "*" + BLOB_SUFFIX)))[0]
        with open(blob, "rb") as src, open(os.path.join(torn, os.path.basename(blob)),
                                            "wb") as dst:
            dst.write(src.read()[: os.path.getsize(blob) // 2])
        store = TieredStore(TierConfig(host_entries=1, disk_entries=4, disk_dir=torn),
                            page_size=PAGE)
        if store.disk_corrupt_dropped != 1 or store.disk.entries or os.listdir(torn):
            fail("fleet path: a truncated blob was not rejected, counted and deleted")
        print(f"fleet path (4) disk tier: a fresh engine found {len(eng_d._tiers.disk.entries)} "
              f"blobs, restored prefix hit {from_disk.prefix_hit} from disk in "
              f"{from_disk.kv_restore_ms:.3f} ms ({from_disk.kv_restore_pages} pages), tokens "
              f"equal a never-evicted hit; a truncated copy rejected and counted")
        del eng_d
        gc.collect()

        # (5) the peer tier: pull through A's directory and export
        eng_p = ServingEngine(model, kv_tiers=TierConfig(host_entries=4, peers=(
            ("A", server_a.url),)), **eng_kw)
        eng_p.warmup()
        pulled = serve_in_turn(eng_p, prompts[:1], FLEET_NEW)[0]
        if pulled.kv_restore_tier != "peer" or eng_p.kv_tier_hits["peer"] < 1 or \
                eng_p.kv_pages_imported != pulled.kv_restore_pages or \
                pulled.kv_restore_pages != -(-pulled.prefix_hit // PAGE):
            fail(f"fleet path: the peer pull gave tier {pulled.kv_restore_tier}, "
                 f"{eng_p.kv_pages_imported} pages imported for a {pulled.prefix_hit}-token hit")
        gap, _, _ = teacher_forced(model, [pulled], FLEET_NEW, dev)
        if not math.isfinite(gap) or gap > TOP2_MARGIN:
            fail(f"fleet path: a token after the peer pull is {gap} below the argmax")
        print(f"fleet path (5) peer tier: pulled a {pulled.prefix_hit}-token prefix "
              f"({eng_p.kv_pages_imported} pages) from A in {pulled.kv_restore_ms:.3f} ms; "
              f"teacher-forced worst gap {gap:.4f}")
        del eng_p
        gc.collect()

        # (6) the router over A and B. B's own requests are kept by id: a
        # stream re-queued onto B is A's tokens up to the kill, then B's
        # continuation of them
        b_reqs, b_submit = {}, eng_b.submit

        def kept_submit(*args, **kw):
            req = b_submit(*args, **kw)
            b_reqs[kw.get("request_id")] = req
            return req

        eng_b.submit = kept_submit
        router = Router({"A": server_a.url, "B": server_b.url},
                        config=RouterConfig(backoff_base_s=0.01, backoff_cap_s=0.05,
                                            max_retries=6, poll_interval_s=0.1)).start()
        router_server = RouterServer(router)
        front = f"http://127.0.0.1:{router_server.port}"
        router.collector.poll_once()
        sessions = []
        for s in range(FLEET_SESSIONS):
            base = rng.randint(3, cfg.vocab_size, (256,)).astype(np.int32)
            sessions.append([np.concatenate([base, rng.randint(3, cfg.vocab_size, (16 * (i + 1),))
                                             .astype(np.int32)])
                             for i in range(FLEET_SESSION_REQS)])
        done = {}

        progress = {}  # tokens each stream's client has received so far

        def one(s, i, new_tokens, on_token=None):
            body = {"prompt": [int(t) for t in sessions[s][i]], "max_new_tokens": new_tokens,
                    "session": f"s{s}", "request_id": f"s{s}-{i}"}

            def arrived(k):
                progress[(s, i)] = k + 1
                if on_token is not None:
                    on_token(k)

            events, sent, times = http_stream(f"{front}/v1/submit", body, arrived)
            done[(s, i)] = (events, sent, times, new_tokens)

        def wave(i, new_tokens, on_token=None, which=range(FLEET_SESSIONS)):
            threads = [threading.Thread(target=one, args=(s, i, new_tokens, on_token),
                                        daemon=True) for s in which]
            for t in threads:
                t.start()
            return threads

        def joined(threads, what):
            for t in threads:
                t.join(REPLICA_HTTP_TIMEOUT)
            if any(t.is_alive() for t in threads):
                fail(f"fleet path: {what}: a client hung")

        t_wave = time.perf_counter()
        # the first half of the sessions starts on the idle fleet; the rest
        # once the collector ranks the other replica first under that load
        half = FLEET_SESSIONS // 2
        idle_first = router.collector.placement_view()[0]["replica"]
        first = wave(0, FLEET_WAVE_NEW * 4, which=range(half))
        deadline = time.perf_counter() + REPLICA_HTTP_TIMEOUT
        while router.collector.placement_view()[0]["replica"] == idle_first:
            if time.perf_counter() > deadline or all((s, 0) in done for s in range(half)):
                fail("fleet path: the collector never ranked the other replica first under "
                     "the first sessions' load")
            time.sleep(0.01)
        joined(first + wave(0, FLEET_WAVE_NEW * 4, which=range(half, FLEET_SESSIONS)),
               "router wave 0")
        joined(wave(1, FLEET_WAVE_NEW), "router wave 1")
        placed = {s: [done[(s, i)][0][-1]["replica"] for i in range(2)]
                  for s in range(FLEET_SESSIONS)}
        if any(a != b for a, b in placed.values()):
            fail(f"fleet path: a session's second request left its replica: {placed}")
        on_a = [s for s, (r, _) in placed.items() if r == "A"]
        if not on_a or len(on_a) == FLEET_SESSIONS:
            fail(f"fleet path: the wave did not spread over both replicas: {placed}")
        # request 2: long streams; once A's are flowing, drain A and send
        # request 3, whose A sessions move to B with their KV
        flowing = threading.Event()
        long_threads = wave(2, FLEET_KILL_NEW, on_token=lambda k: k >= 8 and flowing.set())
        if not flowing.wait(REPLICA_HTTP_TIMEOUT):
            fail("fleet path: the long streams never started")
        imported0 = eng_b.kv_pages_imported
        server_a.request_drain()
        deadline = time.perf_counter() + 30
        while any(r["replica"] == "A" for r in router.collector.placement_view()):
            if time.perf_counter() > deadline:
                fail("fleet path: the collector never saw A drain")
            time.sleep(0.02)
        last_threads = wave(3, FLEET_WAVE_NEW)
        # A dies once its sessions' KV has moved, its long streams still
        # in flight: they re-queue onto B
        t_migrate = time.perf_counter()
        deadline = t_migrate + REPLICA_HTTP_TIMEOUT
        while router.kv_migrations < len(on_a):
            if time.perf_counter() > deadline:
                fail(f"fleet path: {router.kv_migrations} KV migrations for {len(on_a)} "
                     "sessions on the draining replica")
            time.sleep(0.005)
        migrate_s = time.perf_counter() - t_migrate
        in_flight = [s for s in on_a if (s, 2) not in done]
        at_kill = {f"s{s}-2": progress.get((s, 2), 0) for s in in_flight}
        server_a.kill()
        joined(last_threads, "router wave 3")
        moved = {s: done[(s, 3)][0][-1]["replica"] for s in on_a}
        if set(moved.values()) != {"B"} or eng_b.kv_pages_imported <= imported0:
            fail(f"fleet path: A's sessions went to {moved}, B imported "
                 f"{eng_b.kv_pages_imported - imported0} pages")
        joined(long_threads, "the killed replica's streams")
        wall = time.perf_counter() - t_wave
        router.collector.poll_once()
        state = router.collector.replicas["A"].state
        if state not in DOWN_STATES:
            fail(f"fleet path: the collector reads A as {state} one poll after the kill")
        reqs, splices = [], []
        for (s, i), (events, _, _, new_tokens) in sorted(done.items()):
            rid = f"s{s}-{i}"
            toks = replica_stream_done(f"router request {rid}", events, new_tokens)
            if events[-1]["request_id"] != rid:
                fail(f"fleet path: stream {rid} finished as {events[-1]['request_id']}")
            # every stream is held whole: a re-queued one too, as one sequence
            reqs.append(Request(prompt=sessions[s][i], max_new_tokens=new_tokens, tokens=toks))
            if not events[-1]["requeues"]:
                continue
            # re-queued: B continued after the k tokens A had delivered, so
            # B's request is the prompt + those k, and its tokens the rest
            cont, seen = b_reqs[rid], at_kill.get(rid, 0)
            k = cont.prompt.size - sessions[s][i].size
            resumed = np.concatenate([sessions[s][i], np.asarray(toks[:max(k, 0)], np.int32)])
            if k < seen or not np.array_equal(cont.prompt, resumed) or \
                    list(cont.tokens) != toks[k:]:
                fail(f"fleet path: B's request {rid} is not the stream's continuation after "
                     f"its first {k} tokens (its client had {seen} at the kill)")
            splices.append((rid, seen, k))
        if not in_flight or len(splices) < len(in_flight):
            fail(f"fleet path: {len(in_flight)} streams in flight on A at the kill, "
                 f"{len(splices)} re-queued")
        worst = max(teacher_forced(model, [r], r.max_new_tokens, dev)[0] for r in reqs)
        if not math.isfinite(worst) or worst > TOP2_MARGIN:
            fail(f"fleet path: a routed token is {worst} logits below the plain argmax")
        m = router.metrics()
        print(f"fleet path (6) router: re-queued streams (id, tokens its client had at the "
              f"kill, tokens A had delivered where B continued): {splices}")
        ttfts = sorted((1e3 * (times[0] - sent), f"s{s}-{i}")
                       for (s, i), (_, sent, times, _) in done.items())
        print(f"fleet path (6) router: client TTFT per stream (ms, slowest last): "
              f"{', '.join(f'{rid} {ms:.1f}' for ms, rid in ttfts)}")
        print(f"fleet path (6) router on {card}: {len(done)} streams in {FLEET_SESSIONS} "
              f"sessions over {wall:.3f} s, affinity held, sessions on A {on_a} moved to B "
              f"with {router.kv_migrations} KV migrations ({eng_b.kv_pages_imported - imported0} "
              f"pages, {migrate_s:.3f} s from request 3's submit), {len(splices)} streams re-queued after the kill (in flight on A: "
              f"{len(in_flight)}), A {state} one poll after; router TTFT p50 / p99 "
              f"{m['router/ttft_p50_ms']:.2f} / {m['router/ttft_p99_ms']:.2f} ms, ITL p50 / p99 "
              f"{m['router/itl_p50_ms']:.3f} / {m['router/itl_p99_ms']:.3f} ms; collector "
              f"{router.collector.polls} polls; teacher-forced worst gap {worst:.4f} "
              f"(margin {TOP2_MARGIN})")
        return dict(kernels.launch_counts)
    finally:
        if router_server is not None:
            router_server.close()
        if router is not None:
            router.close()
        for server in servers:
            server.close()
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# the fleet-ops path: one seeded workload (two tenants, chat sessions) that
# the load generator replays in process and through the router
FLEET_OPS_SPEC = dict(
    name="fleet-ops", seed=20261018, vocab_size=32_000, prompt_cap=1536,
    tenants=[
        dict(name="chat", weight=3.0, priority=5, prompt_len={"uniform": [64, 512]},
             max_new_tokens={"fixed": 64}, session_prob=0.5,
             session_turns={"uniform": [2, 4]}, turn_growth={"uniform": [32, 128]}),
        dict(name="batch", weight=1.0, priority=0, prompt_len={"uniform": [512, 1024]},
             max_new_tokens={"choice": [128, 256]}),
    ])
FLEET_OPS_CLOSED = (8, 48)   # (a): closed-loop users, requests
FLEET_OPS_OPEN = 64          # (b): open-loop Poisson requests through the router
FLEET_OPS_LOAD = 0.5         # (b): offered tokens/s over the fleet's capacity gauge
# every replica of the path: small_1b as chip_smoke serves it, with the
# prefill laid out so a prompt's tokens are the same bits on every admission
FLEET_OPS_REPLICA = ("--config", "small_1b", "--max-seq-len", str(MAX_CACHE),
                     "--page-size", str(PAGE), "--num-slots", "8",
                     "--max-cache-len", str(MAX_CACHE), "--prefill-chunks", "128,512",
                     "--invariant-prefill")
FLEET_OPS_GOLDENS = (24, 100, 333, 700)  # golden prompt lengths (16 new tokens, seed 0)
FLEET_OPS_ITL_SLO_MS = 20.0  # (d): the ITL SLO the burn rule spends against
# (d): the autoscaler's policy, its windows cut to a drill of about a minute
FLEET_OPS_POLICY = dict(min_replicas=1, max_replicas=2, headroom_floor=0.5,
                        scale_in_headroom=0.5, scale_in_margin=1.25, cooldown_s=5.0,
                        confirm_evals=2, fast_s=4.0, slow_s=12.0, horizon_s=4.0)
FLEET_OPS_RAMP = (300, 4.0, 40.0)  # (d): ramp requests, from / to requests per second


FLEET_OPS_LAYOUT_PROMPTS = 12  # (c): the layout control's prompts (16 new tokens each)


def layout_control(model, dev) -> dict:
    """``{"plain": (over a hit, co-admitted), "invariant": (...)}``: how many
    of ``FLEET_OPS_LAYOUT_PROMPTS`` prompts (24..700 tokens, greedy) change
    a token when served over their own prefix hit, and when co-admitted
    all at once, against the same prompt served cold and alone, on a fresh
    engine with the reference's prefill layout and with
    ``invariant_prefill``."""
    import numpy as np

    from accelerate_tpu_torch.serving.engine import ServingEngine

    rng = np.random.RandomState(29)
    prompts = [rng.randint(3, model.config.vocab_size, (int(n),)).astype(np.int32)
               for n in np.linspace(24, 700, FLEET_OPS_LAYOUT_PROMPTS)]
    out = {}
    for kind in ("plain", "invariant"):
        eng = ServingEngine(model, num_slots=8, page_size=PAGE, max_cache_len=MAX_CACHE,
                            prefill_chunks=(128, 512), device=dev,
                            invariant_prefill=kind == "invariant")
        eng.warmup()
        cold = [list(r.tokens) for r in serve_in_turn(eng, prompts, 16)]
        warm = [list(r.tokens) for r in serve_in_turn(eng, prompts, 16)]
        eng._prefix.clear()
        packed = [eng.submit(p, max_new_tokens=16) for p in prompts]
        eng.run()
        out[kind] = (sum(a != b for a, b in zip(cold, warm)),
                     sum(a != list(r.tokens) for a, r in zip(cold, packed)))
        del eng
    return out


def start_replica(name: str, init_seed: int, telemetry_dir: str):
    """``serve replica`` as a subprocess, as a user runs it: ``(process,
    stderr file)``; :func:`replica_url` reads its startup line."""
    import tempfile

    err = tempfile.TemporaryFile(mode="w+")
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.serve", "replica",
           *FLEET_OPS_REPLICA, "--init-seed", str(init_seed), "--name", name,
           "--telemetry-dir", telemetry_dir, "--port", "0"]
    return subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True), err


def replica_url(name: str, proc, err) -> str:
    import threading

    line = []
    reader = threading.Thread(target=lambda: line.append(proc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(timeout=REPLICA_START_TIMEOUT)
    if not line or not line[0].strip():
        err.seek(0)
        fail(f"fleet_ops path: replica {name} printed no startup line: {err.read()[-2000:]}")
    return json.loads(line[0])["url"]


def stop_replica(name: str, proc, err, check: bool = True):
    """SIGTERM (drain, then exit); exit code 0 unless ``check`` is off."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=REPLICA_EXIT_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
            if check:
                fail(f"fleet_ops path: replica {name} did not exit after SIGTERM")
    if check and proc.returncode != 0:
        err.seek(0)
        fail(f"fleet_ops path: replica {name} exited {proc.returncode}: {err.read()[-2000:]}")
    proc.stdout.close()
    err.close()


def fleet_ops_path(dev, card: str, model):
    """Load generation, the SLO scorecard, the waterfall, the canary,
    incidents and the autoscaler on small_1b (page 16, the prefix cache,
    greedy). Four steps, each failing the run on a miss:
    (a) in process: the seeded two-tenant workload replayed closed loop (8
    users, 48 requests) on a ServingEngine with a telemetry session; one
    schedule digest from two builds; the scorecard conserves against the
    engine's ``serving/requests_terminal``; every finished request held
    teacher-forced; #4 / #6 launched once a layer for each of the engine's
    decode steps and prefill dispatches; no graph captured after warmup;
    the capacity gauges at least the achieved rate.
    (b) ``serve replica`` subprocesses A and B (and C, over ``--init-seed
    1``) behind a RouterServer with its FleetCollector: goldens recorded on
    idle A and probed alone at A and B, then ``loadtest run --url`` replays
    the workload open loop at half the fleet's capacity gauge while a
    canary prober sends the goldens through the router; every waterfall
    sums to its client-observed TTFT; the scorecard conserves.
    (c) the canary: every probe on A and B passed; probed straight at C,
    every probe fails, ``canary_failing`` fires in a fleet collector, C
    dumps its flight recorder, and ``reconstruct_incidents`` names the
    rule, C, the failed probes and the dump, in time order; a layout
    control (:func:`layout_control`) counts the prompts whose tokens a
    prefix hit or a pack row changes, on the reference's prefill layout
    and on ``invariant_prefill``'s (which must change none).
    (d) the autoscaler over A alone: a ramp past A's capacity fires
    ``itl_burn_rate``; it spawns ``serve replica`` on the card, gates it on
    the goldens, registers it and sees it placeable and placed; the ramp
    over, the operator step of the reference's drill (the breach cleared at
    the rule, the surplus made actionable), and it drains, deregisters and
    reaps the replica, its conservation ledger holding; ``autoscale
    --once`` prints a hold. Returns (a)'s launches."""
    import dataclasses
    import glob
    import os
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.serving import loadgen
    from accelerate_tpu_torch.serving.autoscaler import (
        Autoscaler,
        SubprocessSpawner,
        direct_submit_fn,
    )
    from accelerate_tpu_torch.serving.engine import ServingEngine
    from accelerate_tpu_torch.serving.router import (
        HttpTransport,
        Router,
        RouterConfig,
        RouterServer,
    )
    from accelerate_tpu_torch.telemetry import TelemetryConfig, TelemetrySession
    from accelerate_tpu_torch.telemetry import incidents as incident_mod
    from accelerate_tpu_torch.telemetry import scorecard
    from accelerate_tpu_torch.telemetry import waterfall as waterfall_mod
    from accelerate_tpu_torch.telemetry.artifacts import read_jsonl
    from accelerate_tpu_torch.telemetry.canary import CanaryProber, flight_via_router, via_router
    from accelerate_tpu_torch.telemetry.capacity import (
        CAPACITY_KEY,
        HEADROOM_KEY,
        AutoscalePolicy,
        fleet_capacity,
    )
    from accelerate_tpu_torch.telemetry.fleet import (
        PLACEABLE_STATES,
        FleetCollector,
        fleet_default_ruleset,
    )
    from accelerate_tpu_torch.utils import cuda_graphs

    cfg = model.config
    tmp = tempfile.mkdtemp(prefix="fleet-ops-")
    dirs = {k: os.path.join(tmp, k) for k in ("a", "A", "B", "fleet", "log", "lt", "auto",
                                              "once")}
    spec = loadgen.WorkloadSpec(**FLEET_OPS_SPEC)
    spec.save(os.path.join(tmp, "workload.json"))
    # the replicas boot (weights, kernels from _build/, the decode graph)
    # while step (a) runs in process
    procs = {name: start_replica(name, seed, dirs["log" if name == "C" else name])
             for name, seed in (("A", 0), ("B", 0), ("C", 1))}
    t_boot = time.perf_counter()
    routers, collectors, probers = [], [], []
    try:
        # (a) in process
        users, n_closed = FLEET_OPS_CLOSED
        closed = dataclasses.replace(spec, mode="closed", users=users, num_requests=n_closed)
        digests = {loadgen.schedule_digest(loadgen.build_schedule(closed)) for _ in range(2)}
        if len(digests) != 1:
            fail(f"fleet_ops path (a): two builds of one spec gave digests {digests}")
        session = TelemetrySession(TelemetryConfig(trace_dir=dirs["a"], flight_hooks=False,
                                                   timeline_interval_s=0))
        try:
            engine = ServingEngine(model, num_slots=8, page_size=PAGE, max_cache_len=MAX_CACHE,
                                   prefill_chunks=(128, 512), device=dev, telemetry=session)
            engine.warmup()
            torch.cuda.synchronize()
            captured = cuda_graphs.capture_counters()["count"]
            kept, submit = {}, engine.submit

            def kept_submit(*args, **kw):
                kept[kw.get("request_id")] = req = submit(*args, **kw)
                return req

            engine.submit = kept_submit
            kernels.reset_launch_counts()
            result = loadgen.run(closed, engine, time_scale=0.0, timeout_s=300)
            torch.cuda.synchronize()
            launches = dict(kernels.launch_counts)
            m = engine.metrics()
            card_a = scorecard.build_scorecard(result, telemetry_dir=dirs["a"])
        finally:
            session.close()
        counts = card_a["counts"]
        terminal = counts["finished"] + counts["shed"] + counts["cancelled"]
        if result.digest not in digests or not card_a["conserved"] or counts["in_flight"] or \
                counts["finished"] != n_closed or terminal != m["serving/requests_terminal"]:
            fail(f"fleet_ops path (a): digest {result.digest} of {digests}, counts {counts}, "
                 f"engine requests_terminal {m['serving/requests_terminal']}")
        expect_launches("fleet_ops path (a)", launches, {
            "paged_decode": engine.step_count * cfg.num_layers,
            "ragged_prefill": engine.prefill_dispatches * cfg.num_layers})
        if cuda_graphs.capture_counters()["count"] != captured:
            fail("fleet_ops path (a): a CUDA graph was captured after warmup()")
        reqs = [r for r in kept.values() if r.outcome == "finished"]
        worst = max(teacher_forced(model, [r], len(r.tokens), dev)[0] for r in reqs)
        if len(reqs) < 4 or not math.isfinite(worst) or worst > TOP2_MARGIN:
            fail(f"fleet_ops path (a): a replayed token is {worst} logits below the plain "
                 f"argmax ({len(reqs)} requests held)")
        if not m.get(CAPACITY_KEY) or m[CAPACITY_KEY] < m["serving/tokens_per_s"] * 0.999:
            fail(f"fleet_ops path (a): capacity {m.get(CAPACITY_KEY)} against tokens/s "
                 f"{m.get('serving/tokens_per_s')}")
        print(f"fleet_ops path (a) in process on {card}: {n_closed} requests closed loop "
              f"({users} users) in {result.wall_s:.3f} s, digest {result.digest}; "
              f"{engine.step_count} decode steps, {engine.prefill_dispatches} prefill "
              f"dispatches, launches equal; {len(reqs)} requests teacher-forced, worst gap "
              f"{worst:.4f}; attainment {card_a['fleet']['slo_attainment_frac']:.3f}, goodput "
              f"{card_a['fleet']['goodput_tokens_per_s']} tok/s, TTFT p50 / p99 "
              f"{card_a['fleet'].get('ttft_p50_ms')} / {card_a['fleet'].get('ttft_p99_ms')} ms; "
              f"engine tokens/s {m['serving/tokens_per_s']:.1f}, capacity "
              f"{m[CAPACITY_KEY]} tok/s, headroom {m[HEADROOM_KEY]}, decode step p50 "
              f"{m['serving/decode_step_ms_p50']:.3f} ms")

        # (b) through the router
        urls = {name: replica_url(name, *procs[name]) for name in procs}
        print(f"fleet_ops path (b): replicas A, B, C up {time.perf_counter() - t_boot:.1f} s "
              f"after their launch")
        goldens = [{"prompt": [int(t) for t in np.random.RandomState(n).randint(
            3, cfg.vocab_size, (n,))], "seed": 0, "max_new_tokens": 16}
            for n in FLEET_OPS_GOLDENS]
        recorder = CanaryProber(direct_submit_fn(urls["A"]), goldens)
        for _ in goldens:
            if recorder.probe_once()["reason"] != "recorded":
                fail("fleet_ops path (b): a golden was not recorded on idle A")
        goldens = [dict(g) for g in recorder.goldens]
        alone = {}
        for name in ("A", "B"):
            prober = CanaryProber(direct_submit_fn(urls[name]), goldens)
            alone[name] = [prober.probe_once()["passed"] for _ in range(2 * len(goldens))]
        collector = FleetCollector([(n, urls[n] + "/metrics") for n in ("A", "B")],
                                   poll_interval_s=0.25, log_dir=dirs["fleet"])
        collectors.append(collector)
        router = Router({n: urls[n] for n in ("A", "B")}, collector=collector,
                        config=RouterConfig(poll_interval_s=0.25, log_dir=dirs["fleet"]))
        routers.append(router)
        router.start()
        front = RouterServer(router)
        routers.append(front)
        collector.poll_once()
        fleet = fleet_capacity(collector.fleet_gauges())
        if fleet is None:
            fail("fleet_ops path (b): the collector read no capacity gauge off A and B")
        open_spec = dataclasses.replace(spec, mode="open", num_requests=FLEET_OPS_OPEN)
        mean_new = np.mean([s.max_new_tokens for s in loadgen.build_schedule(open_spec)])
        rate = FLEET_OPS_LOAD * fleet["capacity_tokens_per_s"] / mean_new
        open_spec = dataclasses.replace(open_spec, arrival={"process": "poisson",
                                                            "rate_rps": round(rate, 3)})
        open_spec.save(os.path.join(tmp, "open.json"))
        prober = CanaryProber(via_router(router), goldens, interval_s=0.5,
                              log_dir=dirs["fleet"], flight_fn=flight_via_router(router))
        probers.append(prober)
        router.attach_canary(prober.start())
        t0 = time.perf_counter()
        lt = subprocess.run(
            [sys.executable, "-m", "accelerate_tpu_torch.commands.loadtest", "run",
             os.path.join(tmp, "open.json"), "--url", f"http://127.0.0.1:{front.port}",
             "--out", dirs["lt"], "--json", "--timeout", "300"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        lt_wall = time.perf_counter() - t0
        prober.stop()
        if lt.returncode != 0:
            fail(f"fleet_ops path (b): loadtest run exited {lt.returncode}: {lt.stderr[-2000:]}")
        card_b = json.loads(lt.stdout)
        if not card_b["conserved"] or card_b["counts"]["finished"] != FLEET_OPS_OPEN:
            shed = {(r["outcome"], r.get("shed_reason"), r.get("finish_reason"))
                    for r in loadgen.load_offered(dirs["lt"]).records}
            errors = {h.get("error") for r in waterfall_mod.load_router_requests(dirs["fleet"])
                      for h in r.get("hops") or () if h.get("error")}
            fail(f"fleet_ops path (b): scorecard counts {card_b['counts']}: {shed}; hop "
                 f"errors {sorted(errors)[:6]}")
        router_recs = waterfall_mod.load_router_requests(dirs["fleet"])
        replica_recs = read_jsonl([dirs["A"], dirs["B"]], "requests-host*.jsonl")
        rows = waterfall_mod.build_waterfalls(router_recs, replica_recs)
        finished = {r["request_id"] for r in router_recs if r.get("outcome") == "finished"}
        bad = [r["request_id"] for r in rows
               if not r["joined"]
               or abs(sum(r["stages"].values()) - r["e2e_ttft_ms"]) > 0.02
               or abs(r["e2e_ttft_ms"] - r["client_ttft_ms"]) > 0.1]
        if bad or len(rows) < len(finished) or len(finished) < FLEET_OPS_OPEN:
            fail(f"fleet_ops path (b): {len(rows)} waterfalls for {len(finished)} finished "
                 f"router requests; stages off the client TTFT: {bad[:8]}")
        agg = waterfall_mod.summarize_waterfall(rows)
        rm = router.metrics()
        replica_gauges = {name: r.gauges for name, r in collector.replicas.items()}
        fl = card_b["fleet"]
        print(f"fleet_ops path (b) router on {card}: loadtest run --url, {FLEET_OPS_OPEN} "
              f"requests open loop Poisson at {rate:.3f} rps ({FLEET_OPS_LOAD} x the fleet's "
              f"{fleet['capacity_tokens_per_s']} tok/s capacity gauge / {mean_new:.1f} mean new "
              f"tokens) in {card_b['wall_s']} s ({lt_wall:.1f} s with the CLI's start); "
              f"attainment {fl['slo_attainment_frac']:.3f} (TTFT <= {card_b['slo']['ttft_ms']} "
              f"ms, ITL <= {card_b['slo']['itl_ms']} ms), goodput {fl['goodput_tokens_per_s']} "
              f"tok/s; client TTFT p50 / p99 {fl.get('ttft_p50_ms')} / {fl.get('ttft_p99_ms')} "
              f"ms, ITL p50 / p99 {fl.get('itl_p50_ms')} / {fl.get('itl_p99_ms')} ms; router "
              f"TTFT p50 / p99 {rm['router/ttft_p50_ms']:.2f} / {rm['router/ttft_p99_ms']:.2f} "
              f"ms, ITL p50 / p99 {rm['router/itl_p50_ms']:.3f} / {rm['router/itl_p99_ms']:.3f} "
              f"ms; replicas' own TTFT p50 "
              + ", ".join(f"{n} {g.get('serving/ttft_ms_p50', float('nan')):.2f}"
                          for n, g in sorted(replica_gauges.items()))
              + " ms, ITL p50 "
              + ", ".join(f"{n} {g.get('serving/itl_p50_ms', float('nan')):.3f}"
                          for n, g in sorted(replica_gauges.items()))
              + f" ms; {rm['router/requeues']} failed hops re-queued; {len(rows)} waterfalls "
              f"sum to their client TTFT (stage shares "
              + ", ".join(f"{k} {v['share']:.3f}" for k, v in agg["stages"].items()) + ")")

        # (c) the canary
        probe_ttft = [r["ttft_ms"] for r in prober.results if r.get("ttft_ms") is not None]
        alone_fail = {n: v.count(False) for n, v in alone.items()}
        if any(alone_fail.values()) or prober.probes_failed or prober.probes_passed < 1:
            fail(f"fleet_ops path (c): goldens failed on correct replicas: alone {alone_fail} "
                 f"of {2 * len(goldens)} each, through the router {prober.probes_failed} of "
                 f"{prober.probes_sent}")
        ctl = FleetCollector([("C", urls["C"] + "/metrics")], log_dir=dirs["log"])
        collectors.append(ctl)

        def dump_c(replica, info):
            HttpTransport().post_json(urls["C"], "/v1/flight", {
                "reason": "canary_failed", "request_id": info.get("request_id")})

        control = CanaryProber(direct_submit_fn(urls["C"]), goldens, window=4,
                               log_dir=dirs["log"], flight_fn=dump_c)
        probers.append(control)
        for _ in goldens:
            res = control.probe_once()
            ctl.poll_once()
            ctl.timeline.add_sample(control.rollup_keys())
            ctl.alerts.evaluate()
            if res["passed"] or res["replica"] != "C":
                fail(f"fleet_ops path (c): a golden passed on C (--init-seed 1): {res}")
        control.close()
        dumps = sorted(glob.glob(os.path.join(dirs["log"], "flightrec-host*-*.json")))
        if "canary_failing" not in ctl.alerts.firing() or len(dumps) < len(goldens):
            fail(f"fleet_ops path (c): firing {ctl.alerts.firing()}, {len(dumps)} flight dumps")
        found = [i for i in incident_mod.reconstruct_incidents(dirs["log"])
                 if i["rule"] == "canary_failing"]
        events = found[0]["events"] if found else []
        kinds = {(e["source"], e["kind"]) for e in events}
        failed = [e for e in events if e["source"] == "canary"]
        ts = [e["t_unix_s"] for e in events]
        if not found or ts != sorted(ts) or not {("alert", "firing"), ("canary", "probe_failed"),
                                                  ("flight", "dump")} <= kinds \
                or not failed or any(e["replica"] != "C" for e in failed):
            fail(f"fleet_ops path (c): the incident reads {kinds} ({len(found)} found)")
        inc_cli = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch.commands.incident",
                                  "list", dirs["log"]], cwd=ROOT, capture_output=True,
                                 text=True, timeout=120)
        if inc_cli.returncode != 0 or "canary_failing" not in inc_cli.stdout:
            fail(f"fleet_ops path (c): incident list: {inc_cli.stdout} {inc_cli.stderr}")
        stop_replica("C", *procs.pop("C"))
        # why the replicas run --invariant-prefill: prompts recorded cold and
        # alone, then probed over their own prefix hit and co-admitted
        # together, on an in-process engine laid out as the reference's
        # and on one with invariant_prefill
        del engine
        layout = layout_control(model, dev)
        if layout["invariant"] != (0, 0):
            fail(f"fleet_ops path (c): an invariant_prefill engine changed a prompt's tokens: "
                 f"{layout}")
        print(f"fleet_ops path (c) canary: goldens of {list(FLEET_OPS_GOLDENS)} tokens recorded "
              f"on idle A; failed alone {alone_fail} of {2 * len(goldens)} each, through the "
              f"router under (b)'s traffic {prober.probes_failed} of {prober.probes_sent} "
              f"(probe TTFT mean / max {np.mean(probe_ttft):.2f} / {max(probe_ttft):.2f} ms); "
              f"C (--init-seed 1) failed {control.probes_failed} of {control.probes_sent}, "
              f"canary_failing firing, {len(dumps)} flight dumps on C, incident "
              f"#{found[0]['index']} with {len(events)} ordered events; layout control, "
              f"{FLEET_OPS_LAYOUT_PROMPTS} prompts (over their own prefix hit, co-admitted), "
              f"tokens changed: default layout {layout['plain']}, invariant_prefill "
              f"{layout['invariant']}")

        # (d) the autoscaler over A alone
        for r in routers[::-1]:
            r.close()
        routers.clear()
        stop_replica("B", *procs.pop("B"))
        policy = AutoscalePolicy(**FLEET_OPS_POLICY)
        auto_collector = FleetCollector(
            [("A", urls["A"] + "/metrics")], poll_interval_s=0.25, log_dir=dirs["auto"],
            rules=fleet_default_ruleset(itl_slo_ms=FLEET_OPS_ITL_SLO_MS,
                                        itl_fast_s=policy.fast_s, itl_slow_s=policy.slow_s,
                                        itl_for_s=1.0))
        collectors.append(auto_collector)
        router = Router({"A": urls["A"]}, collector=auto_collector,
                        config=RouterConfig(poll_interval_s=0.25, log_dir=dirs["auto"]))
        routers.append(router)
        router.start()
        autoscaler = Autoscaler(
            router, policy=policy,
            spawner=SubprocessSpawner(replica_args=FLEET_OPS_REPLICA + ("--init-seed", "0"),
                                      startup_timeout_s=REPLICA_START_TIMEOUT),
            goldens=goldens, canary_probes=len(goldens), log_dir=dirs["auto"],
            interval_s=0.5, placeable_timeout_s=30.0, drain_timeout_s=60.0)
        router.attach_autoscaler(autoscaler)
        print(f"fleet_ops path (d) policy: {FLEET_OPS_POLICY}, itl_burn_rate SLO "
              f"{FLEET_OPS_ITL_SLO_MS} ms (fast {policy.fast_s} s, slow {policy.slow_s} s, "
              f"for 1.0 s), collector poll 0.25 s, evaluation every 0.5 s")
        build = {f: os.path.getmtime(f) for f in glob.glob(str(kernels.BUILD_DIR / "*"))}
        free_before = torch.cuda.mem_get_info()[0]
        n_ramp, r_from, r_to = FLEET_OPS_RAMP
        ramp = loadgen.WorkloadSpec(
            name="fleet-ops-ramp", seed=FLEET_OPS_SPEC["seed"] + 1, mode="open",
            num_requests=n_ramp, vocab_size=cfg.vocab_size, prompt_cap=1024,
            arrival={"process": "ramp", "rate_rps": r_from, "rate_rps_to": r_to},
            tenants=[loadgen.TenantSpec("ramp", prompt_len={"uniform": [256, 768]},
                                        max_new_tokens={"fixed": 64})])
        offered = {}
        load = threading.Thread(target=lambda: offered.update(
            result=loadgen.run(ramp, router, timeout_s=300.0)), daemon=True)
        autoscaler.start()
        t_ramp = time.perf_counter()
        load.start()

        def decision(action, deadline_s):
            deadline = time.perf_counter() + deadline_s
            while time.perf_counter() < deadline:
                recs = [d for d in list(autoscaler.decisions) if d["action"] == action]
                if recs:
                    return recs[0]
                time.sleep(0.1)
            reasons = [d["reason"] for d in list(autoscaler.decisions)[-12:]]
            gauges = {n: {k: r.gauges.get(k) for k in (
                "serving/itl_recent_p99_ms", HEADROOM_KEY, CAPACITY_KEY, "serving/tokens_per_s",
                "serving/requests_completed")} for n, r in auto_collector.replicas.items()}
            fail(f"fleet_ops path (d): no {action} within {deadline_s} s; last decisions "
                 f"{reasons}; burn {auto_collector.alerts.states_snapshot().get('itl_burn_rate')}; "
                 f"replicas {gauges}")

        out_rec = decision("scale_out", 120.0)
        free_after = torch.cuda.mem_get_info()[0]
        if out_rec.get("outcome") != "scaled_out" or "itl_burn_rate" not in out_rec["firing"] \
                or not all(p["passed"] for p in out_rec["canary"]):
            fail(f"fleet_ops path (d): the scale-out record reads {out_rec}")
        name = out_rec["replica"]
        if auto_collector.replicas[name].state not in PLACEABLE_STATES:
            fail(f"fleet_ops path (d): {name} is {auto_collector.replicas[name].state}")
        landed, deadline = 0, time.perf_counter() + 60
        while not landed and time.perf_counter() < deadline:
            landed += router.submit(goldens[0]["prompt"], max_new_tokens=8).replica == name
        load.join(timeout=300.0)
        counts = offered["result"].counts()
        shed_reasons = sorted({r.get("shed_reason") for r in offered["result"].records
                               if r.get("outcome") == "shed"})
        if not landed or load.is_alive() or counts["finished"] + counts["shed"] != n_ramp:
            fail(f"fleet_ops path (d): landed on {name}: {bool(landed)}, ramp {counts}")
        t_quiet = time.perf_counter()
        # the load has stopped, but two gauges the fleet reads do not decay
        # on an idle replica (the reference's as the port's): A's recent
        # ITL p99 keeps its ramp value, so the fleet's MAX keeps the burn
        # firing, and its tokens/s keeps its busy value, so the projected
        # load vetoes the scale-in. As in the reference's drill, the
        # operator clears the breach at the rule and makes the surplus
        # actionable; the autoscaler then scales in on its own cadence
        for rule in auto_collector.alerts.rules:
            if rule.name == "itl_burn_rate":
                rule.slo = 1e9
        autoscaler.policy.scale_in_headroom = -1.0
        autoscaler.policy.scale_in_margin = 0.0
        in_rec = decision("scale_in", 120.0)
        handle_gone = name not in router._replicas and name not in autoscaler.owned
        if in_rec.get("outcome") != "scaled_in" or not in_rec["ledger"]["conserved"] \
                or not handle_gone or not autoscaler.conservation()["conserved"]:
            fail(f"fleet_ops path (d): the scale-in record reads {in_rec}")
        rebuilt = {f: os.path.getmtime(f) for f in glob.glob(str(kernels.BUILD_DIR / "*"))}
        if rebuilt != build:
            fail("fleet_ops path (d): the spawned replica rebuilt kernels in _build/")
        once = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch.commands.autoscale",
                               "--once", "--replica", f"A={urls['A']}", "--log-dir",
                               dirs["once"]], cwd=ROOT, capture_output=True, text=True,
                              timeout=120)
        if once.returncode != 0 or json.loads(once.stdout)["action"] != "hold":
            fail(f"fleet_ops path (d): autoscale --once: {once.stdout} {once.stderr[-2000:]}")
        st = out_rec["stages"]
        print(f"fleet_ops path (d) autoscaler on {card}: ramp of {n_ramp} requests "
              f"{r_from} -> {r_to} rps through the router; burn fired, scale-out at "
              f"{out_rec['t_unix_s'] - t_ramp - time.time() + time.perf_counter():.1f} s into "
              f"the ramp ({out_rec['reason']}); autoscale_reaction_s "
              f"{out_rec['autoscale_reaction_s']} (decide_lag {st['decide_lag_s']}, spawn "
              f"{st['spawn_s']}, canary {st['canary_s']}, register {st['register_s']}, "
              f"placement {st['placement_s']} s); {name} passed {len(out_rec['canary'])} "
              f"golden probes, placed and took routed traffic; free device memory "
              f"{free_before / 1e9:.2f} GB before the spawn, {free_after / 1e9:.2f} GB after; "
              f"_build/ untouched; ramp {counts} (shed: {shed_reasons}); the ramp over, the operator cleared the "
              f"burn at the rule and set scale_in_headroom -1, scale_in_margin 0; scale-in "
              f"{time.perf_counter() - t_quiet:.1f} s later "
              f"({in_rec['reason']}; drain {in_rec['stages']['drain_s']} s, reap "
              f"{in_rec['stages']['reap_s']} s); ledger {in_rec['ledger']['after']}; "
              f"autoscale --once: {json.loads(once.stdout)['reason']}")
        return launches
    finally:
        for p in probers:
            p.close()
        for r in routers[::-1]:
            r.close()
        for c in collectors:
            c.close()
        for name, (proc, err) in procs.items():
            stop_replica(name, proc, err, check=False)
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def profile_prefill(model, eng_kw, prompts, new_tokens: int, card: str):
    """The ragged prefill kernel's share of one served run of ``prompts``:
    torch.profiler's device-side events over the whole run, the kernel's
    total device time and launches beside the run's device busy time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        serve_counted(model, prompts, new_tokens, **eng_kw)
    busy_ms, rows = device_time(prof)
    if not rows:
        print("prefill profile: the profiler recorded no device time (not measured)")
        return
    hits = [(m, n) for m, n, name in rows if "prefill_kernel" in name]
    ms, calls = sum(m for m, _ in hits), sum(n for _, n in hits)
    print(f"prefill profile on {card}: one served run of the main path's requests: the "
          f"ragged prefill kernel {ms:.3f} ms of device time over {calls} launches "
          f"({ms / max(calls, 1) * 1e3:.1f} us each), device busy {busy_ms:.1f} ms")


# the burst length of profile_decode's burst window
PROFILE_BURST = 4


def profiled(run, calls: int):
    """Two windows of ``calls`` calls of ``run()``, the card synchronised
    before and after each: the first timed on the host clock alone, the
    second under torch.profiler (whose tracing of every kernel and op
    slows the wall). ``(wall ms, profiled wall ms, device busy ms,
    rows)``, rows as :func:`device_time` gives them (empty when the
    profiler saw no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, rows = device_time(prof)
    return wall_ms, traced_ms, busy_ms, rows


def window_text(what: str, n: int, wall_ms: float, traced_ms: float, busy_ms: float,
                rows) -> str:
    """One measured window's line, per step: the wall, the wall under the
    profiler, device busy and the idle share (busy against the
    unprofiled wall of as many steps)."""
    text = (f"{what}: {n} + {n} steps, wall {wall_ms / n:.3f} ms/step ({traced_ms / n:.3f} "
            "under the profiler), device busy ")
    if not rows:
        return text + "not measured"
    return text + (f"{busy_ms / n:.3f} ms/step ({100 * busy_ms / wall_ms:.1f}% of wall, idle "
                   f"{100 - 100 * busy_ms / wall_ms:.1f}%)")


# decode steps in each profiled window of a captured step (K 1, or bursts
# of PROFILE_BURST): long enough that a window's fixed costs (a
# synchronize on each side, the profiler's start and stop) stay small
# beside the ~3 ms steps it times. An uncaptured window times fewer: its
# steps take 15-90 ms of host time each, and the profiler's processing
# grows with every traced launch
PROFILE_STEPS = 48
UNCAPTURED_STEPS = 12


def profile_decode(model, eng_kw, prompt, card: str, steps: int = PROFILE_STEPS,
                   label: str = "profile"):
    """Where a decode (or verify) step's time goes, with and without its
    CUDA graph: windows on one engine with all 8 slots live at ~400
    tokens, each timed alone and then again under torch.profiler
    (:func:`profiled`): (1) ``UNCAPTURED_STEPS`` calls of the step body,
    uncaptured (this script hands the engine its body in place of the
    graph's replay); (2) ``steps`` replays of the captured step at K 1,
    what the engine serves with; (3) without spec, ``steps`` decode steps
    in bursts of ``PROFILE_BURST``.
    Prints each window's wall, device busy and idle share per decode
    step, and the kernels with the most device time in (2)."""
    from unittest import mock

    import torch

    from accelerate_tpu_torch.serving.engine import ServingEngine

    engine = ServingEngine(model, steps_per_call=PROFILE_BURST, **eng_kw)
    engine.warmup()
    engine.steps_per_call = 1
    window_steps = UNCAPTURED_STEPS + steps + (0 if engine.spec_k else steps)
    budget = (2 * window_steps + 64) * (1 + engine.spec_k)
    for _ in range(8):
        # the budget outlasts admission (the flat engine prefills one
        # 128-token chunk per iteration: 32 iterations for 8 x 400 tokens)
        # and the windows (two of each kind; no bursts under spec), even
        # when a verify step emits K + 1 tokens: no slot finishes and
        # parks inside them
        engine.submit(prompt(400), max_new_tokens=budget)
    while engine._queue or engine._admitting is not None:
        engine.step()
    engine.step()  # one plain step outside the windows
    if len(engine._slot_req) != 8:
        fail(f"{label}: {len(engine._slot_req)} of 8 slots live before the window")
    body = engine._verify_body if engine.spec_k else engine._decode_body

    def window(what, calls):
        before = engine.step_count
        wall_ms, traced_ms, busy_ms, rows = profiled(engine.step, calls)
        n = (engine.step_count - before) // 2
        print(f"{label} on {card}: " + window_text(what, n, wall_ms, traced_ms, busy_ms, rows)
              + ", 8 live slots at ~400 tokens")
        return n, rows

    with mock.patch.object(engine, "_step_fn", lambda name: body):
        window("uncaptured step body", UNCAPTURED_STEPS)
    n, rows = window("captured verify step" if engine.spec_k else "captured step, K 1", steps)
    if not engine.spec_k:
        engine.steps_per_call = PROFILE_BURST
        window(f"captured bursts, K {PROFILE_BURST}", steps // PROFILE_BURST)
    if len(engine._slot_req) != 8:
        fail(f"{label}: a slot finished inside the windows")
    torch.cuda.synchronize()
    for ms, count, key in rows[:8]:
        print(f"  {ms / n:8.3f} ms/step  {count // n:4d}/step  {key[:90]}")
    kernel = "dense decode kernel #5" if eng_kw["page_size"] is None else "paged decode kernel #4"
    decode_kernel_share(rows, n, label, kernel)


def decode_kernel_share(rows, steps: int, label: str, kernel: str):
    """Print the decode kernel's device time per step from a profile's
    ``rows``: a launch of it is two CUDA kernels of the ``decode::``
    namespace, the split walk and the merge pass (csrc/decode_common.cuh),
    the paged kernel's (#4) or the dense one's (#5), whichever the
    profiled step ran."""
    hits = [(ms, count) for ms, count, key in rows if "decode::" in key]
    if hits:
        ms, count = sum(m for m, _ in hits), sum(n for _, n in hits)
        print(f"  {label}: {kernel} (split walk + merge pass) {ms / steps:.3f} ms/step over "
              f"{count // steps} CUDA kernels/step")


# the training path (training slice): small_1b at full width, batch 8 x
# 2048, bf16 mixed precision over fp32 master weights, remat save_attention.
# The setup is bench.py's _train_bench: AdamW(3e-4, betas (0.9, 0.999),
# eps 1e-8, weight decay 1e-4 on every parameter, as optax.adamw decays
# every leaf) under warmup_cosine_decay_schedule(0, 3e-4, 100, 1000).
TRAIN_LR = 3e-4
TRAIN_STEPS = 3          # per entry point (eager loop, build_train_step)
TRAIN_FALL_STEPS = 10    # constant-lr steps on one fixed batch
TRAIN_FUSED_MICRO = 2    # micro-batches per build_train_step update
# flash vs plain attention (attention_impl="xla": mha_reference through
# autograd) on the same weights and batch, one forward + backward. Both
# keep activations in bf16 through 16 layers and round at different sites
# (the plain path rounds p after normalising and its dP / dS products to
# bf16; the kernels keep dP and dS in fp32 until dS is rounded once).
# This script read 1.04e-5 (loss) and 6.46e-6 (grad norm) relative on an
# NVIDIA H100 80GB HBM3 at 700 W; the limits leave ~10x and ~150x of that.
# The grad-norm limit is shown to bite: the same step with the dQ
# kernel's dQ, or the dK/dV kernel's dK or dV, zeroed must land beyond it
# (train_control below)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_NORM_RTOL = 1e-3
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
FLASH_KERNELS_F16 = tuple(name + "_f16" for name in FLASH_KERNELS)
# the kernels whose SASS must hold wgmma (HGMMA) and TMA tile loads (UTMALDG)
TENSOR_CORE_KERNELS = FLASH_KERNELS + FLASH_KERNELS_F16 + tuple(
    name + sfx for name in ("ragged_prefill", "ragged_prefill_quant") for sfx in DTYPE_MANGLED)


def train_path(dev, card: str):
    """Train small_1b at full width through both entry points of the
    port's Accelerator. Returns the flash kernels' launches on this path."""
    import dataclasses

    import numpy as np
    import torch

    from accelerate_tpu_torch import Accelerator, warmup_cosine_decay_schedule
    from accelerate_tpu_torch.accelerator import global_grad_norm
    from accelerate_tpu_torch.models.configs import DecoderConfig
    from accelerate_tpu_torch.models.convert import random_params
    from accelerate_tpu_torch.models.decoder import DecoderLM
    from accelerate_tpu_torch.ops import kernels

    cfg = DecoderConfig.small_1b()
    b, s = TRAIN_B, TRAIN_S
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (b, s))
    batch = {"input_ids": ids, "labels": ids}


    def loss_and_norm(model):
        """One forward + backward on the fixed batch, no update."""
        acc = Accelerator(mixed_precision="bf16")
        acc.prepare(model)
        model.zero_grad(set_to_none=True)  # a fused step leaves its gradients
        out = model(**{k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
        out["loss"].backward()
        norm = global_grad_norm(model.parameters()).item()
        model.zero_grad(set_to_none=True)
        return out["loss"].item(), norm

    t0 = time.perf_counter()
    model = DecoderLM(cfg, device=dev, param_dtype=torch.float32)
    model.load_params(random_params(cfg, seed=0, device=dev, dtype=torch.float32))
    torch.cuda.synchronize()
    print(f"train path: small_1b ({cfg.num_layers} layers, E {cfg.embed_dim}, H "
          f"{cfg.num_heads}, KVH {cfg.num_kv_heads}, D {cfg.head_dim}, vocab "
          f"{cfg.vocab_size}, {cfg.num_params / 1e9:.3f}B params), fp32 masters seed 0, "
          f"bf16 compute, remat {cfg.remat_policy}, batch {b} x {s}, built in "
          f"{time.perf_counter() - t0:.1f} s")

    acc = Accelerator(mixed_precision="bf16")
    opt = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, warmup_cosine_decay_schedule(0.0, TRAIN_LR, 100, 1000))
    model, opt, sched, loader = acc.prepare(model, opt, sched, [batch] * TRAIN_STEPS)

    def expect(before, per_kernel, what):
        for name in FLASH_KERNELS:
            got = kernels.launch_counts[name] - before[name]
            if got != per_kernel:
                fail(f"{name}: {got} launches in {what}, expected {per_kernel}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, eager_ms = [], []
    for mb in loader:  # the eager loop
        before = dict(kernels.launch_counts)
        t0 = time.perf_counter()
        with acc.accumulate(model):
            loss = model(**mb)["loss"]
            acc.backward(loss)
            acc.clip_grad_norm_(max_norm=1.0)
            opt.step()
            sched.step()
            opt.zero_grad()
        losses.append(loss.item())
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        expect(before, cfg.num_layers, "one eager step (one micro-batch)")
    step = acc.build_train_step(micro_steps=TRAIN_FUSED_MICRO)
    fused_ms, norms = [], []
    for _ in range(TRAIN_STEPS):
        before = dict(kernels.launch_counts)
        t0 = time.perf_counter()
        m = step(batch)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        fused_ms.append((time.perf_counter() - t0) * 1e3)
        expect(before, cfg.num_layers * TRAIN_FUSED_MICRO,
               f"one build_train_step step ({TRAIN_FUSED_MICRO} micro-batches)")
    torch.cuda.synchronize()
    launches = {name: kernels.launch_counts[name] for name in FLASH_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses + norms):
        fail(f"non-finite training loss or grad norm: {losses}, {norms}")
    print(f"train path: eager losses {[round(x, 5) for x in losses[:TRAIN_STEPS]]}, "
          f"build_train_step losses {[round(x, 5) for x in losses[TRAIN_STEPS:]]}, grad "
          f"norms {[round(x, 5) for x in norms]}, lr now {sched.get_last_lr()[0]:.3e}, "
          f"launches {launches}")

    # throughput: the steady build_train_step steps (the first one warms up)
    step_ms = sorted(fused_ms[1:])[len(fused_ms[1:]) // 2]
    tokens_per_s = b * s / (step_ms / 1e3)
    flops_per_token = 6 * cfg.num_params + 6 * cfg.num_layers * s * cfg.embed_dim
    mfu = tokens_per_s * flops_per_token / BF16_FLOPS_PER_S
    print(f"train path on {card}: {tokens_per_s:.1f} tokens/s, {step_ms:.1f} ms/step "
          f"(median of steady build_train_step steps {[round(x, 1) for x in fused_ms]}; "
          f"eager steps {[round(x, 1) for x in eager_ms]} ms), MFU {100 * mfu:.2f}% "
          f"({flops_per_token / 1e9:.3f} GFLOP/token over 989 TFLOP/s bf16), peak memory "
          f"{peak_gb:.2f} GB")

    # the loss falls: constant lr on the one fixed batch, from the seed weights
    model.load_params(random_params(cfg, seed=0, device=dev, dtype=torch.float32))
    acc = Accelerator(mixed_precision="bf16")
    opt = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    model, opt = acc.prepare(model, opt)
    step = acc.build_train_step()
    curve = [step(batch)["loss"].item() for _ in range(TRAIN_FALL_STEPS)]
    if not all(math.isfinite(x) for x in curve) or not curve[-1] < curve[0]:
        fail(f"the loss did not fall over {TRAIN_FALL_STEPS} steps at lr {TRAIN_LR}: {curve}")
    print(f"train path: {TRAIN_FALL_STEPS} steps at constant lr {TRAIN_LR} on one batch: "
          f"loss {[round(x, 4) for x in curve]}")

    # held against plain attention on the trained weights (at the seed
    # weights attention barely moves the loss): same weights, same batch
    loss_f, norm_f = loss_and_norm(model)
    plain = DecoderLM(dataclasses.replace(cfg, attention_impl="xla"), device=dev,
                      param_dtype=torch.float32)
    plain.load_state_dict(model.state_dict())
    loss_x, norm_x = loss_and_norm(plain)
    del plain
    if not (math.isfinite(loss_f) and math.isfinite(norm_f)):
        fail(f"flash step: loss {loss_f}, grad norm {norm_f}")
    if abs(loss_f - loss_x) > TRAIN_LOSS_RTOL * abs(loss_x):
        fail(f"flash loss {loss_f} vs plain attention {loss_x}: beyond {TRAIN_LOSS_RTOL} rel")
    if abs(norm_f - norm_x) > TRAIN_GRAD_NORM_RTOL * abs(norm_x):
        fail(f"flash grad norm {norm_f} vs plain attention {norm_x}: beyond "
             f"{TRAIN_GRAD_NORM_RTOL} rel")
    print(f"train path: one step vs plain attention (after the {TRAIN_FALL_STEPS} steps): "
          f"loss {loss_f:.6f} vs {loss_x:.6f} (rel {abs(loss_f - loss_x) / abs(loss_x):.2e}, "
          f"tol {TRAIN_LOSS_RTOL}), grad norm {norm_f:.6f} vs {norm_x:.6f} (rel "
          f"{abs(norm_f - norm_x) / abs(norm_x):.2e}, tol {TRAIN_GRAD_NORM_RTOL})")
    train_control(model, loss_and_norm, norm_x)
    profile_train(step, batch, card)
    del model, opt, acc, step
    remat_memory(cfg, dev, batch)
    return launches


def train_control(model, loss_and_norm, norm_plain, label: str = "train path"):
    """The grad-norm check against plain attention must see a broken
    backward in each kernel: the same step with dQ zeroed after the dQ
    kernel, and with dK or dV zeroed after the dK/dV kernel (a gradient
    dropped inside the autograd Function), has to land beyond its limit."""
    from unittest import mock

    import torch

    from accelerate_tpu_torch.ops import kernels

    real_dkv = kernels.flash_bwd_dkv

    def dk_zeroed(*args):
        dk, dv = real_dkv(*args)
        return torch.zeros_like(dk), dv

    def dv_zeroed(*args):
        dk, dv = real_dkv(*args)
        return dk, torch.zeros_like(dv)

    for what, name, broken in (("dQ", "flash_bwd_dq", zeroed(kernels.flash_bwd_dq)),
                               ("dK", "flash_bwd_dkv", dk_zeroed),
                               ("dV", "flash_bwd_dkv", dv_zeroed)):
        with mock.patch.object(kernels, name, broken):
            _, norm_c = loss_and_norm(model)
        rel = abs(norm_c - norm_plain) / abs(norm_plain)
        if not rel > TRAIN_GRAD_NORM_RTOL:
            fail(f"control: with {what} zeroed the grad norm {norm_c} is within "
                 f"{TRAIN_GRAD_NORM_RTOL} rel of plain attention's {norm_plain}: the check "
                 "is blind")
        print(f"{label}: control, {what} zeroed in the flash backward: grad norm "
              f"{norm_c:.6f} vs plain {norm_plain:.6f} (rel {rel:.2e}, beyond tol "
              f"{TRAIN_GRAD_NORM_RTOL})")


def remat_memory(cfg, dev, batch):
    """One forward + backward under each remat policy: the peak memory
    above the weights and the flash forward launches (save_attention
    keeps the flash operator's out and lse, full and save_dots re-run it
    in backward)."""
    import dataclasses

    import torch

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models.convert import random_params
    from accelerate_tpu_torch.models.decoder import DecoderLM
    from accelerate_tpu_torch.ops import kernels

    for policy in ("save_attention", "full", "save_dots"):
        config = dataclasses.replace(cfg, remat_policy=policy)
        model = DecoderLM(config, device=dev, param_dtype=torch.float32)
        model.load_params(random_params(config, seed=0, device=dev, dtype=torch.float32))
        Accelerator(mixed_precision="bf16").prepare(model)
        inputs = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = kernels.launch_counts["flash_fwd"]
        model(**inputs)["loss"].backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        fwd = kernels.launch_counts["flash_fwd"] - before
        print(f"remat {policy}: one forward + backward at batch {TRAIN_B} x {TRAIN_S}: "
              f"peak {peak / 1e9:.3f} GB above the weights, {fwd} flash forward launches")
        del model
        torch.cuda.empty_cache()


def profile_train(step, batch, card: str, what: str = "one build_train_step step"):
    """Where a training step's time goes: torch.profiler over one
    build_train_step call (``what`` names it). Prints the device-busy
    share of the wall and the kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, rows = device_time(prof)
    if not rows:
        print("train profile: the profiler recorded no device time (not measured)")
        return
    print(f"train profile on {card}: {what}: wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% of wall, idle "
          f"{100 - 100 * busy_ms / wall_ms:.1f}%), {sum(r[1] for r in rows)} device ops")
    for ms, count, key in rows[:10]:
        print(f"  {ms:9.2f} ms  {count:5d} calls  {key[:90]}")


# fp16 training (train_fp16_path): small_1b at full width with fp16
# activations over fp32 masters, the reference's dynamic loss scale, the
# fp16 entries of the three flash kernels. The plain-attention check keeps
# the bf16 path's limits: fp16 rounds 8x finer than bf16 (2^-11 against
# 2^-8), so the two fp16 runs should agree at least as closely
FP16_OVERFLOW_B = 2            # batch of the forced-overflow walk
FP16_OVERFLOW_SCALE = 2.0 ** 40  # an init_scale whose first updates overflow fp16
FP16_OVERFLOW_MAX = 48         # updates the walk may take to reach a finite one
FP16_OVERFLOW_GROWTH = 2       # growth_interval of that walk: growth shows in it
FP16_DROPOUT = 0.1
# remat with dropout: each policy's gradients against no remat's, as the
# norm of the difference over the norm (the recompute repeats the ops and
# the masks; a mask drawn afresh moves ~10% of every dropped activation)
FP16_REMAT_GRAD_RTOL = 1e-3
FP16_MFU_RTOL = 0.05           # sys/mfu_pct against the phase's own reckoning
FP16_TELEMETRY_STEPS = 4


def train_fp16_path(dev, card: str):
    """fp16 training of small_1b at full width (``DecoderConfig(dtype=
    float16)``, ``mixed_precision="fp16"``, remat ``save_attention``):
    (b) the eager loop and ``build_train_step`` on the fp16 flash entries
    (and no bf16 launch), loss and grad norm against plain fp16 attention
    with the three zeroed controls, a forced overflow whose skipped
    updates leave every parameter bitwise unchanged and whose scale walk
    equals a host replay of the reference's rule, a falling loss; (c)
    dropout 0.1 under no remat, ``full``, ``save_attention`` and
    ``save_dots``: two runs from one seed equal bit for bit, each policy's
    gradients against no remat's, peak memory and flash forward launches;
    (d) telemetry through a JSONL tracker. Returns the fp16 entries'
    launches of the main run (b)."""
    import dataclasses

    import numpy as np
    import torch

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.accelerator import _unscale, global_grad_norm
    from accelerate_tpu_torch.models.configs import DecoderConfig
    from accelerate_tpu_torch.models.convert import random_params
    from accelerate_tpu_torch.models.decoder import DecoderLM
    from accelerate_tpu_torch.ops import kernels

    cfg = DecoderConfig.small_1b(dtype=torch.float16)
    b, s = TRAIN_B, TRAIN_S
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (b, s))
    batch = {"input_ids": ids, "labels": ids}
    on_dev = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    every = FLASH_KERNELS + FLASH_KERNELS_F16

    def fresh(config=cfg, seed=0):
        model = DecoderLM(config, device=dev, param_dtype=torch.float32)
        return model.load_params(random_params(config, seed=seed, device=dev,
                                               dtype=torch.float32))

    def expect(before, per_kernel, what):
        for name in every:
            want = per_kernel if name in FLASH_KERNELS_F16 else 0
            got = kernels.launch_counts[name] - before[name]
            if got != want:
                fail(f"{name}: {got} launches in {what}, expected {want}")

    def loss_and_norm(model):
        """One fp16 forward + backward on the fixed batch, no update. The
        backward is the accelerator's, from loss x 65536 (the default
        init scale): unscaled, an fp16 activation gradient of a mean over
        16384 tokens underflows, differently in the two attentions."""
        acc = Accelerator(mixed_precision="fp16")
        acc.prepare(model)
        model.zero_grad(set_to_none=True)
        out = model(**on_dev)
        acc.backward(out["loss"])
        if not bool(acc._finite.item()):
            fail("fp16 check step: a gradient is not finite at the default scale")
        norm = global_grad_norm(model.parameters()).item()
        model.zero_grad(set_to_none=True)
        return out["loss"].item(), norm

    # (b) the eager loop, then build_train_step
    t0 = time.perf_counter()
    model = fresh()
    acc = Accelerator(mixed_precision="fp16")
    opt = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    model, opt, loader = acc.prepare(model, opt, [batch] * TRAIN_STEPS)
    torch.cuda.synchronize()
    print(f"train fp16 path: small_1b fp16 activations over fp32 masters seed 0, remat "
          f"{cfg.remat_policy}, batch {b} x {s}, loss scale {acc.loss_scale.state_dict()}, "
          f"built in {time.perf_counter() - t0:.1f} s")
    kernels.reset_launch_counts()
    losses, eager_ms, finite_ms = [], [], []
    for mb in loader:
        before = dict(kernels.launch_counts)
        t0 = time.perf_counter()
        with acc.accumulate(model):
            loss = model(**mb)["loss"]
            acc.backward(loss)
            acc.clip_grad_norm_(max_norm=1.0)
            torch.cuda.synchronize()
            # what loss scaling adds to an update, timed alone: the
            # unscale's pass over every gradient, the finite check and
            # the flag's host read (here dividing by 1: values unchanged)
            t1 = time.perf_counter()
            _unscale([p.grad for p in model.parameters() if p.grad is not None], 1.0).item()
            finite_ms.append((time.perf_counter() - t1) * 1e3)
            opt.step()
            opt.zero_grad()
        losses.append(loss.item())
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        expect(before, cfg.num_layers, "one fp16 eager step (one micro-batch)")
    step = acc.build_train_step(micro_steps=TRAIN_FUSED_MICRO)
    fused_ms, norms = [], []
    for _ in range(TRAIN_STEPS):
        before = dict(kernels.launch_counts)
        t0 = time.perf_counter()
        m = step(batch)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        fused_ms.append((time.perf_counter() - t0) * 1e3)
        expect(before, cfg.num_layers * TRAIN_FUSED_MICRO,
               f"one fp16 build_train_step step ({TRAIN_FUSED_MICRO} micro-batches)")
    torch.cuda.synchronize()
    launches = {name: kernels.launch_counts[name] for name in FLASH_KERNELS_F16}
    if not all(math.isfinite(x) for x in losses + norms) or acc.optimizer_step_was_skipped:
        fail(f"fp16 training: losses {losses}, grad norms {norms}, last update skipped "
             f"{acc.optimizer_step_was_skipped}")
    step_ms = sorted(fused_ms[1:])[len(fused_ms[1:]) // 2]
    flops_per_token = 6 * cfg.num_params + 6 * cfg.num_layers * s * cfg.embed_dim
    mfu = b * s / (step_ms / 1e3) * flops_per_token / BF16_FLOPS_PER_S
    print(f"train fp16 path on {card}: eager losses {[round(x, 5) for x in losses[:TRAIN_STEPS]]}, "
          f"build_train_step losses {[round(x, 5) for x in losses[TRAIN_STEPS:]]}, grad norms "
          f"{[round(x, 5) for x in norms]}, loss scale {acc.loss_scale.state_dict()}, "
          f"launches {launches}; {b * s / (step_ms / 1e3):.1f} tokens/s, {step_ms:.1f} ms/step "
          f"(build_train_step {[round(x, 1) for x in fused_ms]}, eager "
          f"{[round(x, 1) for x in eager_ms]} ms), MFU {100 * mfu:.2f}% (989 TFLOP/s fp16); "
          f"unscale + finite check + host read of the flag "
          f"{[round(x, 2) for x in finite_ms]} ms an update (after a synchronize)")
    print("train fp16 path: the profile of one fp16 build_train_step step "
          f"({TRAIN_FUSED_MICRO} micro-batches), beside the bf16 one of the train path:")
    profile_train(step, batch, card)

    # the loss falls: constant lr on the one fixed batch
    model.load_params(random_params(cfg, seed=0, device=dev, dtype=torch.float32))
    acc = Accelerator(mixed_precision="fp16")
    opt = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    model, opt = acc.prepare(model, opt)
    step = acc.build_train_step()
    curve = [step(batch)["loss"].item() for _ in range(TRAIN_FALL_STEPS)]
    if not all(math.isfinite(x) for x in curve) or not curve[-1] < curve[0]:
        fail(f"fp16: the loss did not fall over {TRAIN_FALL_STEPS} steps: {curve}")
    print(f"train fp16 path: {TRAIN_FALL_STEPS} steps at constant lr {TRAIN_LR} on one batch: "
          f"loss {[round(x, 4) for x in curve]}, loss scale {acc.loss_scale.state_dict()}")

    # against plain fp16 attention on the trained weights, and the controls
    loss_f, norm_f = loss_and_norm(model)
    plain = DecoderLM(dataclasses.replace(cfg, attention_impl="xla"), device=dev,
                      param_dtype=torch.float32)
    plain.load_state_dict(model.state_dict())
    loss_x, norm_x = loss_and_norm(plain)
    del plain
    if not (math.isfinite(loss_f) and math.isfinite(norm_f)):
        fail(f"fp16 flash step: loss {loss_f}, grad norm {norm_f}")
    if abs(loss_f - loss_x) > TRAIN_LOSS_RTOL * abs(loss_x):
        fail(f"fp16 flash loss {loss_f} vs plain attention {loss_x}: beyond {TRAIN_LOSS_RTOL}")
    if abs(norm_f - norm_x) > TRAIN_GRAD_NORM_RTOL * abs(norm_x):
        fail(f"fp16 flash grad norm {norm_f} vs plain attention {norm_x}: beyond "
             f"{TRAIN_GRAD_NORM_RTOL} rel")
    print(f"train fp16 path: one step vs plain fp16 attention: loss {loss_f:.6f} vs "
          f"{loss_x:.6f} (rel {abs(loss_f - loss_x) / abs(loss_x):.2e}, tol {TRAIN_LOSS_RTOL}), "
          f"grad norm {norm_f:.6f} vs {norm_x:.6f} (rel {abs(norm_f - norm_x) / abs(norm_x):.2e}, "
          f"tol {TRAIN_GRAD_NORM_RTOL})")
    before = dict(kernels.launch_counts)
    train_control(model, loss_and_norm, norm_x)
    if any(kernels.launch_counts[n] != before[n] for n in FLASH_KERNELS):
        fail("fp16 controls launched a bf16 flash entry")
    del model, opt, acc, step
    torch.cuda.empty_cache()

    fp16_overflow_walk(dev, cfg, batch)
    fp16_dropout_remat(dev, cfg, on_dev)
    fp16_telemetry(dev, cfg, batch, card)
    return launches


def fp16_overflow_walk(dev, cfg, batch):
    """From an init_scale whose updates overflow fp16: every skipped
    update leaves every parameter (and the optimizer's state) bitwise
    where it was, the scale and growth tracker after each update equal a
    host replay of the reference's rule over the observed skips, and the
    walk reaches finite updates and grows the scale."""
    import torch

    from accelerate_tpu_torch import Accelerator, GradScalerKwargs, LossScale
    from accelerate_tpu_torch.models.convert import random_params
    from accelerate_tpu_torch.models.decoder import DecoderLM

    mb = {k: torch.as_tensor(v[:FP16_OVERFLOW_B], device=dev) for k, v in batch.items()}
    model = DecoderLM(cfg, device=dev, param_dtype=torch.float32)
    model.load_params(random_params(cfg, seed=0, device=dev, dtype=torch.float32))
    rule = GradScalerKwargs(init_scale=FP16_OVERFLOW_SCALE, growth_interval=FP16_OVERFLOW_GROWTH)
    acc = Accelerator(mixed_precision="fp16", kwargs_handlers=[rule])
    opt = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR)
    model, opt = acc.prepare(model, opt)
    replay = LossScale(rule)
    walk, applied = [], 0
    for i in range(FP16_OVERFLOW_MAX):
        snap = [p.detach().clone() for p in model.parameters()]
        acc.backward(model(**mb)["loss"])
        opt.step()
        opt.zero_grad()
        skipped = acc.optimizer_step_was_skipped
        replay.update(not skipped)
        same = all(torch.equal(p, q) for p, q in zip(model.parameters(), snap))
        if skipped and not same:
            fail(f"overflow walk: update {i} was skipped but a parameter moved")
        if not skipped and same:
            fail(f"overflow walk: update {i} was applied but no parameter moved")
        if acc.loss_scale.state_dict() != replay.state_dict():
            fail(f"overflow walk: scale {acc.loss_scale.state_dict()} after update {i}, the "
                 f"reference's rule gives {replay.state_dict()}")
        walk.append((int(skipped), acc.loss_scale.scale, acc.loss_scale.growth_tracker))
        applied += not skipped
        if applied >= 2 * FP16_OVERFLOW_GROWTH + 1:
            break
        del snap
    skips = sum(w[0] for w in walk)
    if not skips or walk[0][0] != 1:
        fail(f"overflow walk: init_scale {FP16_OVERFLOW_SCALE} did not overflow: {walk}")
    if applied < 2 * FP16_OVERFLOW_GROWTH + 1:
        fail(f"overflow walk: no finite update within {FP16_OVERFLOW_MAX}: {walk}")
    if not any(w[1] > v[1] for v, w in zip(walk, walk[1:])):
        fail(f"overflow walk: the scale never grew after finite updates: {walk}")
    print(f"train fp16 path: overflow walk from init_scale 2^{math.log2(FP16_OVERFLOW_SCALE):.0f} "
          f"at batch {FP16_OVERFLOW_B} x {TRAIN_S}: {skips} skipped updates (parameters bitwise "
          f"unchanged), then {applied} applied; (skipped, scale, growth tracker) per update "
          f"{walk}, equal to the host replay of the reference's rule")
    del model, opt, acc
    torch.cuda.empty_cache()


def fp16_dropout_remat(dev, cfg, on_dev):
    """Dropout 0.1 in fp16 at B 8 x 2048 under no remat and each policy:
    one forward + backward from one seed each (twice for save_attention:
    equal bit for bit), gradients against no remat's, peak memory above
    the weights and flash forward launches."""
    import dataclasses

    import torch

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models.convert import random_params
    from accelerate_tpu_torch.models.decoder import DecoderLM
    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.utils.random import set_seed

    base_grads, results = None, {}
    for policy, runs in ((None, 1), ("full", 1), ("save_attention", 2), ("save_dots", 1)):
        config = dataclasses.replace(cfg, dropout_rate=FP16_DROPOUT, remat=policy is not None,
                                     remat_policy=policy or "full")
        model = DecoderLM(config, device=dev, param_dtype=torch.float32)
        model.load_params(random_params(config, seed=0, device=dev, dtype=torch.float32))
        acc = Accelerator(mixed_precision="fp16")  # backward from loss x 65536
        acc.prepare(model)
        losses = []
        for _ in range(runs):
            model.zero_grad(set_to_none=True)
            set_seed(0)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fwd = kernels.launch_counts["flash_fwd_f16"]
            loss = model(**on_dev)["loss"]
            acc.backward(loss)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            fwd = kernels.launch_counts["flash_fwd_f16"] - fwd
            losses.append(loss.item())
        if len(set(losses)) != 1:
            fail(f"dropout {FP16_DROPOUT} remat {policy}: two runs from one seed gave losses "
                 f"{losses}")
        grads = [p.grad.detach().clone() for p in model.parameters()]
        if base_grads is None:
            base_grads, rel = grads, 0.0
        else:
            diff = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g - g0) for g, g0 in zip(grads, base_grads)]))
            ref = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g0) for g0 in base_grads]))
            rel = (diff / ref).item()
            if not rel <= FP16_REMAT_GRAD_RTOL:
                fail(f"dropout {FP16_DROPOUT} remat {policy}: gradients {rel:.2e} (relative "
                     f"norm of the difference) from no remat's, beyond {FP16_REMAT_GRAD_RTOL}")
        results[policy or "none"] = (losses[0], peak, fwd, rel)
        print(f"remat {policy or 'none'} fp16, dropout {FP16_DROPOUT}: one forward + backward at "
              f"batch {TRAIN_B} x {TRAIN_S}: loss {losses[0]:.6f} (runs from one seed: "
              f"{len(losses)}, equal bit for bit), gradients {rel:.2e} from no remat's (tol "
              f"{FP16_REMAT_GRAD_RTOL}), peak {peak / 1e9:.3f} GB above the weights, {fwd} "
              f"flash_fwd_f16 launches")
        del model, grads, acc
        torch.cuda.empty_cache()
    del base_grads
    torch.cuda.empty_cache()
    return results


def fp16_telemetry(dev, cfg, batch, card: str):
    """build_train_step in fp16 with a telemetry session and a JSONL
    tracker, log_system_metrics after each update: sys/mfu_pct within
    FP16_MFU_RTOL of this phase's own reckoning over the same steps, the
    loss scale and skipped flag equal to the accelerator's, the series in
    prometheus_metrics(), every metrics.jsonl line parsed."""
    import json as _json
    import shutil
    import tempfile

    import torch

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models.convert import random_params
    from accelerate_tpu_torch.models.decoder import DecoderLM
    from accelerate_tpu_torch.telemetry import TelemetryConfig

    tmp = tempfile.mkdtemp(prefix="chip_fp16_telemetry_")
    try:
        model = DecoderLM(cfg, device=dev, param_dtype=torch.float32)
        model.load_params(random_params(cfg, seed=0, device=dev, dtype=torch.float32))
        acc = Accelerator(mixed_precision="fp16", project_dir=tmp, log_with="jsonl",
                          telemetry=TelemetryConfig(trace_dir=tmp, flight_hooks=False,
                                                    timeline_interval_s=0,
                                                    window=FP16_TELEMETRY_STEPS))
        opt = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR)
        model, opt = acc.prepare(model, opt)
        acc.init_trackers("fp16", config={"lr": TRAIN_LR, "batch": TRAIN_B})
        step = acc.build_train_step()
        step(batch)  # warm-up, outside the window the rollup reads
        walls, values = [], {}
        for _ in range(FP16_TELEMETRY_STEPS):
            t0 = time.perf_counter()
            step(batch)
            walls.append(time.perf_counter() - t0)
            values = acc.log_system_metrics()
        fpt = 6 * cfg.num_params + 6 * cfg.num_layers * TRAIN_S * cfg.embed_dim
        own = 100.0 * TRAIN_B * TRAIN_S * fpt * FP16_TELEMETRY_STEPS / sum(walls) / BF16_FLOPS_PER_S
        got = values.get("sys/mfu_pct")
        if got is None or abs(got - own) > FP16_MFU_RTOL * own:
            fail(f"telemetry: sys/mfu_pct {got} vs this phase's {own:.3f} (rel tol "
                 f"{FP16_MFU_RTOL})")
        want = (acc.loss_scale.scale, acc.optimizer_step_was_skipped)
        if (values.get("sys/loss_scale"), values.get("sys/last_step_skipped")) != want:
            fail(f"telemetry: sys/loss_scale {values.get('sys/loss_scale')}, "
                 f"sys/last_step_skipped {values.get('sys/last_step_skipped')} vs the "
                 f"accelerator's {want}")
        text = acc.prometheus_metrics()
        for series in ("sys_mfu_pct", "sys_loss_scale", "sys_tokens_per_s", "sys_loss"):
            if series not in text:
                fail(f"telemetry: prometheus_metrics() has no {series} series")
        acc.end_training()
        lines = open(f"{tmp}/fp16/metrics.jsonl").read().splitlines()
        parsed = [_json.loads(line) for line in lines]
        logged = [p for p in parsed if p.get("event") == "log"]
        if len(logged) != FP16_TELEMETRY_STEPS or parsed[0].get("event") != "config":
            fail(f"telemetry: metrics.jsonl holds {len(lines)} lines, {len(logged)} logs")
        print(f"train fp16 telemetry on {card}: sys/mfu_pct {got:.3f} vs this phase's "
              f"{own:.3f} over the same {FP16_TELEMETRY_STEPS} steps, sys/tokens_per_s "
              f"{values.get('sys/tokens_per_s'):.1f}, sys/loss {values.get('sys/loss'):.5f}, "
              f"sys/grad_norm {values.get('sys/grad_norm'):.5f}, sys/loss_scale "
              f"{values['sys/loss_scale']}, sys/last_step_skipped "
              f"{values['sys/last_step_skipped']}, sys/data_wait_frac "
              f"{values.get('sys/data_wait_frac'):.4f}; {len(lines)} metrics.jsonl lines "
              f"parsed; the exposition carries the series")
        del model, opt, acc, step
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


# the checkpoint path (training-checkpoint slice): small_1b trained as the
# training path trains it (bf16 over fp32 masters, B 8 x 2048, two
# micro-batches an update), over the port's shuffled DataLoader of 64
# sequences from seed 0: 8 micro-batches, 4 updates, an epoch. Run A saves
# after 2 and 3 updates (both mid-epoch) and trains 2 more, into the next
# epoch; run B resumes the second save from other weights
CKPT_SEQS = 64
CKPT_SAVES = (2, 1)      # updates before each of run A's saves
CKPT_RESUMED = 2         # updates after the last save (run A) or the load (B)
CKPT_LR_WARMUP, CKPT_LR_DECAY = 2, 10
CKPT_PROMPT, CKPT_NEW = 128, 8
CKPT_SHARD = "1GB"       # save_model's max_shard_size
CKPT_GOODPUT_RTOL = 0.05  # goodput's checkpoint seconds against the calls' walls


def dir_bytes(path, skip: tuple = ()) -> int:
    """Bytes of the files under ``path``, but those whose names start
    with one of ``skip``."""
    import os

    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files if not f.startswith(skip))


def checkpoint_path(dev, card: str):
    """Training checkpoints of small_1b at full width and depth on one card:

    (a) run A trains 2 updates, ``save_state()``, 1 update, ``save_state()``
        (``total_limit=1``: the second save deletes ``checkpoint_0`` before
        it writes ``checkpoint_1``), one CUDA draw, 2 more updates; run B,
        a fresh Accelerator over a model built from seed 1, loads the newest
        checkpoint (``load_state()``), draws, and trains 2 updates. Losses,
        learning rates, the draw and every parameter must equal run A's bit
        for bit (``torch.equal``), and each resumed micro-step launches the
        three flash kernels once per layer;
    (b) two controls, a resume without the optimizer file and one without
        the loader's position, must each end on other parameters;
    (c) ``save_model`` shards the trained weights (1 GB shards + index),
        ``load_flat_dict`` reads them into a fresh ``DecoderLM``, and greedy
        ``generate()`` of 8 tokens from a 128-token prompt gives the
        trained model's tokens.

    Prints the free disk, each save's and load's seconds, GB and GB/s (to
    and from the page cache: nothing is synced to the disk) and the
    checkpoint's and the export's sizes. Deletes what it wrote.

    (d) A telemetry session is armed around run A's last ``save_state()``
        and run B's ``load_state()``: its span file must hold one
        ``checkpoint/save`` and one ``checkpoint/restore`` span, and its
        goodput ledger's checkpoint seconds must equal the walls of the two
        ``save_accelerator_state`` / ``load_accelerator_state`` calls
        within CKPT_GOODPUT_RTOL."""
    import os
    import shutil
    import tempfile
    from unittest import mock

    import numpy as np
    import torch

    from accelerate_tpu_torch import (Accelerator, DataLoader, ProjectConfiguration, generate,
                                      warmup_cosine_decay_schedule)
    from accelerate_tpu_torch import checkpointing
    from accelerate_tpu_torch.data import DataLoaderShard
    from accelerate_tpu_torch.models.configs import DecoderConfig
    from accelerate_tpu_torch.models.convert import from_reference, random_params
    from accelerate_tpu_torch.models.decoder import DecoderLM
    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.telemetry import TelemetryConfig, TelemetrySession
    from accelerate_tpu_torch.telemetry.spans import load_chrome_trace
    from accelerate_tpu_torch.utils.serialization import load_flat_dict

    cfg = DecoderConfig.small_1b()
    seqs = np.random.RandomState(0).randint(0, cfg.vocab_size, (CKPT_SEQS, TRAIN_S))
    dataset = [{"input_ids": s, "labels": s} for s in seqs]
    work = tempfile.mkdtemp(prefix="checkpoint-")
    free = shutil.disk_usage(work).free
    state_gb = cfg.num_params * 4 * 3 / 1e9  # fp32 weights and two moments
    print(f"checkpoint path: {work}: {free / 1e9:.1f} GB of disk free (a checkpoint is "
          f"~{state_gb:.1f} GB, total_limit 1; the export ~{state_gb / 3:.1f} GB)")
    if free < 1.1 * state_gb * 4 / 3:  # the checkpoint and the export, at once
        fail(f"checkpoint path: {free / 1e9:.1f} GB of free disk in {work}")

    def build(seed):
        acc = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=2,
                          project_config=ProjectConfiguration(
                              project_dir=work, automatic_checkpoint_naming=True,
                              total_limit=1))
        model = DecoderLM(cfg, device=dev, param_dtype=torch.float32)
        model.load_params(random_params(cfg, seed=seed, device=dev, dtype=torch.float32))
        opt = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=1e-4)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, warmup_cosine_decay_schedule(
            0.0, TRAIN_LR, CKPT_LR_WARMUP, CKPT_LR_DECAY))
        loader = DataLoader(dataset, batch_size=TRAIN_B, shuffle=True, seed=0)
        return (acc, *acc.prepare(model, opt, sched, loader))

    def forever(loader):
        while True:
            yield from loader

    def train(run, batches, updates, counted=False):
        """The eager loop until ``updates`` updates closed; appends (loss,
        lr) per micro-step to ``run["record"]``."""
        acc, model, opt, sched = run["acc"], run["model"], run["opt"], run["sched"]
        for mb in batches:
            before = dict(kernels.launch_counts)
            with acc.accumulate(model):
                loss = model(**mb)["loss"]
                acc.backward(loss)
                acc.clip_grad_norm_(max_norm=1.0)
                opt.step()
                sched.step()
                opt.zero_grad()
            run["record"].append((loss.item(), sched.get_last_lr()[0]))
            if counted:
                for name in FLASH_KERNELS:
                    got = kernels.launch_counts[name] - before[name]
                    if got != cfg.num_layers:
                        fail(f"checkpoint path: {name} launched {got} times in a resumed "
                             f"micro-step, expected {cfg.num_layers}")
            if acc.sync_gradients:
                updates -= 1
                if updates == 0:
                    return

    def timed_io(what, fn, bytes_of):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        gb = bytes_of(out) / 1e9
        print(f"checkpoint path on {card}: {what}: {s:.2f} s, {gb:.3f} GB, {gb / s:.2f} GB/s")
        return out

    def host_params(model):
        return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}

    def resume(tag, patches=(), unread=()):
        """Run B (or a control): seed-1 weights, load_state(), a draw, the
        resumed updates. Returns its record, draw and parameters.
        ``unread``: the prefixes of the files the load does not read."""
        acc, model, opt, sched, loader = build(1)
        run = {"acc": acc, "model": model, "opt": opt, "sched": sched, "record": []}
        with contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            timed_io(f"{tag}: load_state()", acc.load_state,
                     lambda _: dir_bytes(newest, tuple(unread)))
        draw = torch.rand(4, device=dev)
        kernels.reset_launch_counts()
        train(run, forever(loader), CKPT_RESUMED, counted=not patches)
        return run["record"], draw, host_params(model), run

    try:
        t0 = time.perf_counter()
        acc, model, opt, sched, loader = build(0)
        run_a = {"acc": acc, "model": model, "opt": opt, "sched": sched, "record": []}
        print(f"checkpoint path: small_1b ({cfg.num_params / 1e9:.3f}B params), fp32 masters "
              f"seed 0, bf16 compute, batch {TRAIN_B} x {TRAIN_S}, accumulation 2, "
              f"{CKPT_SEQS} shuffled sequences (seed 0), built in "
              f"{time.perf_counter() - t0:.1f} s")
        batches = forever(loader)
        checkpoints = os.path.join(work, "checkpoints")
        # (d): the session and the walls of the checkpoint calls it sees
        trace_dir = os.path.join(work, "telemetry")
        session, walls = None, []
        real_calls = (checkpointing.save_accelerator_state,
                      checkpointing.load_accelerator_state)

        def walled(fn):
            def call(*args, **kw):
                t = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    walls.append((fn.__name__, time.perf_counter() - t))
            return call

        for i, updates in enumerate(CKPT_SAVES):
            train(run_a, batches, updates)
            if i == len(CKPT_SAVES) - 1:
                session = TelemetrySession(TelemetryConfig(trace_dir=trace_dir))
                checkpointing.save_accelerator_state, checkpointing.load_accelerator_state = \
                    (walled(f) for f in real_calls)
            path = timed_io(f"run A: save_state() {i}", acc.save_state, dir_bytes)
            kept = sorted(os.listdir(checkpoints))
            if kept != [f"checkpoint_{i}"]:
                fail(f"checkpoint path: after save {i} the project holds {kept}")
        newest = path
        state_bytes = dir_bytes(newest)
        draw_a = torch.rand(4, device=dev)
        saved = len(run_a["record"])
        train(run_a, batches, CKPT_RESUMED)
        record_a = run_a["record"][saved:]
        params_a = host_params(model)
        del batches, run_a, acc, model, opt, sched, loader
        gc.collect()
        torch.cuda.empty_cache()

        record_b, draw_b, params_b, run_b = resume("run B")
        checkpointing.save_accelerator_state, checkpointing.load_accelerator_state = real_calls
        billed = session.goodput.totals()["checkpoint"]
        session.close()
        spans = [e["name"] for e in
                 load_chrome_trace(os.path.join(trace_dir, "trace-host0.jsonl"))["traceEvents"]
                 if e.get("cat") == "phase"]
        called = sum(s for _, s in walls)
        if spans != ["checkpoint/save", "checkpoint/restore"] or \
                [n for n, _ in walls] != ["save_accelerator_state", "load_accelerator_state"]:
            fail(f"checkpoint path: phase spans {spans} for the calls {walls}")
        if not abs(billed - called) <= CKPT_GOODPUT_RTOL * called:
            fail(f"checkpoint path: goodput bills {billed:.4f} s of checkpoint, the calls took "
                 f"{called:.4f} s")
        print(f"checkpoint path on {card}: telemetry: spans {spans}; goodput checkpoint "
              f"{billed:.4f} s against the calls' {called:.4f} s "
              f"({[(n, round(s, 4)) for n, s in walls]}; {billed / called - 1:+.2e} relative)")
        if record_b != record_a:
            fail(f"checkpoint path: resumed (loss, lr) {record_b} != run A's {record_a}")
        if not torch.equal(draw_b, draw_a):
            fail(f"checkpoint path: resumed CUDA draw {draw_b.tolist()} != {draw_a.tolist()}")
        differ = [k for k in params_a if not torch.equal(params_a[k], params_b[k])]
        if differ:
            fail(f"checkpoint path: {len(differ)} parameters differ from run A's after the "
                 f"resume, e.g. {differ[:3]}")
        print(f"checkpoint path: run B resumed bit for bit: (loss, lr) per micro-step "
              f"{[(round(l, 6), f'{r:.3e}') for l, r in record_b]}, the CUDA draw and all "
              f"{len(params_b)} parameters equal run A's; flash launches "
              f"{ {n: kernels.launch_counts[n] for n in FLASH_KERNELS} } over "
              f"{len(record_b)} micro-steps ({cfg.num_layers} each a micro-step)")
        model_b = run_b["model"]
        del run_b
        gc.collect()

        real_find = checkpointing._find
        controls = {
            "no optimizer state": ([mock.patch.object(
                checkpointing, "_find",
                lambda folder, stem: None if stem.startswith("optimizer")
                else real_find(folder, stem))], ("optimizer",)),
            "no loader position": ([mock.patch.object(
                DataLoaderShard, "load_state_dict", lambda self, state: None)], ()),
        }
        for tag, (patches, unread) in controls.items():
            _, _, params_c, run_c = resume(f"control ({tag})", patches, unread)
            del run_c
            gc.collect()
            torch.cuda.empty_cache()
            differ = [k for k in params_a if not torch.equal(params_a[k], params_c[k])]
            if not differ:
                fail(f"checkpoint path: control ({tag}) ended on run A's parameters: the "
                     "bitwise check is blind to it")
            worst = max((params_a[k] - params_c[k]).abs().max().item() for k in differ)
            print(f"checkpoint path: control ({tag}): {len(differ)} of {len(params_a)} "
                  f"parameters differ from run A's (max |diff| {worst:.3e})")
        del params_a, params_b, params_c

        export = os.path.join(work, "export")
        acc = Accelerator(mixed_precision="bf16")
        timed_io(f"save_model(max_shard_size={CKPT_SHARD!r})",
                 lambda: acc.save_model(model_b, export, max_shard_size=CKPT_SHARD),
                 lambda _: dir_bytes(export))
        files = sorted(os.listdir(export))
        if "model.safetensors.index.json" not in files or len(files) < 3:
            fail(f"checkpoint path: the export holds {files}, not shards and an index")
        t = time.perf_counter()
        flat = load_flat_dict(os.path.join(export, "model.safetensors"))
        fresh = DecoderLM(cfg, device=dev, param_dtype=torch.float32)
        fresh.load_params(from_reference(
            {k[len("params/"):]: v for k, v in flat.items()}, cfg))
        fresh.set_param_cast(torch.bfloat16)
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        gb = dir_bytes(export) / 1e9
        print(f"checkpoint path on {card}: export read into a fresh DecoderLM: {s:.2f} s, "
              f"{gb:.3f} GB, {gb / s:.2f} GB/s; {len(files) - 1} shards + index")
        del flat
        prompt = torch.as_tensor(
            np.random.RandomState(1).randint(3, cfg.vocab_size, (1, CKPT_PROMPT)), device=dev)
        want = generate(model_b, prompt, max_new_tokens=CKPT_NEW)[:, CKPT_PROMPT:]
        kernels.reset_launch_counts()
        got = generate(fresh, prompt, max_new_tokens=CKPT_NEW)[:, CKPT_PROMPT:]
        torch.cuda.synchronize()
        decode = kernels.launch_counts["dense_decode"]
        if decode != cfg.num_layers * (CKPT_NEW - 1):
            fail(f"checkpoint path: generate() launched dense_decode {decode} times, expected "
                 f"{cfg.num_layers * (CKPT_NEW - 1)}")
        if not torch.equal(got, want):
            fail(f"checkpoint path: the export generates {got.tolist()}, the trained model "
                 f"{want.tolist()}")
        print(f"checkpoint path on {card}: the export's greedy tokens equal the trained "
              f"model's: {got.tolist()[0]} ({decode} dense decode launches); checkpoint "
              f"{state_bytes / 1e9:.3f} GB on disk, export {gb:.3f} GB")
        del fresh, model_b
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


# the generate path (generation slice): llama_7b at full width, random
# weights from seed 0, prompts of 512 tokens (a 128-multiple, so the
# whole-prompt prefill takes the flash forward kernel). Its depth is cut to
# GEN_LAYERS of the 32 layers (the dispatch path reuses the model): the two
# paths took 188 s of a 930 s run at 32 (NVIDIA H100 80GB HBM3, 700 W).
# Every gate and control holds at any depth; the per-token times and the
# weight-read bound scale with it
GEN_LAYERS = 8
GEN_PROMPT = 512
GEN_RUNS = (("bf16", 1, 64), ("int8", 4, 64), ("int4", 1, 32))  # (KV, batch, new)
GEN_BASE, GEN_EXTRA = 16, 48  # differential timing: both lengths right-size to L 768


class capture_logits:
    """Collect the logits every generate() step samples from: the
    prefill's last row through a forward hook on the model (its one call
    of more than one token; the decode body's warm-up and capture calls
    are single tokens), then each decode step's as its graph's replay
    leaves them in the graph's output buffer."""

    def __init__(self, model):
        self.model, self.rows = model, []

    def __enter__(self):
        from unittest import mock

        from accelerate_tpu_torch.utils import cuda_graphs

        def prefill_row(m, args, out):
            if args[0].shape[1] > 1:
                self.rows.append(out[:, -1].float().clone())

        real = cuda_graphs.CapturedStep.replay

        def replay(step):
            out = real(step)
            self.rows.append(out.float().clone())
            return out

        self.handle = self.model.register_forward_hook(prefill_row)
        self.patch = mock.patch.object(cuda_graphs.CapturedStep, "replay", replay)
        self.patch.start()
        return self

    def __exit__(self, *exc):
        self.patch.stop()
        self.handle.remove()

    def stacked(self):
        import torch

        return torch.stack(self.rows, dim=1)  # [B, new, V]


def token_gaps(logits, tokens):
    """``(worst gap, exact count)`` of ``tokens`` [B, new] under ``logits``
    [B, new, V]: how far each token sits below the argmax."""
    gap = logits.max(dim=-1).values - logits.gather(2, tokens[..., None])[..., 0]
    return gap.max().item(), int((gap == 0).sum().item())


def set_kv_cache_dtype(model, kv: str):
    """The same weights with another KV-cache storage: ``init_cache`` (and
    so generate()) takes the precision from the model's config, and no
    layer reads it otherwise."""
    import dataclasses

    model.config = dataclasses.replace(model.config, kv_cache_dtype=kv)


def generate_path(dev, card: str):
    """generate() on llama_7b at full width, GEN_LAYERS of its 32 layers:
    bf16 KV at B 1, int8 KV at B 4 and int4 KV at B 1, each call with the
    counts reset before it and read after it (a flash forward launch per
    layer for the prefill, layers x (new - 1) dense decode launches).
    Tokens and each step's logits are held against the cache-free plain
    forward (bf16) or against the same
    quantized run with the quantized kernel patched to its plain version;
    the bf16 check must fail with the decode kernel's output zeroed.
    Returns the dense decode kernels' launches on this path, and the model
    and the B 1 prompt (for the dispatch path)."""
    from unittest import mock

    import numpy as np
    import torch

    from accelerate_tpu_torch import generate
    from accelerate_tpu_torch.models.configs import DecoderConfig
    from accelerate_tpu_torch.models.convert import random_params
    from accelerate_tpu_torch.models.decoder import DecoderLM
    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.ops.attention import decode_attention_reference
    from accelerate_tpu_torch.utils import cuda_graphs

    cfg = DecoderConfig.llama_7b(num_layers=GEN_LAYERS)
    t0 = time.perf_counter()
    model = DecoderLM(cfg, device=dev)
    model.load_params(random_params(cfg, seed=0, device=dev))
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"generate path: llama_7b ({cfg.num_layers} of 32 layers, E {cfg.embed_dim}, H "
          f"{cfg.num_heads}, KVH {cfg.num_kv_heads}, D {cfg.head_dim}, M {cfg.mlp_dim}, vocab "
          f"{cfg.vocab_size}, untied head, {cfg.num_params / 1e9:.3f}B params, "
          f"{weight_bytes / 1e9:.2f} GB bf16), random weights seed 0, built in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(0)
    ids = {b: torch.as_tensor(rng.randint(3, cfg.vocab_size, (b, GEN_PROMPT)), device=dev)
           for b in (1, 4)}
    generate(model, ids[1][:, :128], max_new_tokens=4)  # warm-up, not counted

    def run(kv, b, new, check=True):
        """One generate() call: tokens [B, new], the logits they were
        sampled from (when checked; timed calls capture nothing), TTFT
        seconds, launches."""
        set_kv_cache_dtype(model, kv)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        cap = capture_logits(model) if check else contextlib.nullcontext()
        with cap:
            out, ttft = generate(model, ids[b], max_new_tokens=new, return_prefill_seconds=True)
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
        set_kv_cache_dtype(model, "bf16")
        decode = "dense_decode_quant" if kv != "bf16" else "dense_decode"
        want = {"flash_fwd": cfg.num_layers, decode: cfg.num_layers * (new - 1)}
        got = {k: n for k, n in launches.items() if n}
        if check and got != want:
            fail(f"generate ({kv} KV, B {b}, {new} new): launches {got}, expected {want}")
        return out[:, GEN_PROMPT:], cap.stacked() if check else None, ttft, launches

    def forced_plain_logits(kv, seq, new):
        """The logits of a cached run over ``seq`` [B, prompt + new] fed
        teacher-forced, with the quantized decode kernel patched to its
        plain version (dequantize, masked-dense read)."""
        def plain(q, k, v, k_scale, v_scale, pos, sm_scale, bits):
            return decode_attention_reference(q, k, v, pos, sm_scale, k_scale=k_scale,
                                              v_scale=v_scale, kv_quant_bits=bits)

        set_kv_cache_dtype(model, kv)
        cache = model.init_cache(seq.shape[0], GEN_CACHE)
        with mock.patch.object(kernels, "dense_decode_quant", plain), torch.no_grad():
            rows = [model(seq[:, :GEN_PROMPT], torch.arange(GEN_PROMPT, device=dev),
                          cache=cache)[:, -1]]
            for p in range(GEN_PROMPT, GEN_PROMPT + new - 1):
                rows.append(model(seq[:, p:p + 1], torch.arange(p, p + 1, device=dev),
                                  cache=cache, decode=True)[:, -1])
        set_kv_cache_dtype(model, "bf16")
        return torch.stack(rows, dim=1).float()

    def cache_free_logits(b, toks):
        with torch.no_grad():
            full = model(torch.cat([ids[b], toks], dim=1))
        return full[:, GEN_PROMPT - 1: GEN_PROMPT - 1 + toks.shape[1]]

    launches = {"dense_decode": 0, "dense_decode_quant": 0}
    for kv, b, new in GEN_RUNS:
        toks, logits, ttft, got = run(kv, b, new)
        if kv == "bf16":
            plain = cache_free_logits(b, toks)
            against = "the cache-free plain forward"
        else:
            plain = forced_plain_logits(kv, torch.cat([ids[b], toks], dim=1), new)
            against = f"the same {kv} run with the kernel's plain version"
        gap, exact = token_gaps(plain, toks)
        diff = (logits - plain).abs().max().item()
        if not math.isfinite(gap) or gap > TOP2_MARGIN:
            fail(f"generate ({kv} KV, B {b}): a token is {gap} logits below the argmax of "
                 f"{against} (margin {TOP2_MARGIN})")
        for name in launches:
            launches[name] += got.get(name, 0)
        print(f"generate ({kv} KV, B {b}, prompt {GEN_PROMPT}, {new} new, greedy): launches "
              f"{ {k: n for k, n in got.items() if n} }, TTFT (prefill) {ttft * 1e3:.2f} ms; "
              f"vs {against}: {exact}/{toks.numel()} tokens its argmax, worst gap "
              f"{gap:.4f} (margin {TOP2_MARGIN}), max |logit diff| {diff:.4f}")
        if kv == "bf16":
            with mock.patch.object(kernels, "dense_decode", zeroed(kernels.dense_decode)):
                ctoks, clogits, _, _ = run(kv, b, new)
            cgap, cexact = token_gaps(cache_free_logits(b, ctoks), ctoks)
            if not cgap > TOP2_MARGIN:
                fail(f"generate control: with the dense decode output zeroed every token is "
                     f"within {TOP2_MARGIN} of the plain argmax (worst {cgap}): the check "
                     "is blind")
            print(f"generate control (bf16, dense decode output zeroed): {cexact}/"
                  f"{ctoks.numel()} tokens the plain argmax, worst gap {cgap:.4f}: fails "
                  "the check")

    # decode ms/token by bench.py's differential method: (t[base + extra] -
    # t[base]) / extra cancels the prefill and per-call costs. Each call's
    # graph capture is a per-call cost too, but one that varies by more
    # than the 48 steps take (0.1-0.5 s a capture), so its own seconds
    # come off each call's wall first (as the reference's compiled loop,
    # cached across calls, stays out of bench.py's). Each length runs with
    # the decode step captured, as generate() runs it, and uncaptured:
    # this script hands generate() the step body in place of a graph, so
    # it calls the body every step. Each call's whole wall (prefill,
    # capture and decode) is printed too: what a caller of generate() waits
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    uncaptured = mock.patch.object(
        cuda_graphs, "capture",
        lambda body, device, restore=(): types.SimpleNamespace(replay=body))
    for kv, b in (("bf16", 1), ("int8", 4)):
        def call(new):
            """(whole wall, capture seconds) of one generate() call."""
            captures = len(CAPTURE_SECONDS)
            t0 = time.perf_counter()
            run(kv, b, new, check=False)
            return time.perf_counter() - t0, sum(CAPTURE_SECONDS[captures:])

        per_token, capture_s = {}, []
        for what, ctx in (("captured", contextlib.nullcontext()), ("uncaptured", uncaptured)):
            with ctx:
                pairs = [(call(GEN_BASE + GEN_EXTRA), call(GEN_BASE)) for _ in range(2)]
            diffs = [((long_w - long_c) - (short_w - short_c)) / GEN_EXTRA
                     for (long_w, long_c), (short_w, short_c) in pairs]
            capture_s += [c for pair in pairs for _, c in pair if c]
            ms = per_token[what] = 1e3 * sorted(diffs)[0]
            whole = {n: [round(1e3 * pair[i][0], 3) for pair in pairs]
                     for i, n in enumerate((GEN_BASE + GEN_EXTRA, GEN_BASE))}
            print(f"generate on {card} ({kv} KV, B {b}, decode step {what}): decode "
                  f"{ms:.3f} ms/token (differential over {GEN_EXTRA} tokens, best of "
                  f"{[round(1e3 * d, 3) for d in diffs]}), {b * 1e3 / ms:.1f} tokens/s; bound "
                  f"{bound_ms:.3f} ms/token (the {weight_bytes / 1e9:.2f} GB of weights read "
                  "once at 3.35 TB/s); whole calls (prefill, capture and decode) "
                  + ", ".join(f"{n} new tokens {w} ms" for n, w in whole.items()))
        saved_ms = per_token["uncaptured"] - per_token["captured"]
        capture_ms = 1e3 * sorted(capture_s)[len(capture_s) // 2]
        print(f"generate on {card} ({kv} KV, B {b}): a call's capture {capture_ms:.3f} ms "
              f"(median of {len(capture_s)} calls, two warm-up steps included), the graph "
              f"saves {saved_ms:.3f} ms/token: a call of fewer than "
              f"{1 + capture_ms / saved_ms:.1f} new tokens pays more for its capture than "
              "its graph saves")
    profile_generate(model, ids[1], card, "bf16")
    profile_generate(model, ids[4], card, "int8")
    return launches, {"model": model, "prompt": ids[1]}


def profile_generate(model, ids, card: str, kv: str, steps: int = PROFILE_STEPS):
    """Where a generate() decode step's time goes, with and without its
    CUDA graph: greedy steps of generate()'s decode body after a
    512-token prefill with a ``kv`` cache, timed alone and then again
    under torch.profiler (:func:`profiled`): ``UNCAPTURED_STEPS`` called
    directly (uncaptured), then ``steps`` replayed from its graph (what
    generate() runs).
    Prints each window's wall, device busy and idle share, and the
    kernels with the most device time of the graph's."""
    import functools

    import torch

    from accelerate_tpu_torch.generation import _decode_body
    from accelerate_tpu_torch.utils import cuda_graphs

    dev = ids.device
    b, s = ids.shape
    set_kv_cache_dtype(model, kv)
    with torch.no_grad():
        cache = model.init_cache(b, GEN_CACHE)
        tok = model(ids, torch.arange(s, device=dev), cache=cache)[:, -1].argmax(-1)
        pos = torch.full((b,), s, dtype=torch.long, device=dev)
        body = functools.partial(_decode_body, model, cache, tok, pos, True)
        out = torch.empty((b, 2 * (UNCAPTURED_STEPS + steps) + 1), dtype=torch.long,
                          device=dev)
        done = [0]

        def loop(step):
            def run():
                step()
                out[:, done[0]] = tok
                done[0] += 1
            return run

        loop(body)()  # one step outside the windows
        windows = [("uncaptured step body", UNCAPTURED_STEPS,
                    *profiled(loop(body), UNCAPTURED_STEPS))]
        graph = cuda_graphs.capture(body, dev, restore=(tok, pos))
        windows.append(("captured step", steps, *profiled(loop(graph.replay), steps)))
    set_kv_cache_dtype(model, "bf16")
    for what, n, wall_ms, traced_ms, busy_ms, rows in windows:
        print(f"generate profile on {card}: {kv} KV, B {b}, position ~{s}: "
              + window_text(what, n, wall_ms, traced_ms, busy_ms, rows))
    rows = windows[-1][-1]
    for ms, count, key in rows[:8]:
        print(f"  {ms / steps:8.3f} ms/step  {count // steps:4d}/step  {key[:90]}")
    decode_kernel_share(rows, steps, f"generate profile ({kv} KV)", "dense decode kernel #5")


DISPATCH_NEW = 8        # new tokens of each checked dispatched call
DISPATCH_EXTRA = 16     # extra tokens of the differential ms/token calls
DISPATCH_SHARD = 1 << 30  # the checkpoint's shard size: several shards and an index at 8 layers
DISPATCH_CONTROL_LAYER = 5  # the layer whose host-tier copies the control skips
H2D_PROBE_BYTES = 1 << 30


def h2d_gb_s(dev) -> float:
    """Pinned host -> device copy rate in GB/s: a 1 GiB copy, best of 3
    after one warm-up, CUDA events around each."""
    import torch

    host = torch.empty(H2D_PROBE_BYTES, dtype=torch.uint8, pin_memory=True)
    buf = torch.empty(H2D_PROBE_BYTES, dtype=torch.uint8, device=dev)
    buf.copy_(host, non_blocking=True)
    best = math.inf
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        buf.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    del host, buf
    return H2D_PROBE_BYTES / best / 1e6


def tier_bytes(params, device_map) -> dict:
    """Bytes of a dispatched tree per tier (packed tensors counted as they
    are stored)."""
    from accelerate_tpu_torch.utils.modeling import placement_of
    from accelerate_tpu_torch.utils.serialization import flatten_pytree

    out = {"device": 0, "cpu": 0, "disk": 0}
    for path, leaf in flatten_pytree(params).items():
        out[placement_of(path, device_map)] += math.prod(leaf.shape) * leaf.dtype.itemsize
    return out


def step_weight_bytes(params, cfg) -> int:
    """Weight bytes one B-1 decode step reads: each layer reads its own
    row of a stacked leaf (int4: the byte row it shares with its pair)
    and the whole scale of a quantized leaf (a stacked leaf's scale rows
    are shared by all layers: K = layers < group 128), the
    head its whole matrix, the embedding one row."""
    from accelerate_tpu_torch.models.convert import reference_leaves
    from accelerate_tpu_torch.utils.quantization import QuantizedWeight
    from accelerate_tpu_torch.utils.serialization import flatten_pytree

    def nbytes(t):
        return sum(math.prod(x.shape) * x.dtype.itemsize for x in flatten_pytree(t).values())

    total = 0
    for path, leaf in reference_leaves(params).items():
        if path == "embedding":
            total += cfg.embed_dim * leaf.dtype.itemsize
        elif not path.startswith("layers/"):
            total += nbytes(leaf)
        elif isinstance(leaf, QuantizedWeight):
            total += cfg.num_layers * (nbytes(leaf.data) // leaf.data.shape[0]
                                       + nbytes(leaf.scale))
        else:
            total += nbytes(leaf)
    return total


def dispatch_path(dev, card: str, gen: dict):
    """Big-model dispatch of llama_7b at full width (generate_path's
    GEN_LAYERS of its 32 layers) on one card:
    generate_path's random weights (seed 0) are streamed from the card to
    a checkpoint in the reference's format (stacked flat keys, bf16,
    sharded with an index) in a temporary directory, then loaded by
    ``load_checkpoint_and_dispatch`` and decoded by
    ``generate_dispatched`` in three cases, each call with the launch
    counts reset before it and read after it (a flash forward launch per
    layer, layers x (new - 1) dense decode):

    (a) every weight on the card ("auto"): tokens identical to
        ``generate()`` on the in-memory model; TTFT from the load's start
        to the first token, by phase;
    (b) three tiers under an explicit ``max_memory``: tokens identical to
        (a); peak device memory under the device-tier bytes, two layers of
        the blocks' host-tier bytes, the top-level host-tier leaves (staged
        whole) and (a)'s measured transient (the KV cache, activations,
        the decode graph's pool), printed as headroom in layers; ms/token beside the
        host-tier bytes over a measured pinned H2D rate; a control whose
        streamer skips one layer's copies must fail the token check;
    (c) int8 (group 128) and NF4 with double quantization on load: tokens
        identical to ``generate()`` on a ``DecoderLM`` loaded with
        ``dequantize_params`` of the same packed leaves; packed bytes,
        load phases, ms/token and the weight bytes a step reads.

    Each of (a), (b) and (c)'s int8 load is also served by the paged
    engine through ``ServingEngine.from_dispatched`` (2 requests x 8 new
    tokens, prompts of 512; one paged decode launch per layer a step and
    one ragged prefill launch per layer a dispatch): (a)'s tokens within
    TOP2_MARGIN of the cache-free plain forward of the same weights, (b)'s
    equal to (a)'s engine's bit for bit (the same weights, streamed), (c)'s
    within TOP2_MARGIN of the plain forward over the same quantized
    weights; ms/step beside (b)'s host-tier H2D bound.

    Returns the path's launches of the flash forward and dense decode
    kernels."""
    import os
    import shutil
    import tempfile
    from unittest import mock

    import torch

    from accelerate_tpu_torch import (QuantizationConfig, generate, generate_dispatched,
                                      init_empty_weights, load_checkpoint_and_dispatch)
    from accelerate_tpu_torch.serving.engine import ServingEngine
    from accelerate_tpu_torch.models.convert import export_reference_checkpoint, from_reference
    from accelerate_tpu_torch.models.decoder import DecoderLM, StreamedWeight
    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.utils.modeling import compute_module_sizes, placement_of
    from accelerate_tpu_torch.utils.quantization import dequantize_params, quantized_nbytes
    from accelerate_tpu_torch.utils.serialization import flatten_pytree, peek_flat_structs

    model, prompt = gen.pop("model"), gen.pop("prompt")
    cfg = model.config
    p_len = prompt.shape[1]
    tmp = tempfile.mkdtemp(prefix="dispatch-")
    launches = {"flash_fwd": 0, "dense_decode": 0}
    try:
        host_free = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_AVPHYS_PAGES")
        disk_free = shutil.disk_usage(tmp).free
        print(f"dispatch path: {tmp}: {disk_free / 1e9:.1f} GB of disk free, "
              f"{host_free / 1e9:.1f} GB of host memory available (the phase writes a "
              f"{cfg.num_params * 2 / 1e9:.1f} GB checkpoint and a disk-tier offload folder)")
        # the bf16 checkpoint, the disk tier's ~45% of it, and headroom
        need = 1.5 * cfg.num_params * 2
        if disk_free < need:
            fail(f"dispatch path: {disk_free / 1e9:.1f} GB of free disk in {tmp}; it needs "
                 f"{need / 1e9:.1f} GB")

        def counted(fn, *args, check=True, new=DISPATCH_NEW, **kw):
            """One call with the counts reset before and read after; the
            launches must be a flash forward a layer + layers x (new - 1) dense
            decode."""
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            got = {k: n for k, n in kernels.launch_counts.items() if n}
            want = {"flash_fwd": cfg.num_layers, "dense_decode": cfg.num_layers * (new - 1)}
            if check and got != want:
                fail(f"dispatch path: launches {got}, expected {want}")
            for k in launches:
                launches[k] += got.get(k, 0)
            return out

        want = counted(generate, model, prompt, max_new_tokens=DISPATCH_NEW)[:, p_len:]
        t0 = time.perf_counter()
        ckpt = os.path.join(tmp, "ckpt", "model.safetensors")
        files = export_reference_checkpoint(dict(model.state_dict()), cfg, ckpt,
                                            dtype=torch.bfloat16, max_shard_size=DISPATCH_SHARD)
        export_s = time.perf_counter() - t0
        structs = peek_flat_structs(ckpt)
        ckpt_bytes = sum(s.numel() * s.element_size() for s in structs.values())
        print(f"dispatch path: checkpoint of {len(structs)} stacked bf16 leaves "
              f"({ckpt_bytes / 1e9:.2f} GB) in {len(files)} file(s) (shards of at most "
              f"{DISPATCH_SHARD >> 30} GiB and an index when more than one), streamed from the "
              f"card layer slice by layer slice in {export_s:.1f} s")
        del model
        gc.collect()
        torch.cuda.empty_cache()

        def tokens(m, new=DISPATCH_NEW, prefill=False, check=True):
            out = counted(generate_dispatched, m, prompt, max_new_tokens=new, check=check,
                          new=new, return_prefill_seconds=prefill)
            if prefill:
                return out[0][:, p_len:], out[1]
            return out[:, p_len:]

        def ms_per_token(m):
            """Differential decode ms/token: (wall[new + extra] - wall[new])
            / extra, each call's capture seconds taken off its wall."""
            walls = []
            for new in (DISPATCH_NEW + DISPATCH_EXTRA, DISPATCH_NEW):
                captures = len(CAPTURE_SECONDS)
                t = time.perf_counter()
                tokens(m, new)
                walls.append(time.perf_counter() - t - sum(CAPTURE_SECONDS[captures:]))
            return 1e3 * (walls[0] - walls[1]) / DISPATCH_EXTRA

        def phases_text(m):
            return ", ".join(f"{k} {v:.2f} s" for k, v in m.phase_seconds.items())

        # the engine's requests: the path's prompt and its rotation by one
        engine_prompts = [prompt[0].cpu().numpy(), torch.roll(prompt[0], 1).cpu().numpy()]

        def serve(m, label):
            """The paged engine over ``m`` through from_dispatched: warmed
            up (its kernels built, its decode graph captured over the
            streamed weights), then the 2 requests with the counts reset
            just before and read just after. Returns (tokens, metrics)."""
            engine = ServingEngine.from_dispatched(m, num_slots=2, page_size=PAGE,
                                                   max_cache_len=2 * p_len,
                                                   prefill_chunks=(128, 512))
            try:
                engine.warmup()
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                reqs = [engine.submit(p, max_new_tokens=DISPATCH_NEW, seed=i)
                        for i, p in enumerate(engine_prompts)]
                engine.run()
                torch.cuda.synchronize()
                got = dict(kernels.launch_counts)
                expect_launches(f"dispatch {label} engine", got, {
                    "paged_decode": engine.step_count * cfg.num_layers,
                    "ragged_prefill": engine.prefill_dispatches * cfg.num_layers})
                if any(r.outcome != "finished" or len(r.tokens) != DISPATCH_NEW for r in reqs):
                    fail(f"dispatch {label} engine: a request did not finish its budget")
                metrics = engine.metrics()
            finally:
                engine.close()
            gap, exact, total = teacher_forced(m, reqs, DISPATCH_NEW, dev)
            if not math.isfinite(gap) or gap > TOP2_MARGIN:
                fail(f"dispatch {label} engine: a token is {gap} logits below the argmax of "
                     f"the plain forward over the same weights (margin {TOP2_MARGIN})")
            print(f"dispatch {label} engine on {card}: from_dispatched, paged, 2 requests x "
                  f"{DISPATCH_NEW} tokens (prompts of {p_len}), {metrics['serving/decode_steps']} "
                  f"decode steps, launches { {k: n for k, n in got.items() if n} }; vs the "
                  f"cache-free plain forward: {exact}/{total} tokens its argmax, worst gap "
                  f"{gap:.4f} (margin {TOP2_MARGIN}); TTFT p50 "
                  f"{metrics['serving/ttft_ms_p50']:.1f} ms, decode "
                  f"{metrics['serving/decode_step_ms_p50']:.3f} ms/step (p50)")
            return [list(r.tokens) for r in reqs], metrics

        # (a) all on the card
        t0 = time.perf_counter()
        m = load_checkpoint_and_dispatch(cfg, ckpt, device_map="auto", dtype=torch.bfloat16)
        load_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        got, prefill_s = tokens(m, prefill=True)
        # what a call allocates beyond the weights: (b)'s limit takes it
        transient = torch.cuda.max_memory_allocated() - before
        if set(m.device_map.values()) != {"device"}:
            fail(f"dispatch (a): 'auto' did not put every weight on the card: {m.device_map}")
        if not torch.equal(got, want):
            fail(f"dispatch (a): tokens {got.tolist()} differ from generate() on the "
                 f"in-memory model {want.tolist()}")
        all_ms = ms_per_token(m)
        print(f"dispatch (a) on {card}: all on the card, map {m.device_map}; {DISPATCH_NEW} "
              f"tokens identical to generate() on the in-memory model; TTFT "
              f"{(load_s + prefill_s) * 1e3:.1f} ms = load {load_s * 1e3:.1f} ms ("
              f"{phases_text(m)}; the read is from a warm page cache: this run just wrote "
              f"the file) + prefill {prefill_s * 1e3:.1f} ms; decode {all_ms:.3f} ms/token; "
              f"a call allocates {transient / 1e9:.3f} GB beyond the weights")
        engine_tokens, _ = serve(m, "(a)")
        del m
        gc.collect()
        torch.cuda.empty_cache()

        # (b) three tiers
        abstract = init_empty_weights(cfg)
        sizes = compute_module_sizes(abstract, dtype=torch.bfloat16)
        # the card takes the embedding, attention and norms, pinned host
        # memory the MLP's down projection, the disk the rest
        budget = {"device": sum(sizes[k] for k in ("embedding", "layers/block/attn",
                                                   "layers/block/ln_attn", "layers/block/ln_mlp")),
                  "cpu": sizes["layers/block/mlp/w_down"], "disk": 1 << 62}
        offload = os.path.join(tmp, "offload")
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        m = load_checkpoint_and_dispatch(cfg, ckpt, device_map="sequential", max_memory=budget,
                                         offload_folder=offload, dtype=torch.bfloat16)
        load_s = time.perf_counter() - t0
        got, prefill_s = tokens(m, prefill=True)
        peak = torch.cuda.max_memory_allocated() - base
        if set(m.device_map.values()) != {"device", "cpu", "disk"}:
            fail(f"dispatch (b): the map does not use all three tiers: {m.device_map}")
        if not torch.equal(got, want):
            fail(f"dispatch (b): tokens {got.tolist()} differ from (a)'s {want.tolist()}")
        tiers = tier_bytes(m.params, m.device_map)
        host_step = tiers["cpu"] + tiers["disk"]
        buffers = sum(b.numel() * b.element_size() for b in m._buffers.values())
        # host-tier bytes of the blocks' stacked leaves (staged a layer at
        # a time) and of the top-level leaves (staged whole)
        host_block = sum(math.prod(leaf.shape) * leaf.dtype.itemsize
                         for path, leaf in flatten_pytree(m.params).items()
                         if path.startswith("layers/")
                         and placement_of(path, m.device_map) != "device")
        host_top = host_step - host_block
        host_layer = host_block / cfg.num_layers
        limit = tiers["device"] + 2 * host_layer + host_top + transient
        headroom = (limit - peak) / host_layer
        if peak > limit:
            fail(f"dispatch (b): peak device memory {peak / 1e9:.3f} GB over the limit "
                 f"{limit / 1e9:.3f} GB ({headroom:.2f} layers of host-tier bytes): the path "
                 "holds more than two layers of streamed weights")
        rate = h2d_gb_s(dev)
        tier_ms = ms_per_token(m)
        bound_ms = host_step / rate / 1e6
        print(f"dispatch (b) on {card}: map {m.device_map}; tiers {tiers} bytes; "
              f"{DISPATCH_NEW} tokens identical to (a); load {load_s * 1e3:.1f} ms "
              f"({phases_text(m)}) + prefill {prefill_s * 1e3:.1f} ms (after the call made "
              "the disk tier pinned)")
        print(f"dispatch (b) on {card}: peak device memory {peak / 1e9:.3f} GB <= "
              f"{limit / 1e9:.3f} GB (device tier {tiers['device'] / 1e9:.3f} + 2 x one layer "
              f"of the blocks' host-tier bytes {host_layer / 1e9:.3f} + top-level host-tier "
              f"leaves {host_top / 1e9:.3f} + (a)'s transient {transient / 1e9:.3f}), headroom "
              f"{headroom:.2f} layers; the host-tier device buffers hold "
              f"{buffers / 1e9:.3f} GB")
        print(f"dispatch (b) on {card}: H2D {host_step / 1e9:.3f} GB per decode step; "
              f"{tier_ms:.3f} ms/token (differential over {DISPATCH_EXTRA} tokens) against a "
              f"bound of {bound_ms:.3f} ms/token (host-tier bytes over the pinned H2D rate "
              f"{rate:.2f} GB/s measured with a 1 GiB copy), {bound_ms / tier_ms:.2f} of it")

        real_stage = StreamedWeight.stage

        def skipping(w):
            if any(w is s for s in m.model.layers[DISPATCH_CONTROL_LAYER].streamed):
                return
            real_stage(w)

        with mock.patch.object(StreamedWeight, "stage", skipping):
            control = tokens(m)
        if torch.equal(control, want):
            fail(f"dispatch (b) control: with layer {DISPATCH_CONTROL_LAYER}'s host-tier "
                 "copies skipped the tokens still equal (a)'s: the check is blind")
        print(f"dispatch (b) control (layer {DISPATCH_CONTROL_LAYER}'s host-tier copies "
              f"skipped): {int((control == want).sum())}/{want.numel()} tokens equal (a)'s: "
              "fails the check")
        tier_tokens, tier_metrics = serve(m, "(b)")
        if tier_tokens != engine_tokens:
            fail(f"dispatch (b) engine: tokens {tier_tokens} differ from (a)'s engine's "
                 f"{engine_tokens} over the same weights")
        print(f"dispatch (b) engine on {card}: tokens equal (a)'s engine's; decode "
              f"{tier_metrics['serving/decode_step_ms_p50']:.3f} ms/step (p50, 2 slots) "
              f"against the host-tier H2D bound {bound_ms:.3f} ms/step")
        del m
        gc.collect()
        torch.cuda.empty_cache()

        # (c) quantized on load
        bf16_bytes = ckpt_bytes
        # every bf16 weight once, but the embedding's one row
        bf16_step = ckpt_bytes - (cfg.vocab_size - 1) * cfg.embed_dim * 2
        for label, qc in (("int8 (group 128)", QuantizationConfig(load_in_8bit=True)),
                          ("NF4 + double quant", QuantizationConfig(
                              load_in_4bit=True, quant_type="nf4", double_quant=True))):
            t0 = time.perf_counter()
            m = load_checkpoint_and_dispatch(cfg, ckpt, device_map="auto",
                                             dtype=torch.bfloat16, quantization_config=qc)
            load_s = time.perf_counter() - t0
            got = tokens(m)
            q_ms = ms_per_token(m)
            packed = quantized_nbytes(m.params)
            step_bytes = step_weight_bytes(m.params, cfg)
            with torch.no_grad():
                dq = dequantize_params(m.params)
                plain = DecoderLM(cfg, device=dev).load_params(from_reference(dq, cfg))
                del dq
                want_q = counted(generate, plain, prompt,
                                 max_new_tokens=DISPATCH_NEW)[:, p_len:]
            if not torch.equal(got, want_q):
                fail(f"dispatch (c) {label}: tokens {got.tolist()} differ from generate() on "
                     f"the dequantized weights {want_q.tolist()}")
            if qc.load_in_8bit:
                serve(m, "(c) int8")
            print(f"dispatch (c) on {card}: {label}: {DISPATCH_NEW} tokens identical to "
                  f"generate() on a DecoderLM of the dequantized packed leaves "
                  f"({int((got == want).sum())}/{want.numel()} equal to bf16's); packed "
                  f"{packed / 1e9:.3f} GB vs bf16 {bf16_bytes / 1e9:.3f} GB; load "
                  f"{load_s * 1e3:.1f} ms ({phases_text(m)}); decode {q_ms:.3f} ms/token; a "
                  f"step reads {step_bytes / 1e9:.3f} GB of weights (bf16: "
                  f"{bf16_step / 1e9:.3f} GB)")
            del m, plain
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# the T5 and BERT families: #5's D 64 instantiation, generate_seq2seq,
# its dispatch, and the two families' training steps
# ---------------------------------------------------------------------------

T5_B, T5_SRC, T5_NEW = 4, 512, 64  # seq2seq_path: batch, source length, new tokens
T5_PADDED = (384, 200)  # rows 2 and 3 right-padded to these source lengths
T5_CASE_SEED, T5_EDGE_SEED, T5_DATA_SEED = 9, 8, 10  # their own generators
# edge cases of the D 64 split walk at t5-base's decode arena (H = KVH =
# 12, L 1024): (tag, the last query position of each batch row as a
# function of the split length E in tokens); Sq 1
T5_EDGES = [
    ("t5 a: pos 0, 63/64/65, split edges +-1, parked at L - 1",
     lambda e, n: [0, 63, 64, 65, e - 1, e, e + 1, n - 1]),
    ("t5 b: B 1", lambda e, n: [T5_NEW - 1]),
]
T5_TRAIN = (8, 512, 128, 6)  # seq2seq_train_path: batch, source, target, steps
BERT_TRAIN = (64, 128, 10, 20)  # encoder_train_path: batch, seq, steps_per_call, steps


def t5_decode_phase(dev, dtype=None):
    """The dense decode kernel's D 64 instantiation at t5-base's decode
    shape (B 4, H = KVH = 12, group 1, D 64, L 1024, in ``dtype``: None
    bf16, or fp16 through ``dense_decode_f16``) against the plain version:
    checked at positions 1 and 32 of a 64-token generation and timed at its
    last, 63 (beside its bound and SDPA over the same K/V); then T5_EDGES
    on their own generator. Returns its kernel row."""
    import torch

    from accelerate_tpu_torch.models.seq2seq import Seq2SeqConfig
    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.ops.attention import decode_attention, decode_attention_reference

    cfg = Seq2SeqConfig()
    h, kvh, d, length = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.max_cache_len
    scale = 1.0 / math.sqrt(d)
    gen = torch.Generator(device=dev).manual_seed(T5_CASE_SEED)

    kname = "dense_decode" + dtype_suffix(dtype)

    def rnd(g, *shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype or torch.bfloat16)

    q, k, v = rnd(gen, T5_B, h, 1, d), rnd(gen, T5_B, kvh, length, d), rnd(gen, T5_B, kvh, length, d)
    errs = []
    for p in (1, T5_NEW // 2):
        pos = torch.full((T5_B, 1), p, dtype=torch.int32, device=dev)
        got = counted(kname, lambda: decode_attention(q, k, v, q_positions=pos))
        errs.append(check_close(f"{kname} (D 64, t5-base, position {p})", got,
                                decode_attention_reference(q, k, v, pos, scale)))
    row = dense_case(gen, dev, "D 64: t5-base decode, B 4, position 63", q, k, v,
                     torch.full((T5_B, 1), T5_NEW - 1, dtype=torch.int32, device=dev))
    errs.append(row["max_abs_err"])
    g_edge = torch.Generator(device=dev).manual_seed(T5_EDGE_SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for tag, lasts_of in T5_EDGES:
        b = len(lasts_of(0, length))
        per_split, _ = kernels.decode_split_plan(b, kvh, length, sms)
        e = per_split * kernels.DECODE_TILE
        pos = torch.tensor(lasts_of(e, length), dtype=torch.int32, device=dev)[:, None]
        qe, ke, ve = rnd(g_edge, b, h, 1, d), rnd(g_edge, b, kvh, length, d), rnd(g_edge, b, kvh, length, d)
        got = counted(kname, lambda: decode_attention(qe, ke, ve, q_positions=pos))
        err = check_close(f"{kname} (D 64, edge case {tag})", got,
                          decode_attention_reference(qe, ke, ve, pos, scale))
        errs.append(err)
        print(f"kernel {kname} (D 64) edge case {tag} (split {e} tokens, B {b}, "
              f"positions {pos[:, 0].tolist()}): max_abs_err {err:.3e} "
              f"(tol {KERNEL_ATOL} + {KERNEL_RTOL}*|plain|)")
    row["max_abs_err"] = max(errs)
    return dict(name=f"{kname} (D 64)", route="cuda",
                source="accelerate_tpu_torch/csrc/dense_decode.cu",
                replaces="accelerate_tpu/ops/attention.py:977", **row)


def t5_sources(dev):
    """t5-base's source batch: T5_B rows of T5_SRC tokens from their own
    generator, rows 2 and 3 right-padded to T5_PADDED by the mask."""
    import torch

    from accelerate_tpu_torch.models.seq2seq import Seq2SeqConfig

    gen = torch.Generator(device=dev).manual_seed(T5_DATA_SEED)
    src = torch.randint(3, Seq2SeqConfig().vocab_size, (T5_B, T5_SRC), generator=gen,
                        device=dev)
    lengths = torch.tensor([T5_SRC, T5_SRC, *T5_PADDED], device=dev)
    mask = (torch.arange(T5_SRC, device=dev)[None] < lengths[:, None]).to(torch.int32)
    return src, mask


def seq2seq_gaps(model, src, mask, tokens):
    """``(worst gap, exact count)`` of generated ``tokens`` [B, new] under
    the uncached plain forward (``Seq2SeqLM.forward``) on the decoder input
    they grew: the start token, then the tokens."""
    import torch

    start = torch.full_like(tokens[:, :1], model.config.decoder_start_token_id)
    with torch.no_grad():
        logits = model(src, decoder_input_ids=torch.cat([start, tokens[:, :-1]], dim=1),
                       attention_mask=mask)["logits"]
    return token_gaps(logits, tokens)


def seq2seq_path(dev, card: str):
    """``generate_seq2seq`` greedy on t5-base at full width (random bf16
    weights from seed 0 made on the card): B 4 sources of 512 tokens, two
    right-padded to 384 and 200, 64 new tokens. The counts are reset just
    before the measured call and read after it: the dense decode kernel
    (its D 64 instantiation) 12 layers x 63 steps, no flash launch (T5's
    head_dim 64 keeps attention on the plain path, as the reference's
    gate does). Tokens teacher-forced against the uncached plain forward
    within TOP2_MARGIN. Prints the TTFT (encoder + prefill), ms/token, and
    the decode step's wall captured (as generate_seq2seq replays it) and
    run eagerly on the same buffers. Returns ``(launches, state)`` for the
    dispatch phase."""
    import functools

    import torch

    from accelerate_tpu_torch import Seq2SeqConfig, Seq2SeqLM, generate_seq2seq
    from accelerate_tpu_torch.generation import _seq2seq_body
    from accelerate_tpu_torch.models.convert import random_params
    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.utils import cuda_graphs

    cfg = Seq2SeqConfig()
    weights = random_params(cfg, seed=0, device=dev)
    model = Seq2SeqLM(cfg, device=dev).load_params(weights)
    src, mask = t5_sources(dev)
    # a warm-up call: cuBLAS handles, the kernel's load, the first capture
    generate_seq2seq(model, src, max_new_tokens=2, attention_mask=mask)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tokens, ttft = generate_seq2seq(model, src, max_new_tokens=T5_NEW, attention_mask=mask,
                                    return_prefill_seconds=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in kernels.launch_counts.items() if n}
    want = {"dense_decode": cfg.num_decoder_layers * (T5_NEW - 1)}
    print(f"seq2seq path launches: {json.dumps(launches)}")
    if launches != want:
        fail(f"seq2seq path launched {launches}, expected {want} (no flash kernel at D 64)")
    gap, exact = seq2seq_gaps(model, src, mask, tokens)
    print(f"seq2seq path (t5-base, B {T5_B}, source {T5_SRC} with rows padded to "
          f"{list(T5_PADDED)}, {T5_NEW} new): teacher-forced worst gap {gap:.4f} "
          f"(limit {TOP2_MARGIN}), {exact}/{tokens.numel()} argmax")
    if gap > TOP2_MARGIN:
        fail(f"seq2seq path tokens sit {gap} logits below the plain forward's argmax")

    # the decode step on its own: the same body eagerly and captured, on
    # the buffers a fresh prefill leaves, over the same positions
    cache = model.init_cache(T5_B)
    with torch.no_grad():
        enc = model.encode(src, mask)
        start = torch.full((T5_B, 1), cfg.decoder_start_token_id, dtype=torch.long, device=dev)
        tok = model.decode(start, enc, mask, cache=cache)[:, -1].argmax(-1)
    pos = torch.ones((T5_B,), dtype=torch.long, device=dev)
    tok0, pos0 = tok.clone(), pos.clone()
    body = functools.partial(torch.no_grad()(_seq2seq_body), model, cache, tok, pos, True)
    steps = T5_NEW - 1

    def per_step_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / steps

    eager_ms = per_step_ms(body)
    tok.copy_(tok0)
    pos.copy_(pos0)
    replay = cuda_graphs.capture(body, dev, restore=(tok, pos)).replay
    captured_ms = per_step_ms(replay)
    decode_ms = (wall - ttft) * 1e3 / steps
    print(f"seq2seq path: TTFT (encoder + prefill) {ttft * 1e3:.2f} ms, "
          f"{decode_ms:.3f} ms/token over the call's {steps} decode steps (its capture "
          f"included); the decode step alone: captured {captured_ms:.3f} ms, eager "
          f"{eager_ms:.3f} ms, captured / eager {captured_ms / eager_ms:.3f}x; {card}")
    kernels.reset_launch_counts()
    return launches, {"cfg": cfg, "weights": weights, "src": src, "mask": mask,
                      "tokens": tokens}


def seq2seq_dispatch(dev, card: str, s2s: dict):
    """``generate_seq2seq_dispatched`` on t5-base from a checkpoint this
    run writes (seq2seq_path's weights as the reference's stacked bf16
    checkpoint, in a temporary directory): (a) the decoder's MLP leaves
    (half its block bytes; the reference's stacked layout places leaf
    kinds, not layer indices) on the pinned-host tier, streamed a layer at
    a time: tokens equal to seq2seq_path's bit for bit; (b) int8 on load:
    tokens teacher-forced against the int8 model's own uncached forward
    within TOP2_MARGIN. Each call with the counts reset before it: 12 x 63
    dense decode launches."""
    import shutil
    import tempfile

    import torch

    from accelerate_tpu_torch import (QuantizationConfig, generate_seq2seq_dispatched,
                                      load_checkpoint_and_dispatch)
    from accelerate_tpu_torch.models.convert import export_reference_checkpoint
    from accelerate_tpu_torch.ops import kernels

    cfg, src, mask = s2s["cfg"], s2s["src"], s2s["mask"]
    tmp = tempfile.mkdtemp(prefix="seq2seq-dispatch-")
    try:
        ckpt = f"{tmp}/model.safetensors"
        t = time.perf_counter()
        export_reference_checkpoint(s2s["weights"], cfg, ckpt)
        print(f"seq2seq dispatch: checkpoint written in {time.perf_counter() - t:.2f} s "
              f"({sum(w.numel() * 2 for w in s2s['weights'].values()) / 1e9:.3f} GB bf16)")
        want = {"dense_decode": cfg.num_decoder_layers * (T5_NEW - 1)}
        for tag, kw in (("host-tier decoder MLPs", dict(device_map={
                            "": "device", "decoder/layers/block/mlp": "cpu"})),
                        ("int8 on load", dict(quantization_config=QuantizationConfig(
                            load_in_8bit=True)))):
            t = time.perf_counter()
            m = load_checkpoint_and_dispatch(cfg, ckpt, device=dev, **kw)
            load_s = time.perf_counter() - t
            generate_seq2seq_dispatched(m, src, max_new_tokens=2, attention_mask=mask)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t = time.perf_counter()
            tokens, ttft = generate_seq2seq_dispatched(m, src, max_new_tokens=T5_NEW,
                                                       attention_mask=mask,
                                                       return_prefill_seconds=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = {k: n for k, n in kernels.launch_counts.items() if n}
            if launches != want:
                fail(f"seq2seq dispatch ({tag}) launched {launches}, expected {want}")
            if kw.get("quantization_config") is None:
                streamed = sum(len(b.streamed) for b in m.model.decoder)
                same = torch.equal(tokens, s2s["tokens"])
                print(f"seq2seq dispatch ({tag}): {streamed} host-tier weights streamed, "
                      f"load {load_s:.2f} s, TTFT {ttft * 1e3:.2f} ms, "
                      f"{(wall - ttft) * 1e3 / (T5_NEW - 1):.3f} ms/token, tokens equal to "
                      f"seq2seq_path's: {same}; {card}")
                if not streamed or not same:
                    fail(f"seq2seq dispatch ({tag}): streamed {streamed}, tokens equal {same}")
            else:
                gap, exact = seq2seq_gaps(m.model, src, mask, tokens)
                print(f"seq2seq dispatch ({tag}): load {load_s:.2f} s (phases "
                      + ", ".join(f"{k} {v:.2f}" for k, v in m.phase_seconds.items())
                      + f"), TTFT {ttft * 1e3:.2f} ms, "
                      f"{(wall - ttft) * 1e3 / (T5_NEW - 1):.3f} ms/token, teacher-forced "
                      f"worst gap {gap:.4f} (limit {TOP2_MARGIN}), {exact}/{tokens.numel()} "
                      f"argmax; {card}")
                if gap > TOP2_MARGIN:
                    fail(f"seq2seq dispatch ({tag}) tokens sit {gap} logits below the argmax")
            del m
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernels.reset_launch_counts()


def t5_train_flops(cfg, b: int, src: int, tgt: int) -> float:
    """Model FLOPs of one t5 training step (forward + backward = 3x the
    forward; remat's recompute not counted): the matmuls of each token
    through its stack (encoder: self-attention and MLP; decoder:
    self-attention, the cross-attention's q and o, MLP, the LM head; the
    cross K/V over the source in every decoder layer) and the attention
    products (bidirectional over the source, causal over the target, the
    cross-attention's target x source)."""
    e, m, v = cfg.embed_dim, cfg.mlp_dim, cfg.vocab_size
    enc = cfg.num_layers * (2 * (4 * e * e + 3 * e * m) * src + 4 * src * src * e)
    dec = cfg.num_decoder_layers * (2 * (6 * e * e + 3 * e * m) * tgt + 2 * 2 * e * e * src
                                    + 2 * tgt * tgt * e + 4 * tgt * src * e)
    return 3.0 * b * (enc + dec + 2 * e * v * tgt)


def seq2seq_train_path(dev, card: str):
    """t5-base trained through ``Accelerator(mixed_precision="bf16")`` and
    ``build_train_step`` over fp32 master weights: B 8, source 512,
    target 128 (labels with two -100 tails, decoder inputs their
    shift_right), T5_TRAIN steps on one fixed batch. The loss must be
    finite and fall; no kernel launches (attention is plain at D 64).
    Prints step ms, tokens/s (source + target) and MFU against 989
    TFLOP/s."""
    import torch

    from accelerate_tpu_torch import Accelerator, Seq2SeqConfig, Seq2SeqLM
    from accelerate_tpu_torch.models.convert import random_params
    from accelerate_tpu_torch.ops import kernels

    b, s_src, s_tgt, n = T5_TRAIN
    cfg = Seq2SeqConfig()
    torch.cuda.reset_peak_memory_stats()
    model = Seq2SeqLM(cfg, device=dev, param_dtype=torch.float32).load_params(
        random_params(cfg, seed=1, device=dev, dtype=torch.float32))
    acc = Accelerator(mixed_precision="bf16")
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=TRAIN_LR))
    step = acc.build_train_step()
    gen = torch.Generator(device=dev).manual_seed(T5_DATA_SEED + 1)
    batch = {"input_ids": torch.randint(3, cfg.vocab_size, (b, s_src), generator=gen, device=dev),
             "labels": torch.randint(3, cfg.vocab_size, (b, s_tgt), generator=gen, device=dev),
             "attention_mask": torch.ones((b, s_src), dtype=torch.int32, device=dev)}
    batch["labels"][:2, -16:] = -100
    batch["attention_mask"][2:4, 384:] = 0
    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(step(batch)["loss"].item())
        times.append(time.perf_counter() - t)
    launches = {k: v for k, v in kernels.launch_counts.items() if v}
    if launches:
        fail(f"seq2seq train path launched {launches}: attention at D 64 is plain")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"seq2seq train path losses {losses} are not finite and falling")
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    flops = t5_train_flops(cfg, b, s_src, s_tgt)
    print(f"seq2seq train path (t5-base, B {b}, source {s_src}, target {s_tgt}, bf16, remat "
          f"{cfg.remat_policy}): losses {[round(x, 4) for x in losses]}, step "
          f"{step_s * 1e3:.1f} ms (median of {n - 1} after the first; first "
          f"{times[0] * 1e3:.1f} ms), {b * (s_src + s_tgt) / step_s:.0f} tokens/s, MFU "
          f"{100 * flops / step_s / BF16_FLOPS_PER_S:.2f}% ({flops / 1e12:.3f} TFLOP a step, "
          f"model FLOPs without remat's recompute); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {card}")
    profile_train(step, batch, card, "one t5-base build_train_step step")
    kernels.reset_launch_counts()


def encoder_train_path(dev, card: str):
    """bert-base at bench.py's row: ``Accelerator(mixed_precision="bf16")``,
    B 64 x 128, dropout 0.1 active, AdamW 2e-5, ``build_train_step(
    steps_per_call=10)`` for 20 steps (two calls: the first warms up, the
    second is timed). The loss must be finite; no kernel launches. Prints
    samples/s and MFU counted as bench.py counts them: 6 x the
    non-embedding parameters plus 12 x layers x seq x embed (the
    bidirectional attention term), per token."""
    import torch

    from accelerate_tpu_torch import Accelerator, EncoderClassifier, EncoderConfig
    from accelerate_tpu_torch.models.convert import random_params
    from accelerate_tpu_torch.ops import kernels

    b, s, k, n = BERT_TRAIN
    cfg = EncoderConfig.bert_base()
    torch.cuda.reset_peak_memory_stats()
    model = EncoderClassifier(cfg, device=dev, param_dtype=torch.float32).load_params(
        random_params(cfg, seed=2, device=dev, dtype=torch.float32))
    acc = Accelerator(mixed_precision="bf16")
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=2e-5))
    step = acc.build_train_step(steps_per_call=k)
    gen = torch.Generator(device=dev).manual_seed(T5_DATA_SEED + 2)
    batch = {"input_ids": torch.randint(0, cfg.vocab_size, (k, b, s), generator=gen, device=dev),
             "attention_mask": torch.ones((k, b, s), dtype=torch.int32, device=dev),
             "labels": torch.randint(0, cfg.num_labels, (k, b), generator=gen, device=dev)}
    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(n // k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(step(batch)["loss_mean"].item())
        times.append(time.perf_counter() - t)
    launches = {key: v for key, v in kernels.launch_counts.items() if v}
    if launches:
        fail(f"encoder train path launched {launches}: attention at D 64 is plain")
    if not all(math.isfinite(x) for x in losses):
        fail(f"encoder train path losses {losses} are not finite")
    n_matmul = sum(p.numel() for name, p in model.named_parameters()
                   if "embedding" not in name)
    per_sample = (6 * n_matmul + 12 * cfg.num_layers * s * cfg.embed_dim) * s
    samples_s = b * k / times[-1]
    print(f"encoder train path (bert-base, B {b} x {s}, bf16, dropout {cfg.dropout_rate}, "
          f"steps_per_call {k}): loss means {[round(x, 4) for x in losses]}, "
          f"{times[-1] * 1e3 / k:.2f} ms a step in the timed call (first call "
          f"{times[0] * 1e3 / k:.2f}), {samples_s:.1f} samples/s, MFU "
          f"{100 * samples_s * per_sample / BF16_FLOPS_PER_S:.2f}%; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {card}")
    profile_train(step, batch, card, f"one bert-base build_train_step call of {k} steps")
    kernels.reset_launch_counts()


# ---------------------------------------------------------------------------
# MoE decoders and the ResNet classifier
# ---------------------------------------------------------------------------

# small_1b with 8 experts, top-2 (4.70B parameters): the MoE serving and
# generate() paths at full width and depth, the training path at 8 of its
# 16 layers (2.38B parameters: ~38 GB of fp32 masters, gradients and AdamW
# moments, beside the activations of B 8 x 2048)
MOE_EXPERTS, MOE_TOP_K = 8, 2
MOE_TRAIN_LAYERS = 8
MOE_TRAIN_STEPS = 3       # build_train_step steps timed (the first warms up)
MOE_FALL_STEPS = 6        # constant-lr steps on one fixed batch
MOE_GEN = (4, 512, 16, 48)  # generate(): batch, prompt, base and extra new tokens
MOE_GEN_REPEATS = 5       # timed (short, long) generate() pairs a mode
# resnet_train_path: bench.py's _resnet_bench row (ResNet-50, B 64, 224^2,
# SGD 0.1 momentum 0.9, 12 steps as build_train_step(steps_per_call=4))
RESNET_TRAIN = (64, 224, 4, 12)


def moe_model(dev, num_layers=None, param_dtype=None):
    """small_1b with MOE_EXPERTS experts, top-MOE_TOP_K, random weights from
    seed 0 made on the card: bf16 (serving) or ``param_dtype`` masters.

    One departure from the reference's init: every expert bank is scaled
    by sqrt(MOE_EXPERTS), to the std of a dense MLP's (fan-in the bank's
    own d or m). At the reference's fan-in (E * d) random experts add
    ~1 / sqrt(E) of a dense MLP to the residual, so little beside the
    attention that the serving gate's zeroed-expert control cannot be told
    from the real run."""
    import torch

    from accelerate_tpu_torch.models.configs import DecoderConfig
    from accelerate_tpu_torch.models.convert import random_params
    from accelerate_tpu_torch.models.decoder import DecoderLM

    kw = dict(moe_num_experts=MOE_EXPERTS, moe_top_k=MOE_TOP_K)
    if num_layers is not None:
        kw["num_layers"] = num_layers
    cfg = DecoderConfig.small_1b(**kw)
    t0 = time.perf_counter()
    model = DecoderLM(cfg, device=dev, param_dtype=param_dtype)
    params = random_params(cfg, seed=0, device=dev, dtype=param_dtype)
    for name, w in params.items():
        if ".moe_mlp.w_" in name:
            w.mul_(MOE_EXPERTS ** 0.5)
    model.load_params(params)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def live_rows(args, kw, parked):
    """[B, S] bool: the rows of one model call whose logits a run reads:
    the packed ragged prefill's real rows (position >= 0), a decode or
    verify step's live slots (not parked at ``parked``), a flat prefill
    chunk's prompt rows (its pads are token 0, which these prompts never
    hold), every row of any other call."""
    import torch

    ids = args[0]
    pos = kw.get("cache_positions")
    if kw.get("ragged_slots") is not None:
        return (pos >= 0).reshape(ids.shape)
    if pos is not None:
        pos = pos[:, None] if pos.dim() == 1 else pos
        return torch.ones_like(ids, dtype=torch.bool) if parked is None else pos != parked
    if kw.get("decode"):
        return ids != 0
    return torch.ones_like(ids, dtype=torch.bool)


class moe_record:
    """Record a run of an MoE model, its steps eager (no CUDA graph, so
    each step calls the model): every call's input ids, the argmax of its
    logits and its live rows (``live_rows``), every MoE layer's expert
    choices in call order, and the token-slots the prefill calls drop
    (real rows only)."""

    def __init__(self, model, parked=None):
        self.model, self.parked = model, parked
        self.calls, self.choices = [], []
        self.prefill_slots = [0, 0]  # dropped, total

    def __enter__(self):
        from unittest import mock

        from accelerate_tpu_torch.models import moe
        from accelerate_tpu_torch.utils import cuda_graphs

        real_forward, real_route = self.model.forward, moe._route
        live = []

        def forward(*args, **kw):
            rows = live_rows(args, kw, self.parked)
            # a prefill: packed ragged, a flat chunk or a whole prompt (a
            # verify step has positions and no ragged rows)
            prefill = (kw.get("ragged_slots") is not None
                       or kw.get("cache_positions") is None)
            live.append((rows, prefill))
            try:
                logits = real_forward(*args, **kw)
            finally:
                live.pop()
            self.calls.append((args[0].clone(), logits.argmax(-1), rows))
            return logits

        def route(probs, top_k, capacity):
            out = real_route(probs, top_k, capacity)
            self.choices.append(out[1].clone())
            rows, prefill = live[-1]
            if prefill:
                keep = out[3] & rows.reshape(out[3].shape[:2])[..., None]
                self.prefill_slots[0] += int(rows.sum()) * top_k - int(keep.sum())
                self.prefill_slots[1] += int(rows.sum()) * top_k
            return out

        self.patches = [mock.patch.object(self.model, "forward", forward),
                        mock.patch.object(moe, "_route", route),
                        mock.patch.object(cuda_graphs, "captures", lambda device: False)]
        for p in self.patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in reversed(self.patches):
            p.stop()

    def drop_share(self) -> float:
        return self.prefill_slots[0] / max(self.prefill_slots[1], 1)


def plain_kernels():
    """Every kernel wrapper of the serving and generate() paths patched to
    its plain PyTorch version (on CUDA tensors too)."""
    import contextlib
    from unittest import mock

    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.ops.attention import (decode_attention_reference,
                                                    flash_fwd_reference,
                                                    paged_decode_reference,
                                                    ragged_prefill_reference)

    def paged_quant(q, kp, vp, ks, vs, table, pos, scale, bits):
        return paged_decode_reference(q, kp, vp, table, pos, scale, k_scale=ks, v_scale=vs,
                                      kv_quant_bits=bits)

    def prefill(q, kn, vn, kp, vp, table, slot, pos, hist, scale, bt):
        return ragged_prefill_reference(q, kn, vn, kp, vp, table, slot, pos, hist, scale)

    def prefill_quant(q, kn, vn, kp, vp, ks, vs, table, slot, pos, hist, scale, bt, bits):
        return ragged_prefill_reference(q, kn, vn, kp, vp, table, slot, pos, hist, scale,
                                        k_scale=ks, v_scale=vs, kv_quant_bits=bits)

    def dense_quant(q, k, v, ks, vs, pos, scale, bits):
        return decode_attention_reference(q, k, v, pos, scale, k_scale=ks, v_scale=vs,
                                          kv_quant_bits=bits)

    plain = {"paged_decode": paged_decode_reference, "paged_decode_quant": paged_quant,
             "ragged_prefill": prefill, "ragged_prefill_quant": prefill_quant,
             "dense_decode": decode_attention_reference, "dense_decode_quant": dense_quant,
             "flash_fwd": flash_fwd_reference}
    stack = contextlib.ExitStack()
    for name, fn in plain.items():
        stack.enter_context(mock.patch.object(kernels, name, fn))
    return stack


def moe_replay(model, rec: moe_record, run, what: str):
    """Replay a recorded run over ``model`` through ``run()`` (the same
    engine or generate() call, eager) with the plain kernels, routed in
    the recorded run's own groups and held to its expert choices: the
    i-th model call must be fed the recorded call's ids, its plain logits
    are read against the recorded argmax on the live rows, and it hands
    the run a one-hot of the recorded argmax so every decision (tokens,
    drafts, admission) repeats the recorded run's. Its steps run eager, as
    the recorded run's. ``(worst gap, exact,
    total, flipped, choices)``: how many logits a recorded token sits
    below the plain argmax, the exact count, and how many of the read
    rows' expert choices the plain route would make otherwise if left
    free."""
    from unittest import mock

    import torch

    from accelerate_tpu_torch.models import moe

    state = {"call": 0, "choice": 0, "worst": 0.0, "exact": 0, "total": 0, "flipped": 0,
             "choices": 0}
    real_forward, real_top_k = model.forward, moe._top_k

    def forward(*args, **kw):
        i = state["call"]
        if i >= len(rec.calls):
            fail(f"{what}: the replay makes more model calls than the run ({len(rec.calls)})")
        ids, want, rows = rec.calls[i]
        if args[0].shape != ids.shape or not torch.equal(args[0], ids):
            fail(f"{what}: replay call {i} is fed other ids than the run's")
        state["call"] += 1
        state["rows"] = rows
        logits = real_forward(*args, **kw)
        gap = (logits.max(-1).values - logits.gather(-1, want[..., None])[..., 0])[rows]
        if gap.numel():
            state["worst"] = max(state["worst"], gap.max().item())
        state["exact"] += int((gap == 0).sum())
        state["total"] += gap.numel()
        return torch.zeros_like(logits).scatter_(-1, want[..., None], 1.0)

    def top_k(probs, k):
        j = state["choice"]
        forced = rec.choices[j]
        state["choice"] += 1
        _, free = real_top_k(probs, k)
        if free.shape != forced.shape:
            fail(f"{what}: replay routing {j} has groups {tuple(free.shape)}, the run's "
                 f"{tuple(forced.shape)}")
        rows = state["rows"].reshape(free.shape[:2])
        state["flipped"] += int(((free != forced).any(-1) & rows).sum())
        state["choices"] += int(rows.sum())
        return probs.gather(-1, forced), forced

    with plain_kernels(), mock.patch.object(model, "forward", forward), \
            mock.patch.object(moe, "_top_k", top_k), mock_captures(False), torch.no_grad():
        run()
    if state["call"] != len(rec.calls) or state["choice"] != len(rec.choices):
        fail(f"{what}: the replay made {state['call']} calls and {state['choice']} routings, "
             f"the run {len(rec.calls)} and {len(rec.choices)}")
    return (state["worst"], state["exact"], state["total"], state["flipped"],
            state["choices"])


def moe_serve_path(dev, card: str, prompts, paged: dict):
    """Serve small_1b with 8 experts, top-2, at full width and depth (16
    layers, 4.70B parameters, random bf16 weights from seed 0) over the
    main path's requests: the paged engine (page 16), the flat engine,
    the int8 paged arena and spec K 4. Each run is measured as served
    (steps as CUDA graph replays) with the counts reset before it; #4, #5
    and #6 launch on their entries only. Each is run again eager and
    recorded (its tokens must be the measured run's), then replayed with
    the plain kernels in the run's own routing groups and expert choices
    (``moe_replay``): every token within TOP2_MARGIN of the plain argmax.
    A control run with one expert's w_down bank zeroed in every layer
    (each layer's most chosen), replayed on the real weights, must fail
    that gate."""
    import torch

    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.serving.engine import ServingEngine

    model, built = moe_model(dev)
    cfg = model.config
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"moe serve path: small_1b with {cfg.moe_num_experts} experts, top-{cfg.moe_top_k} "
          f"({cfg.num_layers} layers, E {cfg.embed_dim}, M {cfg.mlp_dim}, "
          f"{cfg.num_params / 1e9:.3f}B params, {weight_bytes / 1e9:.3f} GB bf16), random "
          f"weights seed 0, built in {built:.1f} s")
    new_tokens = 32
    base = dict(num_slots=8, max_cache_len=MAX_CACHE, prefill_chunks=(128, 512), device=dev)
    runs = (("paged", dict(page_size=PAGE), ("paged_decode", "ragged_prefill")),
            ("flat", dict(page_size=None), ("dense_decode", None)),
            ("paged int8", dict(page_size=PAGE, kv_cache_dtype="int8"),
             ("paged_decode_quant", "ragged_prefill_quant")),
            (f"spec K {SPEC_K}", dict(page_size=PAGE, spec_draft_len=SPEC_K),
             ("paged_decode", "ragged_prefill")))
    warm = ServingEngine(model, **base, page_size=PAGE)
    warm.generate_batched([prompts[1], prompts[3]], max_new_tokens=4)
    del warm
    parked = MAX_CACHE - 1
    launches_all, first = {}, None

    def recorded(kw, new=new_tokens):
        with moe_record(model, parked) as rec:
            eng = ServingEngine(model, **base, **kw)
            reqs = [eng.submit(p, max_new_tokens=new, seed=i) for i, p in enumerate(prompts)]
            eng.run()
        return rec, [list(r.tokens) for r in reqs]

    def replay(rec, kw, what):
        def run():
            eng = ServingEngine(model, **base, **kw)
            for i, p in enumerate(prompts):
                eng.submit(p, max_new_tokens=new_tokens, seed=i)
            eng.run()
        return moe_replay(model, rec, run, what)

    for name, kw, (decode, prefill) in runs:
        engine, reqs, wall, launches = serve_counted(model, prompts, new_tokens, **base, **kw)
        steps, dispatches = engine.step_count, engine.prefill_dispatches
        want = {decode: steps * cfg.num_layers}
        if prefill:
            want[prefill] = dispatches * cfg.num_layers
        expect_launches(f"moe serve path ({name})", launches, want)
        launches_all[name] = {k: n for k, n in launches.items() if n}
        m = engine.metrics()
        del engine
        rec, tokens = recorded(kw)
        if tokens != [list(r.tokens) for r in reqs]:
            diff = sum(a != b for x, y in zip(tokens, (r.tokens for r in reqs))
                       for a, b in zip(x, y))
            fail(f"moe serve path ({name}): the eager recorded run's tokens differ from the "
                 f"served run's in {diff} places")
        gap, exact, total, flipped, choices = replay(rec, kw, f"moe serve path ({name})")
        if not math.isfinite(gap) or gap > TOP2_MARGIN:
            fail(f"moe serve path ({name}): a token is {gap} logits below the plain replay's "
                 f"argmax (margin {TOP2_MARGIN})")
        tps = m["serving/generated_tokens"] / wall
        if first is None:
            first = (rec, kw)
        print(f"moe serve path ({name}): {len(reqs)} requests x {new_tokens} tokens, {steps} "
              f"{'verify' if 'spec' in name else 'decode'} steps, {dispatches} prefill "
              f"dispatches, launches {launches_all[name]}; vs the plain replay in the run's "
              f"groups and expert choices: {exact}/{total} read rows its argmax, worst gap "
              f"{gap:.4f} (margin {TOP2_MARGIN}); the plain route left free would choose "
              f"otherwise at {flipped} of {choices} token-layer routings; prefill drops "
              f"{100 * rec.drop_share():.2f}% of real token-slots "
              f"({rec.prefill_slots[0]} of {rec.prefill_slots[1]})")
        print(f"moe serve path ({name}) on {card}: {tps:.1f} tokens/s over {wall:.3f} s, TTFT "
              f"p50 {m['serving/ttft_ms_p50']:.2f} ms, decode "
              f"{m['serving/decode_step_ms_p50']:.3f} ms/step (p50); dense small_1b paged (same "
              f"call): {paged['tokens_per_s']:.1f} tokens/s, TTFT p50 "
              f"{paged['ttft_ms_p50']:.2f} ms, {paged['step_ms_p50']:.3f} ms/step; weight-read "
              f"bound of a step {1e3 * weight_bytes / HBM_BYTES_PER_S:.3f} ms (every expert "
              f"bank read once a step: {weight_bytes / 1e9:.3f} GB over 3.35 TB/s)")

    # the control: one expert bank zeroed in every layer (each layer's
    # most chosen expert in the first run: random weights route most
    # tokens to few experts), its run replayed on the real weights
    rec, kw = first
    layers = cfg.num_layers
    counts = [torch.zeros(cfg.moe_num_experts, dtype=torch.long, device=dev)
              for _ in range(layers)]
    for j, idx in enumerate(rec.choices):
        counts[j % layers] += torch.bincount(idx.flatten(), minlength=cfg.moe_num_experts)
    experts = [int(c.argmax()) for c in counts]
    banks = [blk.moe_mlp.w_down for blk in model.layers]
    saved = [w[e].clone() for w, e in zip(banks, experts)]
    for w, e in zip(banks, experts):
        w[e].zero_()
    try:
        control, _ = recorded(kw)
    finally:
        for w, e, s in zip(banks, experts, saved):
            w[e].copy_(s)
    gap_c, exact_c, total_c, _, _ = replay(control, kw, "moe serve path control")
    if not gap_c > TOP2_MARGIN:
        fail(f"moe serve path control: with one expert's w_down zeroed in every layer every "
             f"read row is within {TOP2_MARGIN} of the plain replay's argmax (worst {gap_c}): "
             "the gate is blind")
    print(f"moe serve path control (paged, the w_down bank of each layer's most chosen expert "
          f"{experts} zeroed): {exact_c}/{total_c} read rows the plain argmax, worst gap "
          f"{gap_c:.4f}: fails the gate")
    kernels.reset_launch_counts()
    return model, launches_all


def moe_generate_path(dev, card: str, model):
    """generate() on the MoE small_1b at B 4 x 512 with its captured
    decode step: the prefill's flash forward (#1) once per layer, the
    dense decode (#5) once per layer a step. Its tokens are the eager
    recorded run's, and within TOP2_MARGIN of a plain replay in
    generate()'s groups (each prompt row one group; each [B, 1] decode
    row its own) and expert choices. Prints ms/token captured and eager
    (differential: the extra tokens of a longer call over their count, the
    median of MOE_GEN_REPEATS such pairs)."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import generate
    from accelerate_tpu_torch.ops import kernels

    cfg = model.config
    b, s, base_new, extra = MOE_GEN
    ids = torch.as_tensor(np.random.RandomState(5).randint(3, cfg.vocab_size, (b, s)),
                          device=dev)
    new = base_new + extra
    generate(model, ids[:, :64], max_new_tokens=4)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = generate(model, ids, max_new_tokens=new)
    torch.cuda.synchronize()
    launches = {k: n for k, n in kernels.launch_counts.items() if n}
    expect_launches("moe generate path", launches, {
        "flash_fwd": cfg.num_layers, "dense_decode": cfg.num_layers * (new - 1)})
    with moe_record(model) as rec:
        eager = generate(model, ids, max_new_tokens=new)
    if not torch.equal(eager, out):
        fail("moe generate path: the eager recorded run's tokens differ from the captured run's")
    gap, exact, total, flipped, choices = moe_replay(
        model, rec, lambda: generate(model, ids, max_new_tokens=new), "moe generate path")
    if not math.isfinite(gap) or gap > TOP2_MARGIN:
        fail(f"moe generate path: a token is {gap} logits below the plain replay's argmax "
             f"(margin {TOP2_MARGIN})")

    def ms_per_token(captured: bool):
        """The median, over MOE_GEN_REPEATS pairs of calls (short, long;
        warmed up once), of the long call's extra wall over its extra
        tokens, and (min, max) of the pairs."""
        diffs = []
        with mock_captures(captured):
            generate(model, ids, max_new_tokens=new)
            for _ in range(MOE_GEN_REPEATS):
                walls = []
                for n in (base_new, new):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    generate(model, ids, max_new_tokens=n)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                diffs.append(1e3 * (walls[1] - walls[0]) / extra)
        return statistics.median(diffs), (min(diffs), max(diffs))

    (captured_ms, captured_spread), (eager_ms, eager_spread) = (ms_per_token(True),
                                                                ms_per_token(False))
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"moe generate path: B {b} x {s} prompt, {new} new tokens, launches {launches}; vs "
          f"the plain replay in generate()'s groups and expert choices: {exact}/{total} rows "
          f"its argmax, worst gap {gap:.4f} (margin {TOP2_MARGIN}); free plain routing would "
          f"choose otherwise at {flipped} of {choices} token-layer routings")
    print(f"moe generate path on {card}: {captured_ms:.3f} ms/token with the decode step "
          f"captured (pairs {captured_spread[0]:.3f}-{captured_spread[1]:.3f}), "
          f"{eager_ms:.3f} ms/token eager (pairs {eager_spread[0]:.3f}-{eager_spread[1]:.3f}); "
          f"each the median of {MOE_GEN_REPEATS} differentials over {extra} tokens; "
          f"weight-read bound {1e3 * weight_bytes / HBM_BYTES_PER_S:.3f} ms/token")
    kernels.reset_launch_counts()
    return launches


@contextlib.contextmanager
def mock_captures(on: bool):
    """``cuda_graphs.captures`` forced off (``on`` False): the steps run
    eager."""
    from unittest import mock

    from accelerate_tpu_torch.utils import cuda_graphs

    if on:
        yield
        return
    with mock.patch.object(cuda_graphs, "captures", lambda device: False):
        yield


def moe_flops_per_token(cfg, s: int) -> float:
    """Training FLOPs a token uses (6 x the parameters it reads: attention,
    the router, its k experts' banks, the tied LM head; plus the causal
    attention term of the dense path's formula)."""
    e, m = cfg.embed_dim, cfg.mlp_dim
    idle = (cfg.moe_num_experts - cfg.moe_top_k) * 3 * e * m * cfg.num_layers
    return 6 * (cfg.num_params - idle) + 6 * cfg.num_layers * s * e


def moe_train_path(dev, card: str):
    """Train the MoE small_1b at full width, MOE_TRAIN_LAYERS of its 16
    layers, at B TRAIN_B x TRAIN_S: bf16 over fp32 masters, remat
    save_attention, AdamW through build_train_step. Gates: the flash
    kernels once per layer a step (forward) and in backward, a finite
    aux_loss, a falling loss on one fixed batch, one step within
    TRAIN_LOSS_RTOL / TRAIN_GRAD_NORM_RTOL of plain attention (both held to
    the flash run's expert choices), with the dQ-, dK- and dV-zeroed
    controls beyond. Returns the flash kernels' launches."""
    import dataclasses

    import numpy as np
    import torch

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.accelerator import global_grad_norm
    from accelerate_tpu_torch.models import moe
    from accelerate_tpu_torch.models.decoder import DecoderLM
    from accelerate_tpu_torch.ops import kernels

    b, s = TRAIN_B, TRAIN_S
    model, built = moe_model(dev, MOE_TRAIN_LAYERS, torch.float32)
    cfg = model.config
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (b, s))
    batch = {"input_ids": torch.as_tensor(ids, device=dev),
             "labels": torch.as_tensor(ids, device=dev)}
    print(f"moe train path: small_1b with {cfg.moe_num_experts} experts, top-{cfg.moe_top_k}, "
          f"{cfg.num_layers} of 16 layers (depth cut to fit fp32 masters, gradients and AdamW "
          f"moments), {cfg.num_params / 1e9:.3f}B params, batch {b} x {s}, bf16, remat "
          f"{cfg.remat_policy}, built in {built:.1f} s")
    acc = Accelerator(mixed_precision="bf16")
    opt = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    model, opt = acc.prepare(model, opt)
    step = acc.build_train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times, losses = [], []
    for _ in range(MOE_TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step(batch)["loss"].item())
        times.append(time.perf_counter() - t0)
    launches = {name: kernels.launch_counts[name] for name in FLASH_KERNELS}
    for name in FLASH_KERNELS:
        if launches[name] != MOE_TRAIN_STEPS * cfg.num_layers:
            fail(f"moe train path: {name} launched {launches[name]} times in "
                 f"{MOE_TRAIN_STEPS} steps of {cfg.num_layers} layers")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        out = model(**batch)
    if not all(math.isfinite(out[k].item()) for k in out) or not math.isfinite(losses[-1]):
        fail(f"moe train path: non-finite losses {losses}, {out}")
    step_ms = 1e3 * sorted(times[1:])[len(times[1:]) // 2]
    tokens_per_s = b * s / (step_ms / 1e3)
    fpt = moe_flops_per_token(cfg, s)
    slots = cfg.moe_top_k * cfg.moe_capacity_factor
    print(f"moe train path: build_train_step losses {[round(x, 5) for x in losses]}, "
          f"lm_loss {out['lm_loss'].item():.5f}, aux_loss {out['aux_loss'].item():.6f}, "
          f"launches {launches}, peak memory {peak_gb:.2f} GB")
    print(f"moe train path on {card}: {tokens_per_s:.1f} tokens/s, {step_ms:.1f} ms/step "
          f"(median of steady steps {[round(1e3 * t, 1) for t in times]}), MFU "
          f"{100 * tokens_per_s * fpt / BF16_FLOPS_PER_S:.2f}% ({fpt / 1e9:.3f} GFLOP/token: "
          f"attention, the router and {cfg.moe_top_k} experts' MLP; the slot-table form runs "
          f"{slots:g} expert slots a token, {cfg.moe_top_k} of them counted)")

    # the first run's AdamW moments (19 GB) go before the next run's come:
    # its step's closures hold them in reference cycles until a collection
    del acc, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    acc = Accelerator(mixed_precision="bf16")
    opt = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    model, opt = acc.prepare(model, opt)
    step = acc.build_train_step()
    curve = [step(batch)["loss"].item() for _ in range(MOE_FALL_STEPS)]
    if not all(math.isfinite(x) for x in curve) or not curve[-1] < curve[0]:
        fail(f"moe train path: the loss did not fall over {MOE_FALL_STEPS} steps: {curve}")
    print(f"moe train path: {MOE_FALL_STEPS} steps at constant lr {TRAIN_LR} on one batch: "
          f"loss {[round(x, 4) for x in curve]}")
    del acc, opt, step, out
    gc.collect()
    torch.cuda.empty_cache()

    choices = []

    def loss_and_norm(m, forced=None):
        """One forward + backward on the fixed batch: the loss and the
        gradient norm; ``forced`` replays recorded expert choices."""
        from unittest import mock

        real = moe._top_k
        it = iter(forced or ())

        def top_k(probs, k):
            if forced is None:
                vals, idx = real(probs, k)
                choices.append(idx.clone())
                return vals, idx
            idx = next(it)
            return probs.gather(-1, idx), idx

        Accelerator(mixed_precision="bf16").prepare(m)
        m.zero_grad(set_to_none=True)
        with mock.patch.object(moe, "_top_k", top_k):
            o = m(**batch)
            o["loss"].backward()
        norm = global_grad_norm(m.parameters()).item()
        m.zero_grad(set_to_none=True)
        return o["loss"].item(), norm

    loss_f, norm_f = loss_and_norm(model)
    recorded = list(choices)
    plain = DecoderLM(dataclasses.replace(cfg, attention_impl="xla"), device=dev,
                      param_dtype=torch.float32)
    plain.load_state_dict(model.state_dict())
    loss_x, norm_x = loss_and_norm(plain, recorded)
    del plain
    if abs(loss_f - loss_x) > TRAIN_LOSS_RTOL * abs(loss_x):
        fail(f"moe train path: flash loss {loss_f} vs plain attention {loss_x}: beyond "
             f"{TRAIN_LOSS_RTOL} rel")
    if abs(norm_f - norm_x) > TRAIN_GRAD_NORM_RTOL * abs(norm_x):
        fail(f"moe train path: flash grad norm {norm_f} vs plain attention {norm_x}: beyond "
             f"{TRAIN_GRAD_NORM_RTOL} rel")
    print(f"moe train path: one step vs plain attention in the flash step's expert choices: "
          f"loss {loss_f:.6f} vs {loss_x:.6f} (rel {abs(loss_f - loss_x) / abs(loss_x):.2e}, "
          f"tol {TRAIN_LOSS_RTOL}), grad norm {norm_f:.6f} vs {norm_x:.6f} (rel "
          f"{abs(norm_f - norm_x) / abs(norm_x):.2e}, tol {TRAIN_GRAD_NORM_RTOL})")
    train_control(model, lambda m: loss_and_norm(m, recorded), norm_x, "moe train path")
    del model
    kernels.reset_launch_counts()
    return launches


def conv_flops(model, images) -> float:
    """Forward FLOPs of one image through ``model``'s convolutions and
    classifier, counted from the shapes a forward sees (2 x multiply-adds)."""
    import torch

    from accelerate_tpu_torch.models.vision import Conv, Dense

    total = [0]

    def hook(mod, args, out):
        if isinstance(mod, Conv):
            o, i, kh, kw = mod.kernel.shape
            total[0] += 2 * out.shape[2] * out.shape[3] * o * i * kh * kw
        else:
            total[0] += 2 * mod.kernel.numel()

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Conv, Dense))]
    with torch.no_grad():
        model(images[:1])
    for h in handles:
        h.remove()
    return float(total[0])


def resnet_train_path(dev, card: str):
    """ResNet-50 as bench.py's _resnet_bench trains it: B 64 at 224^2,
    ``Accelerator(mixed_precision="bf16")`` over fp32 masters, SGD 0.1
    with momentum 0.9, 12 steps as ``build_train_step(steps_per_call=4)``
    (three calls; the first warms up) on one synthetic batch made on the
    card from a seed. Gates: finite losses that fall over the repeated
    batch, BatchNorm statistics moved by training, finite eval logits,
    no kernel launch (convolutions are cuDNN's). Prints samples/s and MFU
    from the conv FLOPs counted from the shapes (x 3 for the backward)."""
    import torch

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models import ResNet, VisionConfig
    from accelerate_tpu_torch.models.convert import random_params
    from accelerate_tpu_torch.ops import kernels

    b, size, k, steps = RESNET_TRAIN
    cfg = VisionConfig.resnet50(image_size=size)
    torch.cuda.reset_peak_memory_stats()
    model = ResNet(cfg, device=dev, param_dtype=torch.float32).load_params(
        random_params(cfg, seed=0, device=dev, dtype=torch.float32))
    acc = Accelerator(mixed_precision="bf16")
    model, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.randn((b, size, size, 3), generator=gen, device=dev)
    labels = torch.randint(0, cfg.num_classes, (b,), generator=gen, device=dev)
    batch = {"images": images.expand(k, *images.shape), "labels": labels.expand(k, b)}
    step = acc.build_train_step(
        loss_fn=lambda m, mb: m(mb["images"], mb["labels"], train=True)["loss"],
        steps_per_call=k)
    stats = {n: t.clone() for n, t in model.named_buffers()}
    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(steps // k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(batch)
        losses.append((out["loss_mean"].item(), out["loss"].item()))
        times.append(time.perf_counter() - t0)
    launches = {key: v for key, v in kernels.launch_counts.items() if v}
    if launches:
        fail(f"resnet train path launched {launches}: its convolutions are cuDNN's")
    flat = [x for pair in losses for x in pair]
    if not all(math.isfinite(x) for x in flat) or not losses[-1][1] < losses[0][0]:
        fail(f"resnet train path: the loss did not fall over the repeated batch: {losses}")
    moved = sum(not torch.equal(t, stats[n]) for n, t in model.named_buffers())
    if moved != len(stats):
        fail(f"resnet train path: {len(stats) - moved} of {len(stats)} BatchNorm statistics "
             "did not move in training")
    with torch.no_grad():
        logits = model(images[:8])["logits"]
    if not torch.isfinite(logits).all():
        fail("resnet train path: eval logits are not finite")
    flops = 3 * conv_flops(model, images)
    steady = sorted(times[1:])[len(times[1:]) // 2]
    samples_s = b * k / steady
    print(f"resnet train path (ResNet-50, B {b} x {size}^2, bf16 over fp32 masters, SGD 0.1 "
          f"momentum 0.9, steps_per_call {k}, {steps} steps): (loss mean, last loss) per call "
          f"{[(round(m, 4), round(x, 4)) for m, x in losses]}, {moved} BatchNorm statistics "
          f"moved, eval logits finite; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"resnet train path on {card}: {samples_s:.1f} samples/s, {1e3 * steady / k:.2f} ms "
          f"a step (calls {[round(1e3 * t / k, 2) for t in times]} ms a step), MFU "
          f"{100 * samples_s * flops / BF16_FLOPS_PER_S:.2f}% ({flops / 1e9:.3f} GFLOP a sample: "
          f"3 x the convolutions' and classifier's forward)")
    profile_train(step, batch, card, f"one ResNet-50 build_train_step call of {k} steps")
    kernels.reset_launch_counts()


# accelerate_surface_path: the single-process Accelerate surface on small_1b
SURFACE_FINDER_START = 128    # (b): the finder's first batch size (x TRAIN_S tokens)
SURFACE_LEAK_BYTES = 64 << 20  # (b): memory a failed try may leave allocated
SURFACE_PROFILE_STEPS = 2     # (c): fused steps inside the profiled region
SURFACE_LOADER_STEPS = 16     # (d): training steps over the prefetching loader
SURFACE_PREFETCH_DEPTH = 3
SURFACE_BREAK_AT = 3          # (d): the early break's batches


class _StopControl(Exception):
    """Ends the finder's control run after its first failed try."""


def flash_events(trace: dict) -> dict:
    """Device kernel events of a Chrome trace, counted by the port's kernel
    name: a kernel symbol ``<name>_kernel<...>`` whose ``<name>`` (with
    ``_f16`` for a ``__half`` instantiation) is in ``kernels.KERNELS``.
    cuBLAS, cuDNN and PyTorch's own kernels do not count."""
    import re

    from accelerate_tpu_torch.ops import kernels

    counts = {}
    for e in trace.get("traceEvents", []):
        if str(e.get("cat", "")).lower() != "kernel":
            continue
        # demangled ("void flash_fwd_kernel<128, __nv_bfloat16>(...)") or
        # mangled ("_Z16flash_fwd_kernelILi128E13__nv_bfloat16E...")
        m = re.search(r"([A-Za-z_]\w*?)_kernel(?:<|I|\(|$)", e.get("name", ""))
        if not m:
            continue
        name = re.sub(r"^_Z\d+", "", m.group(1)) + ("_f16" if "__half" in e["name"] else "")
        if name in kernels.KERNELS:
            counts[name] = counts.get(name, 0) + 1
    return counts


def accelerate_surface_path(dev, card: str):
    """The single-process Accelerate surface on small_1b at full width,
    B TRAIN_B x TRAIN_S, bf16 over fp32 masters, AdamW: (a) the process API
    on the card; (b) ``find_executable_batch_size`` from B
    SURFACE_FINDER_START against the card's own out-of-memory errors, the
    allocated memory back within SURFACE_LEAK_BYTES of its value before
    each failed try, and a control that keeps the failed try's exception
    and must fail that gate; (c) ``Accelerator.profile`` around two fused
    steps inside ``annotate("train_step")``: the trace's #1-#3 kernel
    events equal to the launch counters of that window; (d) a prepared
    ``DataLoader`` with ``prefetch_depth`` 3 for 16 steps, each batch
    equal on the card to the same loader's without prefetch,
    ``end_of_dataloader`` on the last batch only, the producer thread
    gone after the epoch and after an early break. Returns the flash
    kernels' launches over the phase."""
    import json as _json
    import os
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from accelerate_tpu_torch import (Accelerator, DataLoader, DataLoaderConfiguration,
                                      DistributedType, PartialState, ProfileKwargs,
                                      find_executable_batch_size)
    from accelerate_tpu_torch.models.configs import DecoderConfig
    from accelerate_tpu_torch.models.convert import random_params
    from accelerate_tpu_torch.models.decoder import DecoderLM
    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.runtime.prefetch import HostPrefetcher
    from accelerate_tpu_torch.utils.profiler import annotate

    b, s = TRAIN_B, TRAIN_S
    kernels.reset_launch_counts()

    # (a) the process API on the card
    state = PartialState()
    acc = Accelerator(mixed_precision="bf16",
                      dataloader_config=DataLoaderConfiguration(
                          prefetch_depth=SURFACE_PREFETCH_DEPTH),
                      kwargs_handlers=[ProfileKwargs(activities=["cpu", "cuda"])])
    want_dev = torch.device("cuda", 0) if dev.type == "cuda" else dev
    for who, obj in (("PartialState", state), ("Accelerator", acc)):
        got = (obj.device, obj.distributed_type, obj.num_processes, obj.process_index,
               obj.is_main_process, obj.is_last_process)
        if got != (want_dev, DistributedType.NO, 1, 0, True, True):
            fail(f"surface (a): {who} reads {got} on one card")
    x = torch.arange(5 * 3, device=dev, dtype=torch.float32).view(5, 3)
    with acc.split_between_processes(x) as share:
        if share is not x:
            fail("surface (a): one process's share is not the whole tensor")
    saved = (state.process_index, state.num_processes)
    try:  # process 1 of 2 (the singleton's topology set by hand): rows 3..4, padded
        state.process_index, state.num_processes = 1, 2
        with state.split_between_processes(x, apply_padding=True) as share:
            want = torch.cat([x[3:5], x[4:5]])
            if share.device != x.device or not torch.equal(share, want):
                fail(f"surface (a): process 1 of 2's padded share {share.tolist()} is not "
                     f"{want.tolist()}")
    finally:
        state.process_index, state.num_processes = saved
    acc.wait_for_everyone()
    print(f"surface (a): PartialState and Accelerator on {state.device}, "
          f"{state.distributed_type}, {state.num_processes} process; split_between_processes "
          "on a CUDA tensor: the whole on one process, rows 3..4 + row 4 on process 1 of 2")

    cfg = DecoderConfig.small_1b()
    t0 = time.perf_counter()
    model = DecoderLM(cfg, device=dev, param_dtype=torch.float32)
    model.load_params(random_params(cfg, seed=0, device=dev, dtype=torch.float32))
    opt = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    model, opt = acc.prepare(model, opt)
    step = acc.build_train_step()
    rng = np.random.RandomState(0)
    torch.cuda.synchronize()
    print(f"surface: small_1b, fp32 masters seed 0, bf16 compute, AdamW, built in "
          f"{time.perf_counter() - t0:.1f} s")

    # (b) the batch-size finder against the card's own out-of-memory error.
    # cuBLAS takes a workspace from the caching allocator at a thread's
    # first call (the forward's thread and autograd's backward thread each
    # hold one) and keeps it for the process: a matmul with its backward
    # first, so "before the first try" holds both
    m0 = torch.cuda.memory_allocated()
    w = torch.ones(256, 256, device=dev, requires_grad=True)
    for dtype in (torch.float32, torch.bfloat16):
        torch.nn.functional.linear(w.to(dtype), w.to(dtype)).float().sum().backward()
    del w
    torch.cuda.synchronize()
    first_use = torch.cuda.memory_allocated() - m0
    messages = []  # the first line of each failed try's error

    def finder_run(keep=None):
        """Tries as (batch size, memory allocated at its start, error type
        or None, loss)."""
        tries = []

        def train_at(batch_size):
            tries.append([batch_size, torch.cuda.memory_allocated(), None, None])
            if keep is not None and len(tries) > 1:
                raise _StopControl()
            ids = torch.as_tensor(rng.randint(0, cfg.vocab_size, (batch_size, s)), device=dev)
            try:
                loss = step({"input_ids": ids, "labels": ids})["loss"].item()
            except Exception as err:
                tries[-1][2] = type(err).__name__
                messages.append(str(err).splitlines()[0][:160])
                model.zero_grad(set_to_none=True)  # a backward cut short leaves some
                if keep is not None:
                    keep.append(err)  # the control: the failed try's frames stay alive
                raise
            tries[-1][3] = loss
            return batch_size, loss

        finder = find_executable_batch_size(train_at, starting_batch_size=SURFACE_FINDER_START)
        try:
            return finder(), tries
        except _StopControl:
            return None, tries

    t0 = time.perf_counter()
    (survivor, loss), tries = finder_run()
    finder_s = time.perf_counter() - t0
    failed = [t for t in tries if t[2] is not None]
    if not any(t[2] == "OutOfMemoryError" for t in failed):
        fail(f"surface (b): no try met torch.cuda.OutOfMemoryError: {tries}")
    if not math.isfinite(loss) or survivor != tries[-1][0] or tries[-1][2] is not None:
        fail(f"surface (b): survivor {survivor}, loss {loss}, tries {tries}")
    leaks = [tries[i + 1][1] - t[1] for i, t in enumerate(tries) if t[2] is not None]
    if any(abs(d) > SURFACE_LEAK_BYTES for d in leaks):
        fail(f"surface (b): memory after a failed try moved {leaks} bytes from its value "
             f"before it (gate {SURFACE_LEAK_BYTES})")
    print(f"surface (b) on {card}: find_executable_batch_size from B "
          f"{SURFACE_FINDER_START} x {s}: tried "
          f"{[(t[0], t[2] or f'loss {t[3]:.5f}') for t in tries]}, survivor B {survivor} "
          f"(loss {loss:.5f}) in {finder_s:.1f} s; memory allocated after each failed try "
          f"minus before it {[round(d / 2**20, 3) for d in leaks]} MiB (gate "
          f"{SURFACE_LEAK_BYTES >> 20} MiB; cuBLAS's first use in both threads held "
          f"{first_use / 2**20:.3f} MiB before the first try); the card said: "
          f"{messages[0]!r}")
    # the control keeps the failed try's exception: the gate must see it
    kept = []
    _, ctl = finder_run(keep=kept)
    ctl_leak = ctl[1][1] - ctl[0][1]
    if not (ctl[0][2] and ctl_leak > SURFACE_LEAK_BYTES):
        fail(f"surface (b) control: keeping the failed try's exception left "
             f"{ctl_leak / 2**20:.1f} MiB, within the gate: the gate is blind ({ctl})")
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    back = torch.cuda.memory_allocated() - ctl[0][1]
    print(f"surface (b) control: the failed try's exception kept alive: memory after it "
          f"{ctl_leak / 2**30:.3f} GiB above before it ({ctl[0][2]} at B {ctl[0][0]}): fails "
          f"the gate; once dropped, {back / 2**20:.3f} MiB")
    if back > SURFACE_LEAK_BYTES:  # below: the survivor's gradients went with the try
        fail(f"surface (b) control: {back} bytes still held once the exception was dropped")

    # (c) Accelerator.profile around two fused steps
    ids = torch.as_tensor(rng.randint(0, cfg.vocab_size, (b, s)), device=dev)
    batch = {"input_ids": ids, "labels": ids}
    step(batch)
    torch.cuda.synchronize()
    trace_dir = tempfile.mkdtemp(prefix="surface-profile-")
    try:
        acc.profile_handler.output_trace_dir = trace_dir
        before = {n: kernels.launch_counts[n] for n in FLASH_KERNELS}
        t0 = time.perf_counter()
        with acc.profile() as prof:
            with annotate("train_step"):
                for _ in range(SURFACE_PROFILE_STEPS):
                    step(batch)
                torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
        counted = {n: kernels.launch_counts[n] - before[n] for n in FLASH_KERNELS}
        size = os.path.getsize(prof.trace_path)
        with open(prof.trace_path) as f:
            trace = _json.load(f)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    events = flash_events(trace)
    seen = {n: events.get(n, 0) for n in FLASH_KERNELS}
    if seen != counted or not all(counted.values()):
        cats = sorted({str(e.get("cat")) for e in trace["traceEvents"]})
        flashy = sorted({e.get("name", "")[:120] for e in trace["traceEvents"]
                         if "flash" in e.get("name", "")})[:6]
        fail(f"surface (c): the trace's kernel events {events} differ from the launch "
             f"counters {counted} (categories {cats}; names holding 'flash': {flashy})")
    spans = [e for e in trace["traceEvents"] if e.get("name") == "train_step"]
    if not spans:
        fail("surface (c): the trace holds no train_step annotation")
    sample = next((str(e.get("cat")) + ": " + e["name"][:90] for e in trace["traceEvents"]
                   if "flash_fwd" in e.get("name", "")
                   and str(e.get("cat", "")).lower() == "kernel"), None)
    print(f"surface (c) on {card}: Accelerator.profile over {SURFACE_PROFILE_STEPS} fused "
          f"steps at B {b} x {s}: trace_0.json {size / 1e6:.1f} MB, "
          f"{len(trace['traceEvents'])} events, {len(spans)} train_step range(s); flash "
          f"kernel events {seen} == launch counters {counted} (#1's event: {sample!r}); "
          f"{prof_s:.1f} s")

    # (d) the prefetching loader against the same loader without prefetch
    class Rows:
        def __init__(self, n, seed):
            self.ids = np.random.RandomState(seed).randint(0, cfg.vocab_size, (n, s))

        def __len__(self):
            return len(self.ids)

        def __getitem__(self, i):
            return {"input_ids": self.ids[i], "labels": self.ids[i]}

    rows = Rows(SURFACE_LOADER_STEPS * b, seed=1)
    plain = Accelerator(mixed_precision="bf16").prepare(
        DataLoader(rows, batch_size=b, shuffle=True, seed=2))
    want, plain_wait = [], []  # the plain loader's batches, and its host wait for each
    it = iter(plain)
    while True:
        t0 = time.perf_counter()
        try:
            want.append(next(it))
        except StopIteration:
            break
        plain_wait.append(time.perf_counter() - t0)
    fetched = acc.prepare(DataLoader(rows, batch_size=b, shuffle=True, seed=2))

    def producers():
        return [t for t in threading.enumerate() if t.name == HostPrefetcher.THREAD_NAME]

    ends, sums, losses, waits = [], [], [], []
    t0 = time.perf_counter()
    body_end = t0
    for i, bt in enumerate(fetched):
        waits.append(time.perf_counter() - body_end)  # the host's wait for batch i
        ends.append(acc.gradient_state.end_of_dataloader)
        w = want[i]
        same = all(bt[k].device == acc.device and torch.equal(bt[k], w[k]) for k in w)
        sums.append((int(bt["input_ids"].sum()), int(w["input_ids"].sum())))
        if not same:
            fail(f"surface (d): batch {i} differs from the loader's without prefetch "
                 f"(checksums {sums[-1]})")
        losses.append(step(bt)["loss"].item())
        body_end = time.perf_counter()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    if len(ends) != SURFACE_LOADER_STEPS or ends != [False] * (len(ends) - 1) + [True]:
        fail(f"surface (d): end_of_dataloader {ends}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"surface (d): losses {losses}")
    after_loop = producers()
    for i, _ in enumerate(fetched):
        if i + 1 == SURFACE_BREAK_AT:
            break
    after_break = producers()
    if after_loop or after_break:
        fail(f"surface (d): producer threads alive after the epoch {after_loop} or the "
             f"break {after_break}")
    print(f"surface (d) on {card}: {len(losses)} steps at B {b} x {s} over a DataLoader with "
          f"prefetch_depth {SURFACE_PREFETCH_DEPTH}: every batch equal on the card to the "
          f"loader's without prefetch (input_ids sums {sums[:3]}...), end_of_dataloader on the "
          f"last only, losses {[round(x, 4) for x in losses[:4]]}...{round(losses[-1], 4)}, "
          f"{loop_s:.1f} s ({1e3 * loop_s / len(losses):.1f} ms/step with the producer and "
          f"the checks); host wait for a batch (median of batches 1..15) "
          f"{1e3 * statistics.median(waits[1:]):.3f} ms with prefetch, "
          f"{1e3 * statistics.median(plain_wait[1:]):.3f} ms from the loader without "
          f"(first batch {1e3 * waits[0]:.1f} / {1e3 * plain_wait[0]:.1f} ms); no producer "
          f"thread after the epoch or a break at batch {SURFACE_BREAK_AT}")
    launches = {n: kernels.launch_counts[n] for n in FLASH_KERNELS}
    if not all(launches.values()):
        fail(f"surface: a flash kernel was not launched on this path: {launches}")
    del model, opt, step, acc, plain, fetched, want
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# fp8 training and inference (train_fp8_path): small_1b at full width with
# the projections through ops/fp8.py (torch._scaled_mm on the fp8 tensor
# cores), attention on the flash kernels in bf16.
# (a) the products against their plain version (fp32 matmul of the same
# fp8 operands, scaled, rounded to bf16 once): both round one fp32 sum to
# bf16, so they may part by one bf16 step of an entry (2^-8 relative) plus
# the sums' order; the limit is 2^-7 of the output's largest |entry|
FP8_PRODUCT_RTOL = 2.0 ** -7
FP8_TOKENS = 16384  # TRAIN_B x TRAIN_S: the training step's tokens a product
FP8_SHAPES = ((2048, 2048), (2048, 1024), (2048, 5632), (5632, 2048))  # (K, N)
FP8_FLOPS_PER_S = 1979e12  # the H100's dense fp8 tensor-core peak
# (b) current scaling: steps on one fixed batch at constant lr, and the
# first step's gap to the bf16 control on the same weights and batch. The
# e4m3 forward operands round each value by up to 2^-4 relative and the
# e5m2 gradients by 2^-3, about evenly up and down: the loss of a mean
# over 16384 tokens should move far less than 1%, the grad norm (a sum of
# squares, where rounding noise adds) by a few %
FP8_STEPS = 8
FP8_LOSS_GAP = 1e-2
FP8_GRAD_NORM_GAP = 0.1
# products a block runs in one step: 7 projections, forward, again in the
# save_attention recompute, and their two backward products
FP8_PRODUCTS_PER_LAYER = 7 * 4
# (c) delayed scaling: history length, updates of two micro-batches
FP8_HISTORY = 16
FP8_DELAYED_STEPS = 4
# (d) generate(): prompt, new tokens; the teacher-forced logits' gap to the
# bf16 model on the same weights, over the largest |logit|: two e4m3
# steps (2^-3) at most
FP8_GEN = (2, 512, 16)
FP8_LOGIT_GAP = 0.25
# (e) the delayed resume: layers, updates before and after the save
FP8_RESUME = (2, 2, 2)


def fp8_products(dev, card: str):
    """(a): each projection's three products at the training step's shapes
    on the card against the plain version, the quantizers bit for bit
    against the CPU's, and each product's time beside bf16 torch.matmul."""
    import torch

    from accelerate_tpu_torch.ops import fp8

    gen = torch.Generator(device=dev).manual_seed(24)
    m = FP8_TOKENS
    for k, n in FP8_SHAPES:
        a = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        b = (torch.randn(k, n, generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
        g = (torch.randn(m, n, generator=gen, device=dev) * 1e-4).to(torch.bfloat16)
        qs = {}
        for name, x, dt, fmax in (("a", a, fp8.E4M3, fp8.E4M3_MAX),
                                  ("b", b, fp8.E4M3, fp8.E4M3_MAX),
                                  ("g", g, fp8.E5M2, fp8.E5M2_MAX)):
            q, s = fp8.quantize_fp8(x, dt, fmax)
            q_cpu, s_cpu = fp8.quantize_fp8(x.cpu(), dt, fmax)
            if not (torch.equal(fp8.amax_of(x).cpu(), fp8.amax_of(x.cpu()))
                    and torch.equal(s.cpu(), s_cpu)
                    and torch.equal(q.view(torch.uint8).cpu(), q_cpu.view(torch.uint8))):
                fail(f"fp8 quantizer of {name} [{tuple(x.shape)}]: the card's amax, scale or "
                     "bytes differ from the CPU's")
            qs[name] = (q, s)
        (qa, sa), (qb, sb), (qg, sg) = qs["a"], qs["b"], qs["g"]
        cases = (("forward a @ b", qa, qb, sa, sb, a, b),
                 ("da = g @ b^T", qg, qb.t(), sg, sb, g, b.t()),
                 ("db = a^T @ g", qa.t(), qg, sa, sg, a.t(), g))
        for what, qx, qy, sx, sy, x, y in cases:
            got = fp8.scaled_mm(qx, qy, sx, sy, torch.bfloat16)
            want = fp8.scaled_product_reference(qx, qy, sx, sy, torch.bfloat16)
            err = (got.float() - want.float()).abs().max().item()
            top = want.float().abs().max().item()
            if not (math.isfinite(err) and err <= FP8_PRODUCT_RTOL * top):
                fail(f"fp8 product {what} at K {k}, N {n}: max abs err {err} vs plain, "
                     f"beyond {FP8_PRODUCT_RTOL} x {top}")
            mm, kk, nn = qx.shape[0], qx.shape[1], qy.shape[1]
            ms = cuda_time_ms(lambda: fp8.scaled_mm(qx, qy, sx, sy, torch.bfloat16))
            plain_ms = cuda_time_ms(lambda: fp8.scaled_product_reference(
                qx, qy, sx, sy, torch.bfloat16), iters=5)
            bf16_ms = cuda_time_ms(lambda: torch.matmul(x, y))
            flops = 2 * mm * kk * nn
            # fp8 operands read once, the bf16 output written once; fp8 peak
            t_bytes = (mm * kk + kk * nn + 2 * mm * nn) / HBM_BYTES_PER_S * 1e3
            t_ops = flops / FP8_FLOPS_PER_S * 1e3
            bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
            print(f"fp8 product on {card}: {what} [{mm}, {kk}] @ [{kk}, {nn}] (the "
                  f"{k}->{n} projection): {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s; "
                  f"_scaled_mm with its layout copies), plain {plain_ms:.4f} ms, bf16 "
                  f"torch.matmul {bf16_ms:.4f} ms ({flops / bf16_ms / 1e9:.1f} TFLOP/s), bound "
                  f"{bound_ms:.4f} ms ({bound_by}, fp8 peak 1979 TFLOP/s), max abs err "
                  f"{err:.3e} (limit {FP8_PRODUCT_RTOL * top:.3e})")
        quant_ms = cuda_time_ms(lambda: fp8.quantize_fp8(a))
        print(f"fp8 quantize on {card}: e4m3 of a [{m}, {k}] bf16 (amax, scale, bytes) "
              f"{quant_ms:.4f} ms, bound {bound(2 * m * k + m * k, 0)[0]:.4f} ms (bytes)")
        del a, b, g, qs, cases, qa, qb, qg
    torch.cuda.empty_cache()


def fp8_histories_stacked(model):
    import torch

    return torch.stack(list(model.fp8_histories().values()))


def train_fp8_path(dev, card: str):
    """mixed_precision="fp8" on small_1b at full width: (a) the products,
    (b) current scaling, (c) delayed scaling, (d) generate() on an fp8
    model, (e) a delayed resume. Returns the flash kernels' launches of
    (b) and the dense decode kernel's of (d)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.accelerator import global_grad_norm
    from accelerate_tpu_torch.generation import generate
    from accelerate_tpu_torch.models.configs import DecoderConfig
    from accelerate_tpu_torch.models.convert import random_params
    from accelerate_tpu_torch.models.decoder import DecoderLM
    from accelerate_tpu_torch.ops import fp8, kernels
    from accelerate_tpu_torch.telemetry.metrics import fp8_amax_health

    t_phase = time.perf_counter()
    fp8_products(dev, card)
    cfg = DecoderConfig.small_1b()
    b, s = TRAIN_B, TRAIN_S
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (b, s))
    batch = {k: torch.as_tensor(ids, device=dev) for k in ("input_ids", "labels")}

    def fresh(config, seed=0):
        model = DecoderLM(config, device=dev, param_dtype=torch.float32)
        return model.load_params(random_params(config, seed=seed, device=dev,
                                               dtype=torch.float32))

    def loss_and_norm(model, precision):
        acc = Accelerator(mixed_precision=precision)
        acc.prepare(model)
        model.zero_grad(set_to_none=True)
        out = model(**batch)
        out["loss"].backward()
        norm = global_grad_norm(model.parameters()).item()
        model.zero_grad(set_to_none=True)
        return out["loss"].item(), norm

    # (b) current scaling, against the bf16 control on the same weights
    model = fresh(cfg)
    loss_b, norm_b = loss_and_norm(model, "bf16")
    model.set_param_cast(None)
    acc = Accelerator(mixed_precision="fp8")
    opt = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    model, opt = acc.prepare(model, opt)
    if not (model.config.use_fp8 and model.config.fp8_recipe == "current"):
        fail(f"Accelerator(mixed_precision='fp8') left use_fp8={model.config.use_fp8}")
    loss_8, norm_8 = loss_and_norm(model, "fp8")
    if not (abs(loss_8 - loss_b) <= FP8_LOSS_GAP * abs(loss_b)
            and abs(norm_8 - norm_b) <= FP8_GRAD_NORM_GAP * abs(norm_b)):
        fail(f"fp8 first step: loss {loss_8} / grad norm {norm_8} vs bf16 {loss_b} / {norm_b}: "
             f"beyond {FP8_LOSS_GAP} / {FP8_GRAD_NORM_GAP} relative")
    print(f"train fp8 path: first step on the seed weights, fp8 (current) vs bf16: loss "
          f"{loss_8:.6f} vs {loss_b:.6f} (rel {abs(loss_8 - loss_b) / abs(loss_b):.2e}, gap "
          f"{FP8_LOSS_GAP}), grad norm {norm_8:.6f} vs {norm_b:.6f} (rel "
          f"{abs(norm_8 - norm_b) / abs(norm_b):.2e}, gap {FP8_GRAD_NORM_GAP})")
    step = acc.build_train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, step_ms, products = [], [], []
    for _ in range(FP8_STEPS):
        before = dict(kernels.launch_counts)
        fp8.reset_product_count()
        t0 = time.perf_counter()
        losses.append(step(batch)["loss"].item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        products.append(fp8.product_count)
        for name in FLASH_KERNELS:
            got = kernels.launch_counts[name] - before[name]
            if got != cfg.num_layers:
                fail(f"{name}: {got} launches in one fp8 step, expected {cfg.num_layers}")
    launches = {name: kernels.launch_counts[name] for name in FLASH_KERNELS}
    want_products = FP8_PRODUCTS_PER_LAYER * cfg.num_layers
    if set(products) != {want_products}:
        fail(f"fp8 products a step {products}, expected {want_products}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"fp8 loss did not fall over {FP8_STEPS} steps at lr {TRAIN_LR}: {losses}")
    ms = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    tokens_per_s = b * s / (ms / 1e3)
    flops_per_token = 6 * cfg.num_params + 6 * cfg.num_layers * s * cfg.embed_dim
    mfu = tokens_per_s * flops_per_token / BF16_FLOPS_PER_S
    print(f"train fp8 path on {card}: current scaling, {FP8_STEPS} build_train_step steps on "
          f"one batch at lr {TRAIN_LR}: loss {[round(x, 4) for x in losses]}; "
          f"{tokens_per_s:.1f} tokens/s, {ms:.1f} ms/step (median of steady steps "
          f"{[round(x, 1) for x in step_ms]}), MFU {100 * mfu:.2f}% over 989 TFLOP/s bf16, "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {launches}, "
          f"{want_products} torch._scaled_mm products a step")
    profile_train(step, batch, card, "one fp8 (current) build_train_step step")
    del model, opt, acc, step
    gc.collect()
    torch.cuda.empty_cache()

    # (c) delayed scaling, two micro-batches an update
    dcfg = DecoderConfig.small_1b(use_fp8=True, fp8_recipe="delayed",
                                  fp8_amax_history_len=FP8_HISTORY)
    model = fresh(dcfg)
    acc = Accelerator(mixed_precision="fp8", gradient_accumulation_steps=2)
    opt = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    model, opt = acc.prepare(model, opt)
    if len(model.fp8_histories()) != 7 * dcfg.num_layers:
        fail(f"{len(model.fp8_histories())} amax histories, expected {7 * dcfg.num_layers}")
    step = acc.build_train_step()
    delayed_losses, delayed_ms = [], []
    for i in range(FP8_DELAYED_STEPS):
        prev = fp8_histories_stacked(model)
        t0 = time.perf_counter()
        delayed_losses.append(step(batch)["loss"].item())
        delayed_ms.append((time.perf_counter() - t0) * 1e3)
        now = fp8_histories_stacked(model)
        if (now[..., 0].any() or not torch.equal(now[..., 2:], prev[..., 1:-1])
                or not (now[..., 1] > 0).all()):
            fail(f"delayed update {i}: the histories did not advance one slot "
                 "(slot 0 zero, slot 1 this update's amaxes, the rest shifted)")
    health = fp8_amax_health(acc.extra_state["fp8_stats"])
    if not (health["sys/fp8_amax_stale_frac"] == 0.0 and health["sys/fp8_amax_max"] > 0):
        fail(f"fp8_amax_health after {FP8_DELAYED_STEPS} updates: {health}")
    kept = fp8_histories_stacked(model)
    user_step = acc.build_train_step(loss_fn=lambda m, mb: m(**mb)["loss"])
    user_losses = [user_step(batch)["loss"].item() for _ in range(2)]
    if not torch.equal(fp8_histories_stacked(model), kept):
        fail("the user loss_fn steps moved the amax histories")
    if not all(math.isfinite(x) for x in delayed_losses + user_losses):
        fail(f"delayed fp8 losses {delayed_losses} {user_losses}")
    print(f"train fp8 path on {card}: delayed scaling (history {FP8_HISTORY}, 2 micro-batches "
          f"an update): losses {[round(x, 4) for x in delayed_losses]}, "
          f"{[round(x, 1) for x in delayed_ms]} ms/update, each update one slot on (slot 0 zero "
          f"after the roll); fp8_amax_health {health}; 2 user loss_fn updates (losses "
          f"{[round(x, 4) for x in user_losses]}) left the histories as they were")
    del model, opt, acc, step, user_step
    gc.collect()
    torch.cuda.empty_cache()

    # (d) generate() on an fp8 model, captured and uncaptured
    gb, gs, new = FP8_GEN
    weights = random_params(cfg, seed=0, device=dev)
    model8 = DecoderLM(DecoderConfig.small_1b(use_fp8=True), device=dev).load_params(weights)
    model16 = DecoderLM(cfg, device=dev).load_params(weights)
    prompt = torch.as_tensor(np.random.RandomState(1).randint(3, cfg.vocab_size, (gb, gs)),
                             device=dev)
    generate(model8, prompt[:, :128], max_new_tokens=4)  # warm-up, not counted
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    captured = generate(model8, prompt, max_new_tokens=new)
    torch.cuda.synchronize()
    gen_launches = {"dense_decode": kernels.launch_counts["dense_decode"],
                    "flash_fwd": kernels.launch_counts["flash_fwd"]}
    with mock_captures(False):
        uncaptured = generate(model8, prompt, max_new_tokens=new)
    if not torch.equal(captured, uncaptured):
        fail("fp8 generate(): the captured decode step's tokens differ from the uncaptured")
    if gen_launches["dense_decode"] < 1:
        fail("fp8 generate() launched no dense decode kernel")
    with torch.no_grad():
        l8 = model8(captured)[:, gs - 1:-1]
        l16 = model16(captured)[:, gs - 1:-1]
    gap = ((l8 - l16).abs().max() / l16.abs().max()).item()
    rms_gap = ((l8 - l16).float().norm() / l16.float().norm()).item()
    if not gap < FP8_LOGIT_GAP:
        fail(f"fp8 generate(): teacher-forced logits {gap} of the largest from the bf16 "
             f"model's, beyond {FP8_LOGIT_GAP}")
    agree = (l8.argmax(-1) == l16.argmax(-1)).float().mean().item()
    print(f"train fp8 path: generate() on the fp8 small_1b (B {gb}, prompt {gs}, {new} new "
          f"tokens): captured == uncaptured tokens; teacher-forced logits vs the bf16 model "
          f"on the same weights: max gap {gap:.4f} of the largest |logit| (margin "
          f"{FP8_LOGIT_GAP}), rms gap {rms_gap:.4f} of the logits' rms, greedy argmax "
          f"agreeing at {100 * agree:.1f}% of positions; "
          f"launches {gen_launches}")
    del model8, model16, weights
    gc.collect()
    torch.cuda.empty_cache()

    # (e) a delayed save_state / load_state resume, bit for bit
    layers, before_save, after = FP8_RESUME
    rcfg = DecoderConfig.small_1b(num_layers=layers, use_fp8=True, fp8_recipe="delayed",
                                  fp8_amax_history_len=FP8_HISTORY)
    rng = np.random.RandomState(5)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                zip(("input_ids", "labels"), [rng.randint(0, cfg.vocab_size, (b, s))] * 2)}
               for _ in range(before_save + after)]

    def run(seed, load=None, save=None, first=0):
        acc = Accelerator(mixed_precision="fp8")
        model = fresh(rcfg, seed)
        opt = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=1e-4)
        model, opt = acc.prepare(model, opt)
        if load is not None:
            acc.load_state(load)
        step = acc.build_train_step()
        losses = []
        for i in range(first, len(batches)):
            losses.append(step(batches[i])["loss"].item())
            if save is not None and i + 1 == before_save:
                acc.save_state(save)
        return losses[-after:], model

    folder = tempfile.mkdtemp()
    try:
        want, saver = run(0, save=folder)
        got, resumed = run(1, load=folder, first=before_save)
        same = all(torch.equal(p, q) for p, q in zip(saver.state_dict().values(),
                                                     resumed.state_dict().values()))
        if got != want or not same:
            fail(f"delayed fp8 resume: losses {got} vs {want}, weights and histories "
                 f"{'equal' if same else 'differ'}")
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    print(f"train fp8 path: delayed resume at {layers} layers: {after} updates after "
          f"load_state bit for bit (losses {want}, every weight and amax history equal); "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    del saver, resumed
    gc.collect()
    torch.cuda.empty_cache()
    launches["dense_decode"] = gen_launches["dense_decode"]
    launches["flash_fwd"] += gen_launches["flash_fwd"]
    return launches


def main():
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script runs only on a GPU")
    try:
        import accelerate_tpu_torch
    except ImportError as exc:
        fail(f"accelerate_tpu_torch is not importable beside this script ({exc})")
    pkg = Path(accelerate_tpu_torch.__file__).resolve().parent
    if pkg.parent != ROOT:
        fail(f"accelerate_tpu_torch comes from {pkg}, not from this checkout")
    if "jax" in sys.modules or "accelerate_tpu" in sys.modules:
        fail("the port imported jax or accelerate_tpu")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)

    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.utils import cuda_graphs

    # every CUDA graph the port captures prints its capture's seconds (its
    # warm-up included) and the memory reserved after it, once
    capture = cuda_graphs.capture

    def logged_capture(body, device, **kw):
        step = capture(body, device, **kw)
        CAPTURE_SECONDS.append(step.seconds)
        name = getattr(body, "__qualname__", None) or body.func.__qualname__
        print(f"graph capture: {name} in {step.seconds:.3f} s, "
              f"{sum(step.launches.values())} kernel launches a replay, memory reserved "
              f"{torch.cuda.memory_reserved() / 1e9:.3f} GB")
        return step

    cuda_graphs.capture = logged_capture

    # wall seconds of each phase, printed on one line with their total
    phase_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    t0 = time.perf_counter()
    reports = kernels.build()
    print(f"build: {sorted(kernels.KERNELS)} with nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, report in sorted(reports.items()):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    sass_gate(TENSOR_CORE_KERNELS, ("HGMMA", "UTMALDG"), "run on the tensor cores through TMA")
    sass_gate(DECODE_KERNELS + DECODE_KERNELS_F16, ("HMMA", "LDGSTS"),
              "run mma.sync over cp.async tiles")
    for sfx, mangled in DTYPE_MANGLED.items():
        sass_gate(["dense_decode" + sfx], ("HMMA", "LDGSTS"),
                  "run mma.sync over cp.async tiles at D 64", fragment=(D64_SPLIT, mangled),
                  label=" (D 64)")
    decode_spill_gate(reports)
    d64_spill_gate(reports)
    phase_s["build and SASS gates"] = time.perf_counter() - t0

    dev = torch.device("cuda")
    # the bf16 serving, training and dense decode phases draw their inputs
    # from `gen` in a fixed order, so each tolerance holds on the inputs it
    # was shown on; the quantized entries' and the verify step's inputs
    # come from their own generator and move none of those
    gen = torch.Generator(device=dev).manual_seed(0)
    gen_new = torch.Generator(device=dev).manual_seed(1)
    # (in this order: each phase draws from the generators where the
    # single expression that listed them did)
    rows = [timed("paged decode kernel", decode_phase, gen, dev, gen_new),
            timed("paged decode quant kernel", paged_decode_quant_phase, gen_new, dev),
            *timed("ragged prefill kernels", prefill_phases, gen, gen_new, dev),
            *timed("flash kernels", flash_phases, gen, dev),
            # the fp16 entries draw from their own generator: the bf16
            # phases' inputs do not move
            *timed("flash kernels fp16", flash_phases,
                   torch.Generator(device=dev).manual_seed(3), dev, torch.float16),
            *timed("dense decode kernels", dense_decode_phases, gen, dev),
            # its own generators: no earlier phase's inputs move
            timed("dense decode D 64 kernel", t5_decode_phase, dev),
            # the fp16 serving entries, on generators of their own too
            *timed("serving kernels fp16", serving_kernel_phases_f16, dev)]
    # each path is driven with the counts reset just before it and read
    # just after; a kernel's launches come from its own path (the dense
    # decode kernel's from generate() and the flat engine together, the
    # quantized paged kernels' from the int8 and int4 runs together)
    launches, serving = timed("main path", main_path, dev, card)
    model = serving.pop("model")
    main_run = serving.pop("main")
    flat_launches = timed("flat path", lambda: flat_path(dev, card, model, **serving))
    launches.update(timed("quant path", lambda: quant_path(dev, card, model, **serving)))
    timed("drift", drift_phase, model, serving["prompts"], card)
    timed("spec path", spec_path, dev, card, model, serving["prompt"])
    # the fp16 serving entries' launches: their own model's runs
    launches.update(timed("fp16 serve path", fp16_serve_path, dev, card, serving["prompts"],
                          serving["prompt"], serving["paged"]))
    # the MoE paths' launches stay off the kernels line, as the replica's:
    # they print on lines of their own, each run's from its own reset
    moe, moe_launches = timed("moe serve path", moe_serve_path, dev, card, serving["prompts"],
                              serving["paged"])
    print(f"moe serve path launches: {json.dumps(moe_launches)}")
    moe_gen_launches = timed("moe generate path", moe_generate_path, dev, card, moe)
    print(f"moe generate path launches: {json.dumps(moe_gen_launches)}")
    del moe
    gc.collect()
    torch.cuda.empty_cache()
    # the replica's launches stay off the kernels line: its rows keep the
    # launches of their own paths
    replica_launches, wave = timed("replica path", replica_path, dev, card, model,
                                   serving["prompts"])
    print(f"replica path launches: {json.dumps(replica_launches)}")
    # the burst path's launches stay off the kernels line too: they must
    # equal main path's, which are on it
    timed("burst path", burst_path, dev, card, model, serving["prompts"], main_run, wave)
    # and so do the scheduled path's: its gates hold them to its own steps
    timed("scheduled path", scheduled_path, dev, card, model)
    timed("telemetry replica path", telemetry_replica_path, dev, card, model,
          serving["prompts"])
    # the fleet path's launches stay off the kernels line too, as the replica's
    fleet_launches = timed("fleet path", fleet_path, dev, card, model)
    print(f"fleet path launches: {json.dumps(fleet_launches)}")
    # and so do the fleet-ops path's (its in-process engine's, step (a))
    fleet_ops_launches = timed("fleet_ops path", fleet_ops_path, dev, card, model)
    print(f"fleet_ops path launches: {json.dumps(fleet_ops_launches)}")
    del serving, model
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(timed("train path", train_path, dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(timed("train fp16 path", train_fp16_path, dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    # its flash launches add to the training path's rows, its dense decode
    # launches (generate() on the fp8 model) to the dense decode row
    fp8_launches = timed("train fp8 path", train_fp8_path, dev, card)
    print(f"train fp8 path launches: {json.dumps(fp8_launches)}")
    gc.collect()
    torch.cuda.empty_cache()
    moe_train_launches = timed("moe train path", moe_train_path, dev, card)
    print(f"moe train path launches: {json.dumps(moe_train_launches)}")
    gc.collect()
    torch.cuda.empty_cache()
    # its flash launches stay off the kernels line, as the MoE paths': they
    # print on a line of their own, from the phase's own reset
    surface_launches = timed("accelerate_surface_path", accelerate_surface_path, dev, card)
    print(f"accelerate_surface_path launches: {json.dumps(surface_launches)}")
    gc.collect()
    torch.cuda.empty_cache()
    # its flash launches stay off the kernels line, as the replica's: the
    # rows keep the training path's
    timed("checkpoint path", checkpoint_path, dev, card)
    gc.collect()
    torch.cuda.empty_cache()  # the training paths' memory, before llama_7b
    gen_launches, gen = timed("generate path", generate_path, dev, card)
    launches.update(gen_launches)
    # the dispatch path frees generate_path's model once it has written
    # the checkpoint from it
    dispatch_launches = timed("dispatch path", dispatch_path, dev, card, gen)
    del gen
    gc.collect()
    torch.cuda.empty_cache()
    # the T5 family's paths: the "dense_decode (D 64)" row's launches are
    # seq2seq_path's alone (the dispatch phase holds its own to the same
    # count); the training paths launch no kernel
    s2s_launches, s2s = timed("seq2seq_path", seq2seq_path, dev, card)
    launches["dense_decode (D 64)"] = s2s_launches["dense_decode"]
    timed("seq2seq_dispatch", seq2seq_dispatch, dev, card, s2s)
    del s2s
    gc.collect()
    torch.cuda.empty_cache()
    timed("seq2seq_train_path", seq2seq_train_path, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    timed("encoder_train_path", encoder_train_path, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    timed("resnet train path", resnet_train_path, dev, card)
    launches["dense_decode"] += flat_launches + dispatch_launches["dense_decode"]
    launches["flash_fwd"] += dispatch_launches["flash_fwd"]
    for name, n in fp8_launches.items():
        launches[name] += n
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["launches"] < 1:
            fail(f"{row['name']} was not launched on its path")
    if "jax" in sys.modules or "accelerate_tpu" in sys.modules:
        fail("the port imported jax or accelerate_tpu")
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
          + f"; total {time.perf_counter() - t_start:.1f}")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
