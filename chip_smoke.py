"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels of ``accelerate_tpu_torch/csrc`` with
nvcc for sm_90a, holds each against its plain PyTorch version at the
paged serving path's shapes (small_1b: H=16, KVH=8, D=128, page 16),
then serves small_1b at full width (16 layers, random weights from a
seed) through ``ServingEngine`` and checks the generated tokens against
a teacher-forced plain forward. Prints the card, the per-kernel
numbers, and as its last line
``{"ok": true, "device": {"platform": "gpu", ...}}``.

Exits non-zero, with no result line, when CUDA is absent, when the
package is not beside this script, or when any phase fails.

fp32 matmuls and convolutions are kept at full fp32 (TF32 off) so the
plain versions are exact fp32 references.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
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
MAX_CACHE = 2048


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name: str, got, want) -> float:
    """Max abs error of ``got`` vs ``want``; fails past the stated tolerance."""
    diff = (got.float() - want.float()).abs()
    limit = KERNEL_ATOL + KERNEL_RTOL * want.float().abs()
    err = diff.max().item()
    if not math.isfinite(err) or bool((diff > limit).any()):
        fail(f"{name} vs plain: max abs err {err} exceeds {KERNEL_ATOL} + "
             f"{KERNEL_RTOL} * |plain|")
    return err


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------


def decode_phase(gen, dev):
    """Paged decode: 8 live slots of mixed length + one parked slot."""
    import torch
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.ops.attention import (
        gather_kv_pages, paged_decode_attention, paged_decode_reference,
    )

    lengths = [17, 130, 256, 511, 700, 1024, 1300, 1500]
    p_per_slot = MAX_CACHE // PAGE
    b = len(lengths) + 1  # + one parked slot
    live_pages = [-(-n // PAGE) for n in lengths]
    num_pages = 1 + sum(live_pages)
    host_gen = torch.Generator().manual_seed(0)
    perm = (torch.randperm(num_pages - 1, generator=host_gen) + 1).tolist()
    table = torch.zeros((b, p_per_slot), dtype=torch.int32)
    pos = torch.zeros((b, 1), dtype=torch.int32)
    at = 0
    for s, n in enumerate(lengths):
        table[s, : live_pages[s]] = torch.tensor(perm[at: at + live_pages[s]])
        at += live_pages[s]
        pos[s, 0] = n - 1
    pos[b - 1, 0] = MAX_CACHE - 1  # parked: all-parking table row
    table, pos = table.to(dev), pos.to(dev)
    q = torch.randn((b, H, 1, D), generator=gen, device=dev).to(torch.bfloat16)
    k_pages = torch.randn((num_pages, KVH, PAGE, D), generator=gen, device=dev).to(torch.bfloat16)
    v_pages = torch.randn((num_pages, KVH, PAGE, D), generator=gen, device=dev).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(D)

    def run_kernel():
        return paged_decode_attention(q, k_pages, v_pages, page_table=table, q_positions=pos)

    def run_plain():
        return paged_decode_reference(q, k_pages, v_pages, table, pos, scale)

    before = kernels.launch_counts["paged_decode"]
    out_k = run_kernel()
    torch.cuda.synchronize()
    if kernels.launch_counts["paged_decode"] != before + 1:
        fail("paged_decode wrapper did not count its launch")
    out_p = run_plain()
    err = check_close("paged_decode", out_k, out_p)
    ms = cuda_time_ms(run_kernel)
    plain_ms = cuda_time_ms(run_plain)
    live_ms = cuda_time_ms(lambda: paged_decode_attention(
        q[:-1], k_pages, v_pages, page_table=table[:-1], q_positions=pos[:-1]))

    k_full = gather_kv_pages(k_pages, table)
    v_full = gather_kv_pages(v_pages, table)
    mask = (torch.arange(k_full.shape[2], device=dev)[None, None, None, :]
            <= pos[:, None, :, None])
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, k_full, v_full, attn_mask=mask, scale=scale, enable_gqa=True))

    # bytes: q, out, tables once, and every distinct K/V page the live
    # ranges touch (the parked slot's row is one parking page)
    pages_read = set()
    for s in range(b):
        n_pages = int(pos[s, 0].item()) // PAGE + 1
        pages_read.update(table[s, :n_pages].tolist())
    kv_bytes = len(pages_read) * KVH * PAGE * D * 2 * 2
    nbytes = 2 * q.numel() * 2 + kv_bytes + table.numel() * 4 + pos.numel() * 4
    attended = sum(int(p) + 1 for p in pos[:, 0].tolist())  # kv per query row
    flops = 4 * D * H * attended
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"kernel paged_decode: slots {b} (lengths {lengths} + parked), "
          f"max_abs_err {err:.3e} (tol {KERNEL_ATOL} + {KERNEL_RTOL}*|plain|), kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by}), "
          f"library sdpa {library_ms:.4f} ms; kernel without the parked slot "
          f"{live_ms:.4f} ms")
    return {"name": "paged_decode", "route": "cuda",
            "source": "accelerate_tpu_torch/csrc/paged_decode.cu",
            "replaces": "accelerate_tpu/ops/attention.py:926",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def prefill_phase(gen, dev):
    """Packed ragged prefill: a 512-row pack of three slots — one with an
    arena prefix (hist > 0), one ending mid-block on pad rows, and one
    whole pad block."""
    import torch
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.ops.attention import (
        PREFILL_TOKEN_BLOCK, gather_kv_pages, ragged_prefill_attention,
        ragged_prefill_reference,
    )

    bt = PREFILL_TOKEN_BLOCK
    cap = 512
    packs = [(0, 300, 256), (1, 0, 243)]  # (slot, hist, tail)
    n_slots = 3
    p_per_slot = 64  # 1024 positions: covers hist + tail of every pack
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
    if cap - r < bt:
        fail("prefill phase pack leaves no whole pad block")
    num_pages = next_page
    table, row_slot, row_pos, slot_hist = (
        t.to(dev) for t in (table, row_slot, row_pos, slot_hist))

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k_new, v_new = rnd(1, H, cap, D), rnd(1, KVH, cap, D), rnd(1, KVH, cap, D)
    k_pages, v_pages = rnd(num_pages, KVH, PAGE, D), rnd(num_pages, KVH, PAGE, D)
    scale = 1.0 / math.sqrt(D)
    kw = dict(page_table=table, row_slot=row_slot, row_pos=row_pos,
              slot_hist=slot_hist)

    def run_kernel():
        return ragged_prefill_attention(q, k_new, v_new, k_pages, v_pages, **kw)

    def run_plain():
        return ragged_prefill_reference(q, k_new, v_new, k_pages, v_pages, table,
                                        row_slot, row_pos, slot_hist, scale)

    before = kernels.launch_counts["ragged_prefill"]
    out_k = run_kernel()[0]
    torch.cuda.synchronize()
    if kernels.launch_counts["ragged_prefill"] != before + 1:
        fail("ragged_prefill wrapper did not count its launch")
    out_p = run_plain()[0]
    err = check_close("ragged_prefill", out_k, out_p)
    pad = (row_pos < 0)
    if out_k[0][:, pad].abs().max().item() != 0.0:
        fail("ragged_prefill pad rows are not exactly 0")
    ms = cuda_time_ms(run_kernel)
    plain_ms = cuda_time_ms(run_plain, iters=5, warmup=1)

    # yardstick: SDPA over a dense layout holding each slot's gathered
    # arena prefix followed by the packed fresh rows, masked alike
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
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, k_dense, v_dense, attn_mask=mask[None, None], scale=scale,
        enable_gqa=True))

    hist_pages = sum(-(-hist // PAGE) for _, hist, _ in packs)
    nbytes = (2 * q.numel() * 2 + (k_new.numel() + v_new.numel()) * 2
              + hist_pages * KVH * PAGE * D * 2 * 2
              + (table.numel() + 2 * cap + n_slots) * 4)
    attended = sum((hist + tail) * (hist + tail + 1) // 2 - hist * (hist + 1) // 2
                   for _, hist, tail in packs)
    flops = 4 * D * H * attended
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"kernel ragged_prefill: cap {cap}, packs (slot, hist, tail) {packs} "
          f"+ pad block, max_abs_err {err:.3e} (tol {KERNEL_ATOL} + {KERNEL_RTOL}*|plain|), kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us "
          f"({bound_by}), library sdpa {library_ms:.4f} ms")
    return {"name": "ragged_prefill", "route": "cuda",
            "source": "accelerate_tpu_torch/csrc/ragged_prefill.cu",
            "replaces": "accelerate_tpu/ops/attention.py:1469",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def main_path(dev, card: str):
    """Serve small_1b at full width through the paged ServingEngine."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.models.configs import DecoderConfig
    from accelerate_tpu_torch.models.convert import random_params
    from accelerate_tpu_torch.models.decoder import DecoderLM
    from accelerate_tpu_torch.ops import kernels
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
    engine = ServingEngine(model, **eng_kw)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new_tokens=new_tokens, seed=i)
            for i, p in enumerate(prompts)]
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)

    for r in reqs:
        if r.outcome != "finished" or len(r.tokens) != new_tokens:
            fail(f"request {r.id} ended {r.outcome} with {len(r.tokens)} tokens")
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

    # teacher-forced plain forward (mha_reference, causal, no cache)
    worst_gap, exact, total = 0.0, 0, 0
    with torch.no_grad():
        for r in reqs:
            seq = torch.as_tensor(r.result(), dtype=torch.long, device=dev)[None]
            logits = model(seq)[0]
            n = r.prompt.size
            rows = logits[n - 1: n - 1 + new_tokens]
            toks = torch.as_tensor(r.tokens, device=dev)
            gap = rows.max(dim=-1).values - rows.gather(1, toks[:, None])[:, 0]
            worst_gap = max(worst_gap, gap.max().item())
            exact += int((gap == 0).sum().item())
            total += new_tokens
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
          f"{m['serving/ttft_ms_p50']:.2f} ms, decode "
          f"{m['serving/decode_step_ms_p50']:.3f} ms/step (p50)")
    profile_decode(model, eng_kw, prompt, card)
    return launches


def profile_decode(model, eng_kw, prompt, card: str, steps: int = 5):
    """Where a decode step's time goes: torch.profiler over a few steps
    with all 8 slots live at ~400 tokens. Prints the device-busy share
    of the wall and the kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch.serving.engine import ServingEngine

    engine = ServingEngine(model, **eng_kw)
    for _ in range(8):
        # budget outlasts the window: no slot finishes and parks inside it
        engine.submit(prompt(400), max_new_tokens=steps + 16)
    while engine._queue or engine._admitting is not None:
        engine.step()
    engine.step()  # one plain step outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        print("profile: the profiler recorded no device time (not measured)")
        return
    print(f"profile on {card}: {steps} decode steps, 8 live slots at ~400 "
          f"tokens: wall {wall_ms / steps:.3f} ms/step, device busy "
          f"{busy_ms / steps:.3f} ms/step ({100 * busy_ms / wall_ms:.1f}% of "
          f"wall, idle {100 - 100 * busy_ms / wall_ms:.1f}%)")
    for ms, count, key in sorted(rows, reverse=True)[:8]:
        print(f"  {ms / steps:8.3f} ms/step  {count // steps:4d}/step  {key[:90]}")


def main():
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

    t0 = time.perf_counter()
    reports = kernels.build()
    print(f"build: {sorted(kernels.KERNELS)} with nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, report in sorted(reports.items()):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = [decode_phase(gen, dev), prefill_phase(gen, dev)]
    launches = main_path(dev, card)
    for row in rows:
        row["launches"] = launches[row["name"]]
    for row in rows:
        if row["launches"] < 1:
            fail(f"{row['name']} was not launched on the main path")
    if "jax" in sys.modules or "accelerate_tpu" in sys.modules:
        fail("the port imported jax or accelerate_tpu")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
