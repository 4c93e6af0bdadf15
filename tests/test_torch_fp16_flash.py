"""The fp16 entries of the flash kernels (#1-#3) on the CPU.

- The plain versions in fp16 (``flash_fwd_reference``,
  ``flash_bwd_dq_reference``, ``flash_bwd_dkv_reference``: fp32
  arithmetic, rounded where the kernels round, to fp16) through the port's
  differentiable flash operator, against the JAX package's Pallas flash in
  fp16 run as its own tests run it on the CPU (``interpret=True``): out,
  dq, dk and dv, causal or not, GQA, with a kv_mask and with segments.
- The rounding contract of the fp16 dK/dV entry: one fp16 p in the dV
  product stays well inside the card's flash tolerance, where bf16 needed
  p split into hi + lo (tests/test_torch_flash.py).
- The wrappers' dtype routing: bf16 and fp16 name their own entry point
  (``flash_fwd`` / ``flash_fwd_f16``, ...), fp32 raises; the serving
  kernels (#4-#6) route fp16 to their own fp16 entries and raise on fp32.
  Checked on meta tensors with the CUDA gate lifted: the checks run
  before any launch.

Inputs are made with numpy from a seed, rounded to fp16, and handed to
both sides. Tolerances are stated where they are used.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu.ops import attention as ref
from accelerate_tpu_torch.ops import attention as port
from accelerate_tpu_torch.ops import kernels

# fp16 outputs: |x| <~ 4 rounds to a spacing of 2^-9 at worst; both sides
# round p and dS to fp16 at the same sites from fp32 sums taken in another
# order, so a value may land one or two fp16 ulps apart
ATOL = 2.0 ** -8
RTOL = 2.0 ** -9


def _inputs(seed, b, h, kvh, sq, skv, d=16):
    rng = np.random.RandomState(seed)

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float16)

    return rnd(b, h, sq, d), rnd(b, kvh, skv, d), rnd(b, kvh, skv, d), rnd(b, h, sq, d)


def _jax_run(q, k, v, g, causal, **masks):
    kw = {n: jnp.asarray(x) for n, x in masks.items()}
    out, vjp = jax.vjp(
        lambda q, k, v: ref.flash_attention(q, k, v, causal=causal, interpret=True, **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return tuple(np.asarray(x).astype(np.float32) for x in (out, *vjp(jnp.asarray(g))))


def _port_run(q, k, v, g, causal, **masks):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    kw = {n: torch.from_numpy(x) for n, x in masks.items()}
    out = port.flash_attention(tq, tk, tv, causal=causal, **kw)
    assert out.dtype == torch.float16
    out.backward(torch.from_numpy(g))
    return tuple(x.detach().float().numpy() for x in (out, tq.grad, tk.grad, tv.grad))


def _close(got, want, what):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=f"{what} {name}")


@pytest.mark.parametrize("causal,h,kvh", [(True, 4, 2), (False, 4, 4), (True, 8, 2)])
def test_fp16_values_and_grads_match_reference(causal, h, kvh):
    q, k, v, g = _inputs(0, 2, h, kvh, 128, 128)
    _close(_port_run(q, k, v, g, causal), _jax_run(q, k, v, g, causal), f"causal={causal}")


def test_fp16_masks_match_reference():
    """A kv_mask with a left-padded row and segment ids, in fp16. Rows
    with no attended key differ by design in out (tests/test_torch_flash.py:
    the port gives 0), so the padded row's first positions are compared
    through their gradients only."""
    q, k, v, g = _inputs(1, 2, 4, 2, 128, 128)
    kv_mask = np.ones((2, 128), np.int32)
    kv_mask[1, :20] = 0
    want = _jax_run(q, k, v, g, False, kv_mask=kv_mask)
    got = _port_run(q, k, v, g, False, kv_mask=kv_mask)
    _close(got, want, "kv_mask")
    seg = np.zeros((2, 128), np.int32)
    seg[0, 50:] = 1
    seg[1, 90:] = 2
    masks = {"q_segment_ids": seg, "kv_segment_ids": seg}
    _close(_port_run(q, k, v, g, True, **masks), _jax_run(q, k, v, g, True, **masks),
           "segments")


def test_fp16_lse_matches_reference():
    """lse stays fp32 in both (tolerance 1e-5: fp32 on both sides over
    fp16-valued inputs)."""
    q, k, v, _ = _inputs(2, 1, 4, 2, 128, 128)
    _, lse_ref = ref.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              causal=True, interpret=True)
    _, lse = port.flash_attention_with_lse(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v), causal=True)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=1e-5, rtol=1e-5)


def test_fp16_dv_takes_one_fp16_p():
    """The fp16 dK/dV entry takes p once, as fp16, in the dV product (the
    reference's p.astype(do.dtype) in fp16). Held on the plain version's p
    at B 1, H 4, KVH 2, S 512, D 64, causal, fp16-valued inputs from numpy
    seeds 3-5 kept in fp32: one fp16 p lands within a quarter of the
    card's flash tolerance (2^-6 of the rms plus 2^-6 of |plain|;
    observed 0.10-0.19) of the fp32-p product, while one bf16 p misses it
    on seed 3 (tests/test_torch_flash.py::test_dv_needs_p_at_fp32_precision)."""
    b, h, kvh, s, d = 1, 4, 2, 512, 64
    worst = 0.0
    for seed in (3, 4, 5):
        rng = np.random.RandomState(seed)

        def rnd(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(np.float16)).float()

        q, k, v, do = rnd(b, h, s, d), rnd(b, kvh, s, d), rnd(b, kvh, s, d), rnd(b, h, s, d)
        scale, masks = 1.0 / math.sqrt(d), (None, None, None)
        out, lse = port.flash_fwd_reference(q, k, v, masks, True, scale)
        delta = port.flash_delta(out, do)
        _, dv = port.flash_bwd_dkv_reference(q, k, v, do, lse, delta, masks, True, scale)
        p, _ = port._flash_p_ds(q, k, v, do, lse, delta, masks, True, scale)
        one = torch.einsum("bkgqc,bkgqd->bkcd", p.half().float(),
                           do.reshape(b, kvh, h // kvh, s, d))
        limit = 2.0 ** -6 * dv.square().mean().sqrt() + 2.0 ** -6 * dv.abs()
        worst = max(worst, ((one - dv).abs() / limit).max().item())
    assert worst <= 0.25, worst


def test_plain_fp16_rounds_where_the_kernels_round():
    """The plain versions in fp16: out and dq / dk / dv come back fp16,
    lse fp32; p is rounded to fp16 before the PV product (the forward
    differs from an fp32 one by more than fp16's output rounding alone)."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(4, 1, 2, 2, 128, 128))
    masks = (None, None, None)
    out, lse = port.flash_fwd_reference(q, k, v, masks, True, 0.25)
    assert (out.dtype, lse.dtype) == (torch.float16, torch.float32)
    delta = port.flash_delta(out, g)
    dq = port.flash_bwd_dq_reference(q, k, v, g, lse, delta, masks, True, 0.25)
    dk, dv = port.flash_bwd_dkv_reference(q, k, v, g, lse, delta, masks, True, 0.25)
    assert {dq.dtype, dk.dtype, dv.dtype} == {torch.float16}
    out32, _ = port.flash_fwd_reference(q.float(), k.float(), v.float(), masks, True, 0.25)
    assert (out.float() - out32).abs().max().item() > 0.0


@pytest.fixture
def no_cuda_gate(monkeypatch):
    """The wrappers' checks run on meta tensors (no launch is reached)."""
    monkeypatch.setattr(kernels, "_require_cuda", lambda t, name: None)


def _meta(*shape, dtype=torch.float16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_flash_wrappers_route_each_dtype_to_its_entry(no_cuda_gate):
    """bf16 -> ``flash_fwd``, fp16 -> ``flash_fwd_f16`` (the same for dQ
    and dK/dV), fp32 raises: no fallback to the plain version."""
    masks = (None, None, None)
    for dtype, sfx in ((torch.bfloat16, ""), (torch.float16, "_f16")):
        q, k = _meta(2, 4, 128, 128, dtype=dtype), _meta(2, 2, 128, 128, dtype=dtype)
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            _, _, entry = kernels._flash_shapes(q, k, k, masks, name)
            assert entry == name + sfx and entry in kernels.KERNELS
            assert kernels.KERNELS[entry][0] == kernels.KERNELS[name][0]
            assert kernels.library_path(entry) == kernels.library_path(name)
    q32, k32 = _meta(2, 4, 128, 128, dtype=torch.float32), _meta(2, 2, 128, 128,
                                                                  dtype=torch.float32)
    with pytest.raises(TypeError, match="bf16 or fp16"):
        kernels._flash_shapes(q32, k32, k32, masks, "flash_fwd")
    # mixed dtypes raise at the checks, before any launch
    q16, kbf = _meta(2, 4, 128, 128), _meta(2, 2, 128, 128, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float16"):
        kernels._flash_shapes(q16, kbf, kbf, masks, "flash_fwd")


def test_serving_kernels_take_bf16_only(no_cuda_gate, monkeypatch):
    """The paged decode (#4), dense decode (#5) and ragged prefill (#6)
    wrappers route fp16 inputs to their fp16 entries (``paged_decode_f16``,
    ``dense_decode_f16``, ``ragged_prefill_f16``), as the reference serves
    an fp16 model through its kernels, and raise on fp32: the serving
    kernels take bf16 or fp16 only (tests/test_torch_fp16_serving.py
    covers every entry). The launch is recorded, not made."""
    launched = []
    monkeypatch.setattr(kernels, "_sm_count", lambda index: 132)
    monkeypatch.setattr(kernels, "_stream", lambda dev: 0)
    monkeypatch.setattr(kernels, "_launch", lambda name, *args: launched.append(name))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    b, h, kvh, d, ps, pages = 2, 4, 2, 128, 16, 8
    table = _meta(b, 4, dtype=torch.int32)
    cap = 64

    def calls(dt):
        return (
            lambda: kernels.paged_decode(
                _meta(b, h, 1, d, dtype=dt), _meta(pages, kvh, ps, d, dtype=dt),
                _meta(pages, kvh, ps, d, dtype=dt), table, _meta(b, 1, dtype=torch.int32), 0.1),
            lambda: kernels.dense_decode(
                _meta(b, h, 1, d, dtype=dt), _meta(b, kvh, 256, d, dtype=dt),
                _meta(b, kvh, 256, d, dtype=dt), _meta(b, 1, dtype=torch.int32), 0.1),
            lambda: kernels.ragged_prefill(
                _meta(1, h, cap, d, dtype=dt), _meta(1, kvh, cap, d, dtype=dt),
                _meta(1, kvh, cap, d, dtype=dt), _meta(pages, kvh, ps, d, dtype=dt),
                _meta(pages, kvh, ps, d, dtype=dt), table, _meta(cap, dtype=torch.int32),
                _meta(cap, dtype=torch.int32), _meta(b, dtype=torch.int32), 0.1, 8),
        )

    for call in calls(torch.float16):
        call()
    assert launched == ["paged_decode_f16", "dense_decode_f16", "ragged_prefill_f16"]
    for call in calls(torch.float32):
        with pytest.raises(TypeError, match="bf16 or fp16"):
            call()
    assert len(launched) == 3