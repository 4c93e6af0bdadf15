"""The port's flash attention (``accelerate_tpu_torch/ops/attention.py``)
against the JAX package's Pallas flash kernels, run as the JAX package's
own tests run them on the CPU (``interpret=True``).

On CPU tensors the port's flash functions run the plain versions of the
three Hopper kernels (``flash_fwd_reference``, ``flash_bwd_dq_reference``,
``flash_bwd_dkv_reference``)
through the same ``torch.autograd.Function`` the kernels use on the card.
Inputs are made with numpy from a seed and handed to both sides in fp32;
values, lse and the gradients dq, dk, dv are compared.

Tolerance 2e-5 (absolute and relative): fp32 on both sides, the same
formulas, summed in another order by XLA and PyTorch (observed ~2e-6).

One difference is by design: a row with no attended key (a kv_mask row
of zeros, or a left-padded row under causal masking) gives out = 0 in the
port, while the reference's forward gives the mean of the V rows its
kernel visited (its p = exp(NEG_INF - NEG_INF) = 1 there). Both give
lse = NEG_INF, and both backwards treat the row as empty; the tests
compare such rows' lse and gradients, and hold the port's out to 0.
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

ATOL = 2e-5
RTOL = 2e-5


def _inputs(seed, b, h, kvh, sq, skv, d=16):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, kvh, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, skv, d)).astype(np.float32)
    g = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    return q, k, v, g


def _jax_run(q, k, v, g, causal, **masks):
    """JAX flash attention (interpret) -> (out, dq, dk, dv) for cotangent g;
    ``masks`` are numpy arrays (kv_mask, q/kv_segment_ids)."""
    kw = {n: jnp.asarray(x) for n, x in masks.items()}
    out, vjp = jax.vjp(
        lambda q, k, v: ref.flash_attention(q, k, v, causal=causal, interpret=True, **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return tuple(np.asarray(x) for x in (out, *vjp(jnp.asarray(g))))


def _port_run(q, k, v, g, causal, **masks):
    """The port's flash attention on CPU tensors, same contract."""
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    kw = {n: torch.from_numpy(x) for n, x in masks.items()}
    out = port.flash_attention(tq, tk, tv, causal=causal, **kw)
    out.backward(torch.from_numpy(g))
    return tuple(t.detach().numpy() for t in (out, tq.grad, tk.grad, tv.grad))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (4, 1)], ids=["mha", "gqa4-2", "gqa4-1"])
def test_values_and_grads_match_reference(causal, h, kvh):
    q, k, v, g = _inputs(0, 2, h, kvh, 256, 256)
    want = _jax_run(q, k, v, g, causal=causal)
    got = _port_run(q, k, v, g, causal=causal)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        _close(a, b, name)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_lse_matches_reference(causal):
    q, k, v, _ = _inputs(1, 2, 4, 2, 256, 256)
    out_r, lse_r = ref.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, interpret=True)
    out_p, lse_p = port.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal)
    assert lse_p.shape == (2, 4, 256) and lse_p.dtype == torch.float32
    _close(out_p.numpy(), np.asarray(out_r), "out")
    _close(lse_p.numpy(), np.asarray(lse_r), "lse")


@pytest.mark.parametrize("sq,skv", [(128, 256), (256, 128)], ids=["sq<skv", "sq>skv"])
def test_causal_unequal_lengths_are_top_left_aligned(sq, skv):
    """The flash mask is cols <= rows on global indices (top-left), not
    mha_reference's bottom-right tril: the port follows the kernel."""
    q, k, v, g = _inputs(2, 1, 4, 2, sq, skv)
    want = _jax_run(q, k, v, g, causal=True)
    got = _port_run(q, k, v, g, causal=True)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        _close(a, b, name)
    plain = port.mha_reference(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    assert not np.allclose(got[0], plain.numpy(), atol=1e-3)


def test_kv_mask_with_fully_masked_rows():
    """Batch row 0's kv_mask is all zeros; row 1 is left-padded by 100
    positions, so under causal masking its first 100 query rows attend
    nothing too."""
    q, k, v, g = _inputs(3, 2, 4, 2, 256, 256)
    kv_mask = np.ones((2, 256), np.int32)
    kv_mask[0] = 0
    kv_mask[1, :100] = 0
    want = _jax_run(q, k, v, g, causal=True, kv_mask=kv_mask)
    got = _port_run(q, k, v, g, causal=True, kv_mask=kv_mask)
    empty = np.zeros((2, 4, 256), bool)
    empty[0] = True
    empty[1, :, :100] = True
    assert np.abs(got[0][empty]).max() == 0.0  # exactly 0, not the reference's mean(v)
    _close(got[0][~empty], want[0][~empty], "out (attended rows)")
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        _close(a, b, name)
    assert np.abs(got[1][empty]).max() == 0.0
    _, lse_r = ref.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        kv_mask=jnp.asarray(kv_mask), interpret=True)
    _, lse_p = port.flash_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
        kv_mask=torch.from_numpy(kv_mask))
    assert (lse_p.numpy()[empty] == port.NEG_INF).all()
    _close(lse_p.numpy(), np.asarray(lse_r), "lse")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_segment_ids_match_reference(causal):
    q, k, v, g = _inputs(4, 2, 4, 2, 256, 256)
    seg = np.zeros((2, 256), np.int32)
    seg[0, 100:] = 1
    seg[1, 30:] = 1
    seg[1, 200:] = 2
    want = _jax_run(q, k, v, g, causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    got = _port_run(q, k, v, g, causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        _close(a, b, name)


def test_external_lse_backward_matches_reference():
    """The ring-backward form: gradients of one kv block given the GLOBAL
    lse over two kv blocks; the two blocks' partial gradients sum to the
    whole attention's."""
    q, k, v, g = _inputs(5, 1, 4, 2, 128, 256)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = port.flash_attention_with_lse(tq, tk, tv)
    jout, jlse = ref.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              interpret=True)
    _close(lse.numpy(), np.asarray(jlse), "global lse")
    parts = []
    for sl in (slice(0, 128), slice(128, 256)):
        got = port.flash_attention_bwd(tq, tk[:, :, sl], tv[:, :, sl], out, lse, tg)
        want = ref.flash_attention_bwd(
            jnp.asarray(q), jnp.asarray(k[:, :, sl]), jnp.asarray(v[:, :, sl]), jout, jlse,
            jnp.asarray(g), interpret=True)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            _close(a.numpy(), np.asarray(b), f"{name} of kv block {sl}")
        parts.append(got)
    whole = _port_run(q, k, v, g, causal=False)
    _close((parts[0][0] + parts[1][0]).numpy(), whole[1], "dq summed over kv blocks")
    _close(torch.cat([parts[0][1], parts[1][1]], dim=2).numpy(), whole[2], "dk")
    _close(torch.cat([parts[0][2], parts[1][2]], dim=2).numpy(), whole[3], "dv")


def test_flash_rejects_what_the_reference_rejects():
    q = torch.zeros((1, 4, 100, 16))
    with pytest.raises(ValueError, match="128-multiple"):
        port.flash_attention(q, q[:, :2], q[:, :2])
    q = torch.zeros((1, 4, 128, 16))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        port.flash_attention(q, q[:, :3], q[:, :3])
    seg = torch.zeros((1, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        port.flash_attention(q, q, q, q_segment_ids=seg)


# -- dot_product_attention: routing and mask folding --------------------------


def _dpa_both(q, k, v, impl, **masks):
    jkw = {n: jnp.asarray(x) for n, x in masks.items()}
    tkw = {n: torch.from_numpy(x) for n, x in masks.items()}
    want = ref.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=True, impl=impl, interpret=True, **jkw)
    got = port.dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                     causal=True, impl=impl, **tkw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_dot_product_attention_masks_match_reference(impl):
    """kv_mask and segment ids on the kernel path and folded into the
    additive bias on the plain path (no fully masked row here)."""
    q, k, v, _ = _inputs(6, 2, 4, 2, 256, 256)
    kv_mask = np.ones((2, 256), np.int32)
    kv_mask[1, 200:] = 0
    seg = np.zeros((2, 256), np.int32)
    seg[:, 128:] = 1
    got, want = _dpa_both(q, k, v, impl, kv_mask=kv_mask, q_segment_ids=seg,
                          kv_segment_ids=seg)
    _close(got, want, impl)


def test_dot_product_attention_routes_on_cpu():
    """"auto" on a CPU tensor is the plain attention (the kernels run on
    CUDA), "flash" is the flash path, "xla" the plain one; a bias forces
    the plain path and is refused by "flash"."""
    q, k, v, _ = _inputs(7, 1, 4, 2, 128, 256)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    plain = port.mha_reference(tq, tk, tv, causal=True)
    flash = port.flash_attention(tq, tk, tv, causal=True)
    before = dict(kernels.launch_counts)
    torch.testing.assert_close(port.dot_product_attention(tq, tk, tv, causal=True), plain)
    torch.testing.assert_close(
        port.dot_product_attention(tq, tk, tv, causal=True, impl="xla"), plain)
    torch.testing.assert_close(
        port.dot_product_attention(tq, tk, tv, causal=True, impl="flash"), flash)
    assert kernels.launch_counts == before
    bias = torch.zeros((1, 1, 128, 256))
    torch.testing.assert_close(
        port.dot_product_attention(tq, tk, tv, causal=True, bias=bias), plain)
    with pytest.raises(ValueError, match="bias"):
        port.dot_product_attention(tq, tk, tv, bias=bias, impl="flash")
    got, want = _dpa_both(q, k, v, "auto")  # reference on CPU: XLA too
    _close(got, want, "auto")


@pytest.mark.parametrize("impl,dev,s,d,want", [
    ("auto", "cuda", 2048, 128, True),
    ("auto", "cuda", 256, 128, True),
    ("auto", "cuda", 200, 128, False),   # no 128-multiple block
    ("auto", "cuda", 2048, 64, False),   # TPU gate: D % 128
    # the TPU gate passes: the kernels' wrapper raises for a head dim (or
    # a dtype) they were not built for, nothing goes to the plain path
    ("auto", "cuda", 2048, 256, True),
    ("auto", "cpu", 2048, 128, False),
    ("flash", "cpu", 256, 16, True),
    ("xla", "cuda", 2048, 128, False),
])
def test_flash_route_gate(impl, dev, s, d, want):
    assert port.flash_route(impl, torch.device(dev), s, s, d) is want


def test_flash_route_rejects_unknown_impl():
    with pytest.raises(ValueError, match="impl"):
        port.flash_route("pallas", torch.device("cpu"), 128, 128, 16)


def test_flash_wrappers_count_no_launch_on_cpu():
    q, k, v, g = _inputs(8, 1, 4, 2, 128, 128)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    masks = (None, None, None)
    before = dict(kernels.launch_counts)
    out, lse = kernels.flash_fwd(tq, tk, tv, masks, True, 0.25)
    delta = port.flash_delta(out, tg)
    dq = kernels.flash_bwd_dq(tq, tk, tv, tg, lse, delta, masks, True, 0.25)
    dk, dv = kernels.flash_bwd_dkv(tq, tk, tv, tg, lse, delta, masks, True, 0.25)
    assert kernels.launch_counts == before
    ref_out, ref_lse = port.flash_fwd_reference(tq, tk, tv, masks, True, 0.25)
    torch.testing.assert_close(out, ref_out, atol=0.0, rtol=0.0)
    args = (tq, tk, tv, tg, ref_lse, delta, masks, True, 0.25)
    want = (port.flash_bwd_dq_reference(*args), *port.flash_bwd_dkv_reference(*args))
    for a, b in zip((dq, dk, dv), want):
        torch.testing.assert_close(a, b, atol=0.0, rtol=0.0)
    assert math.isclose(float(port.flash_delta(out, tg)[0, 0, 0]),
                        float((tg[0, 0, 0] * out[0, 0, 0]).sum()), rel_tol=1e-6)


# the card's flash tolerance (chip_smoke.py check_close_rel): 2^-6 of the
# plain tensor's rms plus 2^-6 of |plain|
FLASH_KERNEL_ATOL_RMS = 2.0 ** -6
FLASH_KERNEL_RTOL = 2.0 ** -6


def test_dv_needs_p_at_fp32_precision():
    """The dK/dV kernel's rounding contract for p in the dV product. The
    reference upcasts dO, so p enters dV in fp32; the kernel splits p into
    hi = bf16(p) and lo = bf16(p - hi) and takes both products on the
    tensor cores. Held on the plain version's p at B 1, H 4, KVH 2, S 512,
    D 64, causal, with bf16-valued inputs from numpy seed 3 kept in fp32
    (so the plain dV is not rounded to bf16): the split's dV is within the
    card's flash tolerance with a 10x margin, and bf16 p alone lands
    beyond it. Seed 3 is one where it does: the early kv rows sum hundreds
    of large p terms whose true sum cancels."""
    b, h, kvh, s, d = 1, 4, 2, 512, 64
    rng = np.random.RandomState(3)

    def rnd(*shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(torch.bfloat16).float()

    q, k, v, do = rnd(b, h, s, d), rnd(b, kvh, s, d), rnd(b, kvh, s, d), rnd(b, h, s, d)
    scale, masks = 1.0 / math.sqrt(d), (None, None, None)
    out, lse = port.flash_fwd_reference(q, k, v, masks, True, scale)
    delta = port.flash_delta(out, do)
    _, dv = port.flash_bwd_dkv_reference(q, k, v, do, lse, delta, masks, True, scale)
    assert dv.dtype == torch.float32
    p, _ = port._flash_p_ds(q, k, v, do, lse, delta, masks, True, scale)
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()

    def dv_of(pp):
        return torch.einsum("bkgqc,bkgqd->bkcd", pp, do.reshape(b, kvh, h // kvh, s, d))

    limit = FLASH_KERNEL_ATOL_RMS * dv.square().mean().sqrt() + FLASH_KERNEL_RTOL * dv.abs()
    split = ((dv_of(hi) + dv_of(lo) - dv).abs() / limit).max().item()
    bf16_p = ((dv_of(hi) - dv).abs() / limit).max().item()
    assert split <= 0.1, split
    assert bf16_p > 1.0, bf16_p
