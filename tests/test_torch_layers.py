"""The port's elementwise layers (``accelerate_tpu_torch/ops/layers.py``)
against the JAX package's (``accelerate_tpu/ops/layers.py``): RMSNorm,
SwiGLU and split-half RoPE on the same numpy-seeded fp32 inputs.

Tolerance 1e-6: both sides compute the same fp32 formula elementwise; the
only differences are libm-level rounding of rsqrt/sin/cos/exp (a few fp32
ulps on values of magnitude <~ 10).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from accelerate_tpu.ops import layers as jl
from accelerate_tpu_torch.ops import layers as tl

ATOL = 1e-6
RTOL = 1e-5


@pytest.mark.parametrize("shape", [(2, 5, 64), (1, 1, 128), (3, 7, 48)])
def test_rms_norm_matches_reference(shape):
    rng = np.random.RandomState(0)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    w = rng.standard_normal(shape[-1:]).astype(np.float32)
    ref = np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    got = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_rms_norm_keeps_input_dtype():
    x = torch.randn(2, 8, dtype=torch.bfloat16)
    assert tl.rms_norm(x, torch.ones(8)).dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(2, 5, 128), (4, 33)])
def test_swiglu_matches_reference(shape):
    rng = np.random.RandomState(1)
    g = (rng.standard_normal(shape) * 4).astype(np.float32)
    u = rng.standard_normal(shape).astype(np.float32)
    ref = np.asarray(jl.swiglu(jnp.asarray(g), jnp.asarray(u)))
    got = tl.swiglu(torch.from_numpy(g), torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("head_dim,theta", [(16, 10_000.0), (128, 500_000.0)])
def test_rotary_tables_match_reference(head_dim, theta):
    pos = np.array([0, 1, 7, 63, 2047], np.int32)
    s_ref, c_ref = jl.rotary_embedding_tables(jnp.asarray(pos), head_dim, theta=theta)
    s, c = tl.rotary_embedding_tables(torch.from_numpy(pos), head_dim, theta=theta)
    # angles reach ~2e3 rad: sin/cos of a large fp32 argument is only as
    # exact as the argument's own rounding (ulp(2048) ~ 2.4e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=5e-4)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=5e-4)


@pytest.mark.parametrize("per_batch", [False, True])
def test_apply_rotary_matches_reference(per_batch):
    """Split-half RoPE with shared [S, D/2] tables and per-slot
    [B, S, D/2] tables (the serving engine's per-slot positions)."""
    rng = np.random.RandomState(2)
    b, h, s, d = 3, 4, 5, 16
    x = rng.standard_normal((b, h, s, d)).astype(np.float32)
    pos = (rng.randint(0, 60, (b, s)) if per_batch
           else np.arange(s)).astype(np.int32)
    s_ref, c_ref = jl.rotary_embedding_tables(jnp.asarray(pos), d)
    ref = np.asarray(jl.apply_rotary_embedding(jnp.asarray(x), s_ref, c_ref))
    sin, cos = tl.rotary_embedding_tables(torch.from_numpy(pos), d)
    got = tl.apply_rotary_embedding(torch.from_numpy(x), sin, cos).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=RTOL)
