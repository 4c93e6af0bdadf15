"""The port's KV-quantization drift harness (``serving/drift.py``)
against the JAX package's on the CPU, on ``DecoderConfig.tiny(max_seq_len
=64)`` with the reference's weights and the paged arena (page 8).

- Token agreement is counted alike: ``tokens_compared``,
  ``exact_streams`` and ``token_match_rate`` are equal (greedy).
- The teacher-forced ``logit_mse`` agrees to 1e-3 relative: both sides
  replay the same continuations through the same storage math in fp32,
  but the reference's jitted ``quantize_kv`` multiplies amax by the
  rounded reciprocal of qmax (XLA's rewrite of a division by a constant)
  where the port divides, so a scale may sit one ulp away.
- The reference's quality bounds (tests/test_kv_quant.py) hold for the
  port, sampled included (its own ``torch.Generator`` draws).
"""

import numpy as np
import pytest

import jax

from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.serving import kv_quant_drift as jax_kv_quant_drift
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.serving import kv_quant_drift

PS = 8
LOGIT_MSE_RTOL = 1e-3
DRIFT_KW = dict(max_new_tokens=6, page_size=PS, max_cache_len=64)


@pytest.fixture(scope="module")
def served():
    jcfg = JaxConfig.tiny(max_seq_len=64, decode_kernel="interpret",
                          prefill_kernel="interpret")
    jmodel = JaxLM(jcfg)
    params, _ = unbox_params(
        jmodel.init_variables(jax.random.PRNGKey(0), batch_size=1, seq_len=16)["params"]
    )
    cfg = DecoderConfig.tiny(max_seq_len=64)
    model = DecoderLM(cfg, device="cpu").load_params(
        from_reference(jax.tree_util.tree_map(np.asarray, params), cfg))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(3, cfg.vocab_size, (n,)) for n in (5, 8, 12, 3)]
    return jmodel, params, model, prompts


@pytest.fixture(scope="module")
def reports(served):
    """int8 and int4 drift of both harnesses, each against one baseline."""
    jmodel, params, model, prompts = served
    out = {}
    for side, fn, args in (("jax", jax_kv_quant_drift, (jmodel, params)),
                           ("port", kv_quant_drift, (model,))):
        base = None
        for kv in ("int8", "int4"):
            out[side, kv] = fn(*args, prompts, kv_cache_dtype=kv, baseline=base, **DRIFT_KW)
            base = out[side, kv]["baseline"]
    return out


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_drift_matches_reference(reports, kv):
    ours, ref = reports["port", kv], reports["jax", kv]
    for key in ("kv_cache_dtype", "kv_cache_bits", "sequences", "tokens_compared",
                "exact_streams", "token_match_rate"):
        assert ours[key] == ref[key], (key, ours[key], ref[key])
    for a, b in zip(ours["baseline"]["streams"], ref["baseline"]["streams"]):
        np.testing.assert_array_equal(a, b)
    assert ours["logit_mse"] > 0
    np.testing.assert_allclose(ours["logit_mse"], ref["logit_mse"], rtol=LOGIT_MSE_RTOL)
    np.testing.assert_allclose(ours["logit_rel_err"], ref["logit_rel_err"],
                               rtol=LOGIT_MSE_RTOL)


def test_reference_bounds_hold(reports):
    """tests/test_kv_quant.py's bounds: int8 greedy match >= 0.98, logit
    error < 1e-3 relative, arena >= 1.8x smaller; int4 error < 5%, match
    >= 0.5, arena >= 3x smaller."""
    r8, r4 = reports["port", "int8"], reports["port", "int4"]
    assert r8["kv_cache_bits"] == 8 and r4["kv_cache_bits"] == 4
    assert r8["tokens_compared"] == 4 * 6
    assert r8["token_match_rate"] >= 0.98, r8
    assert r8["logit_rel_err"] < 1e-3, r8
    assert r8["arena_bytes_ratio"] >= 1.8
    assert r4["logit_rel_err"] < 0.05, r4
    assert r4["token_match_rate"] >= 0.5, r4
    assert r4["arena_bytes_ratio"] >= 3.0


def test_sampled_bound_and_baseline_reuse(served, reports):
    _, _, model, prompts = served
    r = kv_quant_drift(model, prompts, kv_cache_dtype="int8", temperature=1.0, top_k=8,
                       **DRIFT_KW)
    assert r["token_match_rate"] >= 0.85, r
    # the int4 report came from the int8 call's baseline: a fresh run agrees
    fresh = kv_quant_drift(model, prompts, kv_cache_dtype="int4", **DRIFT_KW)
    for key, value in reports["port", "int4"].items():
        if key != "baseline":
            assert fresh[key] == value, key
