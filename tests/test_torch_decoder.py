"""The port's ``DecoderLM`` (``accelerate_tpu_torch/models/decoder.py``)
against the JAX package's, with the reference's weights carried through
``models/convert.py``: one packed ragged prefill dispatch and one paged
decode step over the same arena content, at ``tiny`` with GQA 4 -> 2.
Both the logits and every arena page the step writes match.

The JAX model runs its Pallas kernels as its own tests do on the CPU:
through the interpreter and through the plain reference.

Tolerance 1e-4: fp32 through two layers of matmuls, norms and softmax
summed in another order by XLA and PyTorch (reassociation noise of
~1e-6 relative, amplified by the logits' magnitude ~10).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.serving.pages import init_paged_arena as jax_paged_arena
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.serving.pages import init_paged_arena

ATOL = 1e-4
RTOL = 1e-4
PS, NP, SLOTS, PER = 8, 13, 3, 4  # page size, pages, slots, pages per slot


@pytest.fixture(scope="module")
def reference():
    cfg = JaxConfig.tiny(num_kv_heads=2, max_seq_len=64)
    params, _ = unbox_params(
        JaxLM(cfg).init_variables(jax.random.PRNGKey(0), batch_size=1, seq_len=16)["params"]
    )
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def _models(reference, impl):
    jcfg, params = reference
    jax_model = JaxLM(JaxConfig.tiny(
        num_kv_heads=2, max_seq_len=64, kv_page_size=PS, kv_num_pages=NP,
        decode_kernel=impl, prefill_kernel=impl))
    cfg = DecoderConfig.tiny(num_kv_heads=2, max_seq_len=64)
    model = DecoderLM(cfg, device="cpu").load_params(from_reference(params, cfg))
    return jax_model, params, model, cfg


def _arenas(jax_model, params, cfg, rng):
    """The same random arena content on both sides (JAX: scan-stacked
    ``cached_key`` [L, NP, KVH, PS, D]; port: per-layer dicts)."""
    jarena = jax_paged_arena(jax_model, params, SLOTS, PER, lambda p: p)
    attn = jarena["layers"]["block"]["attn"]
    k = rng.standard_normal(attn["cached_key"].shape).astype(np.float32)
    v = rng.standard_normal(attn["cached_value"].shape).astype(np.float32)
    attn["cached_key"], attn["cached_value"] = jnp.asarray(k), jnp.asarray(v)
    arena = init_paged_arena(cfg, NP, PS, torch.device("cpu"))
    for i, layer in enumerate(arena):
        layer["k"].copy_(torch.from_numpy(k[i]))
        layer["v"].copy_(torch.from_numpy(v[i]))
    return jarena, arena


def _assert_arenas_match(jcache, arena, skip_pages=(0,)):
    attn = jcache["layers"]["block"]["attn"]
    keep = [p for p in range(NP) if p not in skip_pages]
    for i, layer in enumerate(arena):
        for name, leaf in (("cached_key", "k"), ("cached_value", "v")):
            np.testing.assert_allclose(
                layer[leaf].numpy()[keep], np.asarray(attn[name][i])[keep],
                atol=ATOL, rtol=RTOL, err_msg=f"layer {i} {leaf}")


TABLE = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9]], np.int32)


@pytest.mark.parametrize("impl", ["interpret", "dense"])
def test_ragged_prefill_dispatch_matches(reference, impl):
    """One packed dispatch: slot 0 continues over a 5-token arena prefix,
    slot 2 is cold and ends mid-block on pad rows, then a whole pad
    block. Logits of live rows and every page but the parking page
    (where pad rows land) match."""
    jax_model, params, model, cfg = _models(reference, impl)
    rng = np.random.RandomState(0)
    jarena, arena = _arenas(jax_model, params, cfg, rng)
    bt, cap = 8, 32
    row_slot = np.full((cap,), -1, np.int32)
    row_pos = np.full((cap,), -1, np.int32)
    row_slot[0:16], row_pos[0:11] = 0, np.arange(5, 16)
    row_slot[16:24], row_pos[16:22] = 2, np.arange(0, 6)
    hist = np.array([5, 0, 0], np.int32)
    ids = rng.randint(3, 250, (1, cap)).astype(np.int32)
    positions = np.maximum(row_pos, 0)[None]
    out, mutated = jax_model.apply(
        {"params": params, "cache": jarena}, jnp.asarray(ids),
        positions=jnp.asarray(positions), use_cache=True, decode=True,
        cache_positions=jnp.asarray(row_pos[None]), page_table=jnp.asarray(TABLE),
        ragged_slots=jnp.asarray(row_slot), slot_hist=jnp.asarray(hist),
        mutable=["cache"])
    logits = model(torch.from_numpy(ids), torch.from_numpy(positions), cache=arena,
                   cache_positions=torch.from_numpy(row_pos[None]),
                   page_table=torch.from_numpy(TABLE),
                   ragged_slots=torch.from_numpy(row_slot),
                   slot_hist=torch.from_numpy(hist))
    valid = row_pos >= 0
    np.testing.assert_allclose(logits.numpy()[0][valid],
                               np.asarray(out["logits"])[0][valid],
                               atol=ATOL, rtol=RTOL)
    _assert_arenas_match(mutated["cache"], arena)


@pytest.mark.parametrize("impl", ["interpret", "dense"])
def test_paged_decode_step_matches(reference, impl):
    """One batched decode step: two live slots at their own positions
    (slot 0 writes into a fresh page) and one parked at the last cache
    position. Logits of the live slots and every page but the parking
    page match."""
    jax_model, params, model, cfg = _models(reference, impl)
    rng = np.random.RandomState(1)
    jarena, arena = _arenas(jax_model, params, cfg, rng)
    table = TABLE.copy()
    table[1] = 0  # slot 1 parked: all-parking row
    write_pos = np.array([16, PS * PER - 1, 29], np.int32)
    tokens = rng.randint(3, 250, (SLOTS, 1)).astype(np.int32)
    out, mutated = jax_model.apply(
        {"params": params, "cache": jarena}, jnp.asarray(tokens),
        positions=jnp.asarray(write_pos[:, None]), use_cache=True, decode=True,
        cache_positions=jnp.asarray(write_pos), page_table=jnp.asarray(table),
        mutable=["cache"])
    logits = model(torch.from_numpy(tokens), torch.from_numpy(write_pos[:, None]),
                   cache=arena, cache_positions=torch.from_numpy(write_pos),
                   page_table=torch.from_numpy(table))
    live = [0, 2]
    np.testing.assert_allclose(logits.numpy()[live, 0],
                               np.asarray(out["logits"])[live, 0],
                               atol=ATOL, rtol=RTOL)
    _assert_arenas_match(mutated["cache"], arena)


def test_plain_forward_matches_reference(reference):
    """The cache-free forward (plain causal attention): the teacher-forced
    oracle the GPU smoke run checks generated tokens against."""
    jcfg, params = reference
    cfg = DecoderConfig.tiny(num_kv_heads=2, max_seq_len=64)
    model = DecoderLM(cfg, device="cpu").load_params(from_reference(params, cfg))
    ids = np.random.RandomState(2).randint(3, 250, (2, 12)).astype(np.int32)
    ref = JaxLM(jcfg).apply({"params": params}, jnp.asarray(ids))["logits"]
    got = model(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_convert_unrolled_tree_matches_stacked(reference):
    """An unrolled (``layer_{i}``) tree converts to the same weights as
    the scan-stacked one."""
    _, params = reference
    cfg = DecoderConfig.tiny(num_kv_heads=2, max_seq_len=64)
    unrolled = {k: v for k, v in params.items() if k != "layers"}
    block = params["layers"]["block"]
    for i in range(cfg.num_layers):
        unrolled[f"layer_{i}"] = jax.tree_util.tree_map(lambda x: x[i], block)
    a, b = from_reference(params, cfg), from_reference(unrolled, cfg)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    assert set(a) == set(DecoderLM(cfg, device="cpu").state_dict())
