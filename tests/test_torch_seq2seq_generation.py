"""The port's ``generate_seq2seq`` against the JAX package's, on the CPU.

- greedy tokens equal to the reference's exactly, at B 3 with right-padded
  sources, tied and untied heads (fp32 at ``Seq2SeqConfig.tiny`` widths,
  weights carried by ``from_reference``);
- the port's cached run equals its own uncached greedy loop (the plain
  forward on the growing decoder input);
- the source-length, cache-capacity and ``max_new_tokens`` guards raise
  (the reference's ``tests/test_seq2seq.py`` cases);
- sampled runs reproduce under a seed and ``top_k=1`` equals greedy;
- tokens from quantized params (int8, NF4 + double quant) and from
  ``generate_seq2seq_dispatched`` over the device, pinned-host and disk
  tiers of a reference checkpoint, int8 on load included, against the
  reference's;
- the decode step's CUDA-graph plumbing rehearsed on the CPU: one dense
  decode launch per decoder layer and step, counted through the
  capture's record, the tokens of the eager loop.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu import big_modeling as RB
from accelerate_tpu import generation as rgen
from accelerate_tpu.models import Seq2SeqConfig as JaxConfig
from accelerate_tpu.models import Seq2SeqLM as JaxLM
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.utils import quantization as rquant
from accelerate_tpu.utils import serialization as RS
from accelerate_tpu_torch import big_modeling as PB
from accelerate_tpu_torch.generation import generate_seq2seq, generate_seq2seq_dispatched
from accelerate_tpu_torch.models import Seq2SeqConfig, Seq2SeqLM
from accelerate_tpu_torch.models.convert import from_reference
from accelerate_tpu_torch.ops import kernels
from accelerate_tpu_torch.utils import cuda_graphs
from accelerate_tpu_torch.utils import quantization as pquant
from accelerate_tpu_torch.utils import serialization as PS

NEW = 8
QUANT = {
    "int8": {"load_in_8bit": True, "group_size": 16},
    "nf4-dq": {"load_in_4bit": True, "group_size": 16, "quant_type": "nf4",
               "double_quant": True},
}
_STATE: dict = {}


def _reference(tie=True):
    """(JAX model, its fp32 params as numpy, the port's config)."""
    if tie not in _STATE:
        jm = JaxLM(JaxConfig.tiny(tie_embeddings=tie))
        params, _ = unbox_params(jm.init_variables(jax.random.PRNGKey(0), batch_size=2,
                                                   seq_len=16, target_len=12)["params"])
        _STATE[tie] = (jm, jax.tree_util.tree_map(np.asarray, params),
                       Seq2SeqConfig.tiny(tie_embeddings=tie))
    return _STATE[tie]


def _port(params, cfg):
    return Seq2SeqLM(cfg, device="cpu").load_params(from_reference(params, cfg))


def _sources(seed=5):
    """B 3 sources of 16, rows 1 and 2 right-padded to 10 and 4."""
    src = np.random.RandomState(seed).randint(3, 256, (3, 16)).astype(np.int32)
    mask = (np.arange(16)[None, :] < np.array([16, 10, 4])[:, None]).astype(np.int32)
    return src, mask


def _want(jm, params, src, mask, new=NEW):
    return np.asarray(rgen.generate_seq2seq(jm, params, jnp.asarray(src), max_new_tokens=new,
                                            attention_mask=jnp.asarray(mask)))


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_greedy_tokens_equal_reference(tie):
    jm, params, cfg = _reference(tie)
    src, mask = _sources()
    got = generate_seq2seq(_port(params, cfg), src, max_new_tokens=NEW, attention_mask=mask)
    assert got.shape == (3, NEW) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), _want(jm, params, src, mask))


def test_cached_equals_uncached():
    """The cached loop (prefill, then dense decode steps over the frozen
    cross K/V) against the plain forward on the growing decoder input."""
    _, params, cfg = _reference()
    model = _port(params, cfg)
    src, mask = _sources(6)
    got = generate_seq2seq(model, src, max_new_tokens=NEW, attention_mask=mask)
    dec = torch.full((3, 1), cfg.decoder_start_token_id, dtype=torch.long)
    with torch.no_grad():
        for _ in range(NEW):
            logits = model(torch.from_numpy(src), decoder_input_ids=dec,
                           attention_mask=torch.from_numpy(mask))["logits"]
            dec = torch.cat([dec, logits[:, -1].argmax(-1, keepdim=True)], dim=1)
    assert torch.equal(got, dec[:, 1:])


def test_guards_raise():
    _, params, _ = _reference()
    model = _port(params, Seq2SeqConfig.tiny(max_cache_len=4))
    src = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError, match="cache"):
        generate_seq2seq(model, src, max_new_tokens=8)
    with pytest.raises(ValueError, match="max_new_tokens"):
        generate_seq2seq(model, src, max_new_tokens=0)
    with pytest.raises(ValueError, match="max_seq_len"):
        generate_seq2seq(model, np.zeros((1, 65), np.int32), max_new_tokens=2)


def test_sampling_reproduces_and_top_k_1_is_greedy():
    _, params, cfg = _reference()
    model = _port(params, cfg)
    src, mask = _sources(7)
    kw = dict(max_new_tokens=NEW, attention_mask=mask, temperature=1.0)
    a = generate_seq2seq(model, src, **kw)
    assert torch.equal(a, generate_seq2seq(model, src, **kw))  # a fresh generator seeded 0
    g = [generate_seq2seq(model, src, generator=torch.Generator().manual_seed(3), **kw)
         for _ in range(2)]
    assert torch.equal(g[0], g[1])
    assert not torch.equal(a, generate_seq2seq(model, src, temperature=2.0,
                                               max_new_tokens=NEW, attention_mask=mask))
    greedy = generate_seq2seq(model, src, max_new_tokens=NEW, attention_mask=mask)
    assert torch.equal(generate_seq2seq(model, src, top_k=1, **kw), greedy)


@pytest.mark.parametrize("quant", list(QUANT))
def test_quantized_params_generate_the_reference_tokens(quant):
    """The reference packs its params and dequantizes them in the graph;
    the port packs the same tree (bit for bit) and dequantizes at use."""
    jm, params, cfg = _reference()
    src, mask = _sources(8)
    want = _want(jm, rquant.quantize_params(params, rquant.QuantizationConfig(**QUANT[quant])),
                 src, mask)
    packed = pquant.quantize_params(params, pquant.QuantizationConfig(**QUANT[quant]))
    m = PB.dispatch_model(cfg, packed, {"": "device"}, device="cpu")
    got = generate_seq2seq_dispatched(m, src, max_new_tokens=NEW, attention_mask=mask)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The reference's params saved by the reference's ``save_pytree``."""
    _, params, _ = _reference()
    path = str(tmp_path_factory.mktemp("s2s_ckpt") / "model.safetensors")
    RS.save_pytree(params, path)
    return path


TIERS = {
    "device": {"": "device"},
    "host-and-disk": {"": "device", "decoder/layers/block/mlp": "cpu",
                      "decoder/layers/block/cross_attn": "cpu", "encoder": "disk",
                      "embedding": "cpu"},
}


@pytest.mark.parametrize("tiers", list(TIERS))
def test_dispatched_generation_equals_reference(ckpt, tmp_path, tiers):
    """``load_checkpoint_and_dispatch`` over the tiers, then
    ``generate_seq2seq_dispatched``: the reference's ``generate_seq2seq``
    tokens on the same weights. The dispatched model's logits equal the
    plain model's bit for bit (the tiers only move the weights)."""
    jm, params, cfg = _reference()
    src, mask = _sources(9)
    m = PB.load_checkpoint_and_dispatch(cfg, ckpt, device_map=TIERS[tiers],
                                        offload_folder=str(tmp_path / "off"), device="cpu")
    streamed = [w for blk in [*m.model.encoder, *m.model.decoder] for w in blk.streamed]
    assert bool(streamed) == (tiers != "device")
    got = generate_seq2seq_dispatched(m, src, max_new_tokens=NEW, attention_mask=mask)
    np.testing.assert_array_equal(got.numpy(), _want(jm, params, src, mask))
    dec = torch.from_numpy(src[:, :5]).long()
    logits = m(src, decoder_input_ids=dec, attention_mask=mask)["logits"]
    with torch.no_grad():
        plain = _port(params, cfg)(torch.from_numpy(src), decoder_input_ids=dec,
                                   attention_mask=torch.from_numpy(mask))["logits"]
    assert torch.equal(logits, plain)


def test_int8_on_load_and_empty_weights_match_reference(ckpt):
    """int8 on load packs the leaves the reference packs, bit for bit, and
    generates its tokens; ``init_empty_weights`` is the reference's tree."""
    jm, params, cfg = _reference()
    src, mask = _sources(10)
    qc = QUANT["int8"]
    ref = RB.load_checkpoint_and_dispatch(jm, ckpt, jnp.zeros((1, 8), jnp.int32),
                                          decoder_input_ids=jnp.zeros((1, 8), jnp.int32),
                                          device_map="auto",
                                          quantization_config=rquant.QuantizationConfig(**qc),
                                          rng=jax.random.PRNGKey(0))
    want = np.asarray(rgen.generate_seq2seq_dispatched(
        ref, jnp.asarray(src), max_new_tokens=NEW, attention_mask=jnp.asarray(mask)))
    m = PB.load_checkpoint_and_dispatch(cfg, ckpt, device_map="auto",
                                        quantization_config=pquant.QuantizationConfig(**qc),
                                        device="cpu")
    rflat = RS.flatten_pytree(jax.tree_util.tree_map(np.asarray, ref.params))
    pflat = PS.flatten_pytree(m.params)
    assert list(rflat) == list(pflat)
    for k in rflat:
        np.testing.assert_array_equal(np.asarray(rflat[k]), pflat[k].numpy(), err_msg=k)
    got = generate_seq2seq_dispatched(m, src, max_new_tokens=NEW, attention_mask=mask)
    np.testing.assert_array_equal(got.numpy(), want)
    empty = PS.flatten_pytree(PB.init_empty_weights(cfg))
    assert {k: tuple(v.shape) for k, v in empty.items()} == {
        k: np.shape(v) for k, v in RS.flatten_pytree(params).items()}


class _Step:
    """What a captured step is on the CPU: ``replay`` reruns the body under
    a launch record (as the graph's replay reruns its kernels), then adds
    the capture's record to the counters and returns the captured
    output."""

    def __init__(self, body, out, launches):
        self.body, self.out, self.launches = body, out, launches

    def replay(self):
        with kernels.recording():
            out = self.body()
        for t, o in zip(self.out, out) if isinstance(out, tuple) else [(self.out, out)]:
            t.copy_(o)
        kernels.add_launches(self.launches)
        return self.out


def test_graph_path_counts_one_dense_decode_per_layer_and_step(monkeypatch):
    """generate_seq2seq's CUDA branch with the capture stubbed: the prefill
    runs eagerly, the decode step is captured once (after two warm-up
    calls whose buffers are put back) and replayed; the dense decode
    wrapper counts one launch per decoder layer and step, and the tokens
    are the eager loop's."""
    _, params, cfg = _reference()
    model = _port(params, cfg)
    src, mask = _sources(11)
    want = generate_seq2seq(model, src, max_new_tokens=NEW, attention_mask=mask)
    real = kernels.dense_decode

    def counted(*args):
        kernels._count("dense_decode")
        return real(*args)

    def fake_capture(body, device, restore=()):
        """Two warm-up calls, then the "capture": each run puts the
        ``restore`` buffers back (a real capture executes nothing)."""
        saved = [t.clone() for t in restore]
        for i in range(cuda_graphs.WARMUP_CALLS + 1):
            with kernels.recording() as launches:
                out = body()
            for t, s in zip(restore, saved):
                t.copy_(s)
        return _Step(body, out, dict(launches))

    monkeypatch.setattr(kernels, "dense_decode", counted)
    monkeypatch.setattr(cuda_graphs, "captures", lambda dev: True)
    monkeypatch.setattr(cuda_graphs, "capture", fake_capture)
    kernels.reset_launch_counts()
    got = generate_seq2seq(model, src, max_new_tokens=NEW, attention_mask=mask)
    counts = {k: v for k, v in kernels.launch_counts.items() if v}
    kernels.reset_launch_counts()
    assert counts == {"dense_decode": cfg.num_decoder_layers * (NEW - 1)}
    assert torch.equal(got, want)
