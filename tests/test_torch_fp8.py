"""The port's fp8 recipe (``accelerate_tpu_torch/ops/fp8.py``) against the
JAX package's ``ops/fp8.py``, on the CPU.

- The quantizers: ``quantize_fp8`` in e4m3 and e5m2 bit for bit in amax,
  scale and bytes against the reference under ``jax.jit`` (where XLA turns
  ``amax / fmax`` into ``amax * fl(1 / fmax)``, the form the port
  computes), an all-zero tensor (scale 1.0), values at the fp8 grid's
  rounding ties, and clipping under a given scale (the delayed recipe's
  ``clip(x / scale)``).
- The product: ``fp8_dot``'s output and both gradients
  (``torch.autograd`` against ``jax.vjp``) within 1e-5 relative: both
  sides sum the same exact fp8 products in fp32, in different orders.
- The delayed recipe: ``_delayed_scale`` bit for bit; ``fp8_dot_delayed``'s
  output and new history, a cold call (history zero: scale 1) then a warm
  one; ``roll_amax_histories`` on a stacked tree and in place on a
  model; the transient spike the history rides over.
- The card's route cannot run here: a CUDA tensor's product is
  ``torch._scaled_mm`` (chip_smoke.py's ``train_fp8_path`` holds it to the
  plain version), and a device that is neither raises.

- Generation on fp8 models (tests/test_torch_fp8_models.py holds the
  models' training): greedy ``generate()`` and ``generate_seq2seq`` tokens
  equal the reference's, the flat and paged engines' the reference
  engine's at the same options, the captured decode steps (the capture
  stubbed on the CPU) the eager ones; a delayed model generates with
  current scaling, as the reference's apply of ``{"params": ...}`` alone.
  A token may differ only at a near tie (the top-2 margin under one e4m3
  step of the step's largest |logit|); none does here.

Inputs are numpy arrays from seeds.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu import generation as jgen
from accelerate_tpu.models import DecoderConfig as JaxDecoderConfig
from accelerate_tpu.models import DecoderLM as JaxDecoderLM
from accelerate_tpu.models.seq2seq import Seq2SeqConfig as JaxSeq2SeqConfig
from accelerate_tpu.models.seq2seq import Seq2SeqLM as JaxSeq2SeqLM
from accelerate_tpu.ops import fp8 as ref
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.serving import ServingEngine as JaxEngine
from accelerate_tpu_torch.generation import generate, generate_seq2seq
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference, random_params
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.models.seq2seq import Seq2SeqConfig, Seq2SeqLM
from accelerate_tpu_torch.ops import fp8, kernels
from accelerate_tpu_torch.serving.engine import ServingEngine
from accelerate_tpu_torch.utils import cuda_graphs

DTYPES = [(fp8.E4M3, jnp.float8_e4m3fn, fp8.E4M3_MAX),
          (fp8.E5M2, jnp.float8_e5m2, fp8.E5M2_MAX)]
DTYPE_IDS = ["e4m3", "e5m2"]


def _bytes(q) -> np.ndarray:
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy()
    return np.asarray(q).view(np.uint8)


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _inputs(seed: int, shape=(24, 40)) -> np.ndarray:
    rs = np.random.RandomState(seed)
    # a spread of magnitudes, so amaxes land all over the float32 grid
    return (rs.standard_normal(shape) * np.exp(rs.uniform(-6, 6))).astype(np.float32)


@pytest.mark.parametrize("dt,jdt,fmax", DTYPES, ids=DTYPE_IDS)
def test_quantize_bit_exact(dt, jdt, fmax):
    jq = jax.jit(lambda x: ref.quantize_fp8(x, jdt, fmax))
    for seed in range(64):
        x = _inputs(seed)
        q, s = fp8.quantize_fp8(torch.from_numpy(x), dt, fmax)
        wq, ws = jq(jnp.asarray(x))
        assert s.dtype == torch.float32
        assert _f32(s).tobytes() == _f32(ws).tobytes(), seed
        np.testing.assert_array_equal(_bytes(q), _bytes(wq), err_msg=str(seed))
        np.testing.assert_array_equal(_f32(fp8.amax_of(torch.from_numpy(x))),
                                      _f32(jnp.max(jnp.abs(x))))


@pytest.mark.parametrize("dt,jdt,fmax", DTYPES, ids=DTYPE_IDS)
def test_quantize_zeros_and_bf16(dt, jdt, fmax):
    q, s = fp8.quantize_fp8(torch.zeros(8, 16), dt, fmax)
    assert float(s) == 1.0 and not _bytes(q).any()
    x = torch.from_numpy(_inputs(3)).to(torch.bfloat16)
    q, s = fp8.quantize_fp8(x, dt, fmax)
    wq, ws = jax.jit(lambda v: ref.quantize_fp8(v, jdt, fmax))(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    assert _f32(s).tobytes() == _f32(ws).tobytes()
    np.testing.assert_array_equal(_bytes(q), _bytes(wq))


@pytest.mark.parametrize("dt,jdt,fmax", DTYPES, ids=DTYPE_IDS)
def test_quantize_ties_and_clipping(dt, jdt, fmax):
    """Values midway between two fp8 neighbours (round half to even), and
    values past the dtype's max under a given scale (clipped to it)."""
    grid = np.asarray(jnp.arange(256, dtype=jnp.uint8).view(jdt).astype(jnp.float32))
    grid = np.unique(grid[np.isfinite(grid)])
    mids = ((grid[1:] + grid[:-1]) / 2).astype(np.float32)
    x = np.concatenate([mids, -mids, grid, [fmax * 3.0, -fmax * 1e3]]).astype(np.float32)
    scale = np.float32(1.0)
    got = fp8._quantize_with(torch.from_numpy(x), torch.tensor(scale), dt, fmax)
    want = jnp.clip(jnp.asarray(x) / scale, -fmax, fmax).astype(jdt)
    np.testing.assert_array_equal(_bytes(got), _bytes(want))
    assert float(got.float().abs().max()) == fmax
    for seed in range(8):  # a scale below the amax: the largest entries clip
        x = _inputs(seed)
        s = np.float32(np.abs(x).max() / (fmax * 4))
        got = fp8._quantize_with(torch.from_numpy(x), torch.tensor(s), dt, fmax)
        want = jnp.clip(jnp.asarray(x) / s, -fmax, fmax).astype(jdt)
        np.testing.assert_array_equal(_bytes(got), _bytes(want))


def test_scale_is_the_product_not_the_quotient():
    """The port's scale is amax * fl(1 / 448), the jitted reference's; the
    true quotient differs by an ulp on some of these inputs, so this test
    sees the form."""
    quotient = 0
    for seed in range(64):
        x = _inputs(seed)
        amax = np.float32(np.abs(x).max())
        s = fp8._amax_scale(torch.from_numpy(x), fp8.E4M3_MAX)
        assert float(s) == float(amax * np.float32(1.0 / 448.0))
        quotient += float(s) != float(amax / np.float32(448.0))
    assert quotient > 0


@pytest.mark.parametrize("shape", [(2, 8, 64), (40, 48)])
def test_fp8_dot_and_grads_match_reference(shape):
    """Output and both gradients within 1e-5 of each one's largest |entry|
    (and 1e-5 relative): the same exact fp8 products, summed in fp32 in
    XLA's and PyTorch's orders."""
    rs = np.random.RandomState(0)
    a = rs.standard_normal(shape).astype(np.float32) * 3
    b = (rs.standard_normal((shape[-1], 32)) * 0.2).astype(np.float32)
    g = rs.standard_normal(shape[:-1] + (32,)).astype(np.float32)
    want, vjp = jax.vjp(jax.jit(ref.fp8_dot), jnp.asarray(a), jnp.asarray(b))
    want_da, want_db = vjp(jnp.asarray(g))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    out = fp8.fp8_dot(ta, tb)
    out.backward(torch.from_numpy(g))
    for got, w in ((out, want), (ta.grad, want_da), (tb.grad, want_db)):
        w = _f32(w)
        np.testing.assert_allclose(got.detach().numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    assert out.dtype == torch.float32 and fp8.maybe_fp8_dot(ta, tb, False).shape == out.shape


def test_fp8_dot_keeps_bf16():
    a = torch.from_numpy(_inputs(1, (16, 32))).to(torch.bfloat16).requires_grad_(True)
    b = torch.from_numpy(_inputs(2, (32, 16))).to(torch.bfloat16).requires_grad_(True)
    out = fp8.fp8_dot(a, b)
    out.float().sum().backward()
    assert out.dtype == a.grad.dtype == b.grad.dtype == torch.bfloat16


def test_delayed_scale_bit_exact():
    jscale = jax.jit(lambda h: ref._delayed_scale(h, ref.E4M3_MAX, 1.0))
    for seed in range(64):
        h = np.abs(_inputs(seed, (16,)))
        h[seed % 16] = 0.0
        got = fp8._delayed_scale(torch.from_numpy(h), fp8.E4M3_MAX)
        assert _f32(got).tobytes() == _f32(jscale(jnp.asarray(h))).tobytes(), seed
    assert float(fp8._delayed_scale(torch.zeros(4), fp8.E4M3_MAX)) == 1.0


def test_fp8_dot_delayed_matches_reference():
    """A cold call (zero history: scale 1, the amaxes recorded) then a warm
    one (scales from the history), outputs within 1e-5 relative, histories
    bit for bit; ``hist`` itself is left as it was."""
    rs = np.random.RandomState(4)
    a = (rs.standard_normal((2, 8, 64)) * 2).astype(np.float32)
    b = (rs.standard_normal((64, 32)) * 0.5).astype(np.float32)
    jdelayed = jax.jit(ref.fp8_dot_delayed)
    hist, jhist = fp8.init_amax_history(4), ref.init_amax_history(4)
    for call in ("cold", "warm"):
        given, kept = hist, hist.clone()
        out, hist = fp8.fp8_dot_delayed(torch.from_numpy(a), torch.from_numpy(b), hist)
        want, jhist = jdelayed(jnp.asarray(a), jnp.asarray(b), jhist)
        assert torch.equal(given, kept)
        np.testing.assert_array_equal(hist.numpy(), _f32(jhist), err_msg=call)
        np.testing.assert_allclose(out.numpy(), _f32(want), rtol=1e-5,
                                   atol=1e-5 * np.abs(_f32(want)).max(), err_msg=call)
    np.testing.assert_allclose(out.numpy(), fp8.fp8_dot(torch.from_numpy(a),
                                                         torch.from_numpy(b)).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert float(hist[0].max()) > 0 and float(hist[1].max()) > 0


def test_delayed_product_gradients_keep_current_scaling():
    rs = np.random.RandomState(5)
    a = torch.from_numpy(rs.standard_normal((16, 32)).astype(np.float32)).requires_grad_(True)
    b = torch.from_numpy(rs.standard_normal((32, 16)).astype(np.float32)).requires_grad_(True)
    hist = torch.tensor([[100.0, 0.0], [50.0, 0.0]])  # scales far from the current amaxes
    out, _ = fp8.fp8_dot_delayed(a, b, hist)
    out.sum().backward()
    a2 = a.detach().clone().requires_grad_(True)
    b2 = b.detach().clone().requires_grad_(True)
    fp8.fp8_dot(a2, b2).sum().backward()
    torch.testing.assert_close(a.grad, a2.grad, rtol=0, atol=0)
    torch.testing.assert_close(b.grad, b2.grad, rtol=0, atol=0)


def test_roll_amax_histories_matches_reference():
    rs = np.random.RandomState(6)
    tree = {"layers": {"attn": {"wq_fp8": np.abs(rs.standard_normal((3, 2, 5))).astype(np.float32)},
                       "mlp": [np.abs(rs.standard_normal((2, 5))).astype(np.float32)]}}
    got = fp8.roll_amax_histories(jax.tree_util.tree_map(torch.from_numpy, tree))
    want = ref.roll_amax_histories(tree)
    for g, w in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, got)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, _f32(w))
        assert not g[..., 0].any()
    cfg = DecoderConfig.tiny(use_fp8=True, fp8_recipe="delayed", fp8_amax_history_len=5)
    model = DecoderLM(cfg, device="cpu")
    hist = model.fp8_histories()["layers.1.mlp.down"]
    hist.copy_(torch.from_numpy(tree["layers"]["mlp"][0]))
    assert fp8.roll_amax_histories(model) is model  # a model rolls in place
    np.testing.assert_array_equal(hist.numpy(),
                                  _f32(ref.roll_amax_histories(tree["layers"]["mlp"][0])))


def test_history_rides_over_transient_spike():
    """The recipe's point (the reference's test): one outlier step does not
    crush later scales; the history's max keeps the wider range."""
    hist = torch.zeros(4)
    for amax in (8.0, 100.0, 8.0):
        hist = fp8._roll_in(hist, torch.tensor(amax))
    scale = fp8._delayed_scale(hist, fp8.E4M3_MAX, 1.0)
    np.testing.assert_allclose(float(scale), 100.0 / fp8.E4M3_MAX, rtol=1e-6)
    jhist = jnp.zeros(4)
    for amax in (8.0, 100.0, 8.0):
        jhist = ref._roll_in(jhist, jnp.float32(amax))
    np.testing.assert_array_equal(hist.numpy(), _f32(jhist))


def test_record_amax_max_accumulates_slot_zero():
    row = torch.tensor([3.0, 7.0, 1.0])
    for amax, want in ((2.0, 3.0), (5.0, 5.0)):
        row = fp8._record_amax(row, torch.tensor(amax))
        assert row.tolist() == [want, 7.0, 1.0]
        jrow = ref._record_amax(jnp.asarray([3.0, 7.0, 1.0]), jnp.float32(amax))
        assert float(jrow[0]) == max(3.0, amax)


def test_meta_device_products_raise():
    q = torch.empty(16, 16, dtype=fp8.E4M3, device="meta")
    s = torch.ones((), device="meta")
    with pytest.raises(RuntimeError, match="neither CPU nor CUDA"):
        fp8._scaled_product(q, q, s, s, torch.bfloat16)


def test_card_route_calls_scaled_mm(monkeypatch):
    """What the card's route hands ``torch._scaled_mm`` (here on CPU
    tensors, the call faked): a row-major mat1, a column-major
    mat2, both scales, the output dtype; the contraction axis padded to 16
    with zeros; an output width off the multiple raises with the shape."""
    calls = []

    def fake(mat1, mat2, scale_a, scale_b, out_dtype):
        calls.append((mat1, mat2, scale_a, scale_b, out_dtype))
        return ((mat1.float() @ mat2.float()) * (scale_a * scale_b)).to(out_dtype)

    monkeypatch.setattr(torch, "_scaled_mm", fake)
    rs = np.random.RandomState(7)
    x, y = rs.standard_normal((5, 20)).astype(np.float32), rs.standard_normal((20, 32)).astype(np.float32)
    qx, sx = fp8.quantize_fp8(torch.from_numpy(x))
    qy, sy = fp8.quantize_fp8(torch.from_numpy(y), fp8.E5M2, fp8.E5M2_MAX)
    want = fp8._scaled_product(qx, qy, sx, sy, torch.bfloat16)
    before = fp8.product_count
    got = fp8.scaled_mm(qx, qy, sx, sy, torch.bfloat16)
    (mat1, mat2, sa, sb, out_dtype), = calls
    assert mat1.shape == (5, 32) and mat1.is_contiguous() and not mat1[:, 20:].float().any()
    assert mat2.shape == (32, 32) and mat2.t().is_contiguous()
    assert not mat2[20:].float().any() and out_dtype == torch.bfloat16
    assert sa.dim() == 0 and sb.dim() == 0 and fp8.product_count == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match=r"\[5, 20\] @ \[20, 24\]"):
        fp8.scaled_mm(qx, qy[:, :24], sx, sy, torch.bfloat16)


# -- generation --------------------------------------------------------------------

NEW = 6
HIST = 4
# a flipped greedy token is allowed only where the top-2 logit margin at
# that step is under one e4m3 step (2^-3) of the step's largest |logit|:
# the two sides then sit on either side of a tie the fp8 rounding decides
FLIP_MARGIN = 2.0 ** -3
ENGINES = {
    "flat": dict(num_slots=2, max_cache_len=64, prefill_chunks=(4, 8), page_size=None),
    "paged8": dict(num_slots=2, max_cache_len=64, prefill_chunks=(4, 8), page_size=8),
}


@pytest.fixture(scope="module", params=["current", "delayed"])
def gen_models(request):
    """(JAX decoder, params, the port's serving-layout model) of an fp8
    config; a delayed model generates with current scaling (the
    reference applies {"params": ...} alone)."""
    common = dict(max_seq_len=64, use_fp8=True, fp8_recipe=request.param,
                  fp8_amax_history_len=HIST)
    jm = JaxDecoderLM(JaxDecoderConfig.tiny(decode_kernel="interpret",
                                            prefill_kernel="interpret", **common))
    params = jax.tree_util.tree_map(np.asarray, unbox_params(
        jm.init_variables(jax.random.PRNGKey(0), batch_size=1, seq_len=16)["params"])[0])
    cfg = DecoderConfig.tiny(**common)
    model = DecoderLM(cfg, device="cpu").load_params(from_reference(params, cfg))
    return jm, params, model


def _assert_tokens(model, rows, got, want):
    """Greedy tokens equal, or the first flip of a row at a near tie of the
    port's own logits over that row's common prefix."""
    for row, g, w in zip(rows, got, want):
        g, w = np.asarray(g), np.asarray(w)
        if np.array_equal(g, w):
            continue
        t = int(np.argmax(g != w))
        prefix = np.concatenate([np.asarray(row), w[:t]])
        with torch.no_grad():
            logits = model(torch.as_tensor(prefix[None]).long())[0, -1]
        top2 = logits.topk(2).values
        assert float(top2[0] - top2[1]) < FLIP_MARGIN * float(logits.abs().max()), (t, g, w)


def _prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(3, 250, (n,)) for n in (5, 8, 12, 3)]


def _engine_tokens(engine, prompts):
    return [np.asarray(t) for t in engine.generate_batched(prompts, max_new_tokens=NEW)]


@pytest.mark.parametrize("s", [7, 24])
def test_greedy_generate_matches_reference(gen_models, s):
    jm, params, model = gen_models
    ids = np.random.RandomState(s).randint(3, 250, (2, s)).astype(np.int32)
    want = np.asarray(jgen.generate(jm, params, jnp.asarray(ids), max_new_tokens=NEW))
    got = generate(model, torch.from_numpy(ids), max_new_tokens=NEW).numpy()
    assert got.shape == want.shape
    _assert_tokens(model, ids, got[:, s:], want[:, s:])


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_matches_reference_engine(gen_models, name):
    """Every request's tokens equal the reference engine's at the same
    options: the same batch rows in each step, so the same current-scaling
    amaxes."""
    jm, params, model = gen_models
    prompts = _prompts()
    want = _engine_tokens(JaxEngine(jm, params, **ENGINES[name]), prompts)
    got = _engine_tokens(ServingEngine(model, device="cpu", **ENGINES[name]), prompts)
    _assert_tokens(model, prompts, got, want)


class _FakeGraph:
    def __init__(self, body, launches):
        self.body, self.launches, self.seconds = body, launches, 0.0

    def replay(self):
        return self.body()


def _fake_capture(body, device, restore=()):
    """``cuda_graphs.capture`` rehearsed on the CPU (tests/test_torch_moe_serving.py's)."""
    saved = [t.clone() for t in restore]
    with kernels.recording() as launches:
        for _ in range(3):
            body()
            for t, s in zip(restore, saved):
                t.copy_(s)
    return _FakeGraph(body, dict(launches))


def test_captured_decode_matches_eager(gen_models, monkeypatch):
    """generate()'s and the paged engine's decode steps through the graph
    plumbing (the capture stubbed on the CPU) give the eager tokens: the
    current scaling reads no host value inside a step."""
    _, _, model = gen_models
    ids = torch.as_tensor(np.random.RandomState(1).randint(3, 250, (3, 9)))
    eager = generate(model, ids, max_new_tokens=NEW)
    prompts = _prompts()
    eager_engine = _engine_tokens(ServingEngine(model, device="cpu", **ENGINES["paged8"]),
                                  prompts)
    monkeypatch.setattr(cuda_graphs, "captures", lambda device: True)
    monkeypatch.setattr(cuda_graphs, "capture", _fake_capture)
    np.testing.assert_array_equal(generate(model, ids, max_new_tokens=NEW).numpy(),
                                  eager.numpy())
    engine = ServingEngine(model, device="cpu", **ENGINES["paged8"])
    for a, b in zip(_engine_tokens(engine, prompts), eager_engine):
        np.testing.assert_array_equal(a, b)
    assert "decode" in engine._graphs


def test_delayed_model_generates_with_current_scaling():
    """A delayed model's cached forwards have no histories: current
    scaling, one warning, the histories untouched; its tokens are a
    current-recipe model's on the same weights."""
    cfg = DecoderConfig.tiny(max_seq_len=64, use_fp8=True, fp8_recipe="delayed")
    weights = random_params(cfg, seed=4, device="cpu")
    model = DecoderLM(cfg, device="cpu").load_params(weights)
    hists = {k: v.clone() for k, v in model.fp8_histories().items()}
    ids = torch.as_tensor(np.random.RandomState(2).randint(3, 250, (2, 7)))
    fp8._delayed_fallback_warned = False
    with pytest.warns(UserWarning, match="CURRENT scaling"):
        got = generate(model, ids, max_new_tokens=NEW)
    current = DecoderLM(dataclasses.replace(cfg, fp8_recipe="current"),
                        device="cpu").load_params(weights)
    np.testing.assert_array_equal(got.numpy(), generate(current, ids, max_new_tokens=NEW).numpy())
    assert all(torch.equal(v, hists[k]) for k, v in model.fp8_histories().items())


@pytest.mark.parametrize("recipe", ["current", "delayed"])
def test_generate_seq2seq_matches_reference(recipe):
    kw = dict(max_seq_len=16, max_target_len=16, use_fp8=True, fp8_recipe=recipe,
              fp8_amax_history_len=HIST)
    jm = JaxSeq2SeqLM(JaxSeq2SeqConfig.tiny(**kw))
    params = jax.tree_util.tree_map(np.asarray, unbox_params(jm.init_variables(
        jax.random.PRNGKey(0), batch_size=2, seq_len=16, target_len=12)["params"])[0])
    cfg = Seq2SeqConfig.tiny(**kw)
    model = Seq2SeqLM(cfg, device="cpu").load_params(from_reference(params, cfg))
    src = np.random.RandomState(5).randint(3, 256, (3, 16)).astype(np.int32)
    mask = (np.arange(16)[None, :] < np.array([16, 10, 4])[:, None]).astype(np.int32)
    want = np.asarray(jgen.generate_seq2seq(jm, params, jnp.asarray(src), max_new_tokens=NEW,
                                            attention_mask=jnp.asarray(mask)))
    got = generate_seq2seq(model, src, max_new_tokens=NEW, attention_mask=mask).numpy()
    np.testing.assert_array_equal(got, want)
