"""Decode bursts (``steps_per_call``) and the CUDA-graph plumbing of the
port's decode steps, on the CPU.

- Parity: the port's ``ServingEngine(steps_per_call=4)`` against the JAX
  package's at ``steps_per_call=4`` (its Pallas kernels in the
  interpreter, as the other engine tests run them), on the paged and the
  flat arena, bf16 and int8: identical greedy tokens, and on staggered
  admissions the same decode steps, prefill dispatches and sequence of
  burst lengths.
- Inside the port: sampled tokens at K 4 are those of K 1 (each slot's
  generator draws once a step, in step order); an eos mid-burst delivers
  what K 1 delivers; ``decode_step_ms_p50`` is the median of wall /
  steps and the burst's ITL gaps are amortized; a cancel and a timeout
  land between bursts; ``serve replica --steps-per-call 4`` over
  loopback streams the in-process engine's tokens.
- What a CUDA graph needs of the engine: its arena leaves, page table,
  weights and decode buffers keep their addresses across admissions,
  forks and ``load_params``; the capture helper's launch accounting (a
  capture records, each replay adds, warm-up counts nowhere) with the
  capture itself stubbed.
- The module-level ``generate_batched``: engine ``seed=s`` gives the
  tokens of ``generate()`` with ``torch.Generator().manual_seed(s)``, and
  greedy tokens equal the JAX ``generate_batched``.
"""

import json
import subprocess
import sys
import threading
import types
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.serving import ServingEngine as JaxEngine
from accelerate_tpu.serving import generate_batched as jax_generate_batched
from accelerate_tpu_torch import generate
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference, random_params
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.ops import kernels
from accelerate_tpu_torch.serving import engine as engine_module
from accelerate_tpu_torch.serving import generate_batched
from accelerate_tpu_torch.serving.engine import ServingEngine
from accelerate_tpu_torch.utils import cuda_graphs

ROOT = Path(__file__).resolve().parent.parent
CACHE = 64
CHUNKS = (4, 8)
ARENAS = {"paged": 8, "flat": None}
K = 4
NEW = 9


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig.tiny(num_kv_heads=2, max_seq_len=CACHE, decode_kernel="interpret",
                          prefill_kernel="interpret")
    jmodel = JaxLM(jcfg)
    params, _ = unbox_params(
        jmodel.init_variables(jax.random.PRNGKey(0), batch_size=1, seq_len=16)["params"]
    )
    cfg = DecoderConfig.tiny(num_kv_heads=2, max_seq_len=CACHE)
    model = DecoderLM(cfg, device="cpu").load_params(
        from_reference(jax.tree_util.tree_map(np.asarray, params), cfg))
    return jmodel, params, model


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(3, 250, (n,)) for n in lengths]


def _engine(model, arena, **kw):
    kw.setdefault("num_slots", 2)
    return ServingEngine(model, device="cpu", max_cache_len=CACHE, prefill_chunks=CHUNKS,
                         page_size=ARENAS[arena], **kw)


def _bursts(engine) -> list:
    """The steps of each decode dispatch, in order (1 or K)."""
    return [k for _, _, k in engine._step_samples]


def _step_until(engine, cond, limit: int = 100):
    """Step ``engine`` until ``cond()`` holds, failing after ``limit``
    scheduler iterations instead of spinning."""
    for _ in range(limit):
        if cond():
            return
        engine.step()
    assert cond(), f"not reached in {limit} scheduler iterations"


def _count_prefills(jeng) -> list:
    """Count the JAX engine's prefill dispatches (it keeps no counter):
    every call of a program its ``_ragged_prefill_fn`` (paged) or
    ``_prefill_fn`` (flat) hands out. Returns the one-element counter."""
    name = "_ragged_prefill_fn" if jeng.page_size else "_prefill_fn"
    get, count = getattr(jeng, name), [0]

    def counted(*key):
        fn = get(*key)

        def call(*args, **kw):
            count[0] += 1
            return fn(*args, **kw)

        return call

    setattr(jeng, name, counted)
    return count


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_burst_matches_reference(models, arena, kv):
    """Five requests on two slots at K 4: while a request waits in the
    queue with no free slot, and later with the queue drained, live slots
    burst; a slot freed mid-burst admits after the burst. Tokens, steps
    and the burst sequence are the reference engine's."""
    jmodel, params, model = models
    prompts = _prompts(0, (5, 3, 12, 20, 8))
    budgets = (NEW, 6, 11, 4, NEW)
    jeng = JaxEngine(jmodel, params, num_slots=2, max_cache_len=CACHE, prefill_chunks=CHUNKS,
                     page_size=ARENAS[arena], kv_cache_dtype=kv, steps_per_call=K)
    prefills = _count_prefills(jeng)
    teng = _engine(model, arena, kv_cache_dtype=kv, steps_per_call=K)
    jreqs = [jeng.submit(p, max_new_tokens=n, seed=i)
             for i, (p, n) in enumerate(zip(prompts, budgets))]
    jeng.run()
    treqs = [teng.submit(p, max_new_tokens=n, seed=i)
             for i, (p, n) in enumerate(zip(prompts, budgets))]
    teng.run()
    for j, t in zip(jreqs, treqs):
        assert t.outcome == j.outcome == "finished"
        np.testing.assert_array_equal(t.result(), j.result())
    assert K in _bursts(teng)
    assert _bursts(teng) == _bursts(jeng)
    assert teng.step_count == jeng.step_count
    assert teng.prefill_dispatches == prefills[0]


@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_burst_schedule_matches_reference_on_staggered_admissions(models, arena):
    """The traffic of the reference's
    ``test_zero_compiles_across_staggered_admissions`` (3 slots, K 4): one
    wave (of 12 tokens, not 6, so that it bursts), then six staggered
    requests of new lengths and budgets. Decode steps, prefill dispatches
    and the sequence of burst lengths are the JAX engine's, and so are
    the tokens."""
    jmodel, params, model = models
    first = _prompts(1, (7, 12, 4))
    rng = np.random.RandomState(3)
    later = [(rng.randint(3, 250, (n,)), m, n)
             for n, m in [(6, 3), (11, 7), (2, 5), (7, 2), (15, 6), (9, 4)]]
    kw = dict(num_slots=3, max_cache_len=CACHE, prefill_chunks=CHUNKS,
              page_size=ARENAS[arena], steps_per_call=K)
    jeng = JaxEngine(jmodel, params, **kw)
    prefills = _count_prefills(jeng)
    teng = ServingEngine(model, device="cpu", **kw)
    outs = []
    for eng in (jeng, teng):
        eng.generate_batched(first, max_new_tokens=12)
        reqs = [eng.submit(p, max_new_tokens=m, seed=s) for p, m, s in later]
        eng.run()
        assert all(r.outcome == "finished" for r in reqs)
        outs.append([r.result() for r in reqs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert K in _bursts(teng) and 1 in _bursts(teng)
    assert _bursts(teng) == _bursts(jeng)
    assert (teng.step_count, teng.prefill_dispatches) == (jeng.step_count, prefills[0])
    assert teng.metrics()["serving/requests_completed"] == 9


@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_sampled_burst_matches_single_steps(models, arena):
    """The reference's ``test_fused_burst_matches_single_steps`` inside the
    port: sampled (temperature 1.0, top-k 8), K 4 gives the tokens of K 1
    request for request."""
    _, _, model = models
    prompts = _prompts(2, (5, 9, 3, 12))
    runs = []
    for k in (1, K):
        eng = _engine(model, arena, temperature=1.0, top_k=8, steps_per_call=k)
        runs.append(eng.generate_batched(prompts, max_new_tokens=NEW, seeds=[3, 1, 4, 1]))
        assert (K in _bursts(eng)) == (k == K)
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_eos_mid_burst_and_burst_gauges(models):
    """An eos inside a burst drops the rest of its slot's burst: delivered
    tokens and ``generated_tokens`` equal K 1's. ``decode_step_ms_p50`` is
    the median of wall / steps, tokens/s counts delivered tokens, and ITL
    gaps inside a burst are its wall amortized: none is zero."""
    _, _, model = models
    prompts = _prompts(4, (6, 10))
    free = _engine(model, "paged").generate_batched(prompts, max_new_tokens=12)
    stream = free[0][6:]
    # an eos that first appears mid-burst: a later token of request 0
    idx = next(i for i in range(6, 11) if stream[i] not in stream[:i])
    eos = int(stream[idx])
    runs = []
    for k in (1, K):
        eng = _engine(model, "paged", steps_per_call=k, eos_token_id=eos)
        reqs = [eng.submit(p, max_new_tokens=12, seed=i) for i, p in enumerate(prompts)]
        eng.run()
        runs.append((eng, reqs))
    (e1, r1), (e4, r4) = runs
    assert r4[0].finish_reason == "eos" and r4[0].tokens[-1] == eos
    assert len(r4[0].tokens) == idx + 1
    for a, b in zip(r1, r4):
        assert a.tokens == b.tokens and a.finish_reason == b.finish_reason
    assert e4.generated_tokens == e1.generated_tokens
    samples = list(e4._step_samples)
    assert K in [k for _, _, k in samples]
    m = e4.metrics()
    want = 1e3 * float(np.median([w / k for w, _, k in samples]))
    assert m["serving/decode_step_ms_p50"] == pytest.approx(want)
    assert sum(n for _, n, _ in samples) == e4.generated_tokens - len(prompts)
    assert m["serving/tokens_per_s"] == pytest.approx(
        sum(n for _, n, _ in samples) / sum(w for w, _, _ in samples))
    assert min(e4._itl) > 0


@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_cancel_and_timeout_land_between_bursts(models, arena, monkeypatch):
    """A cancel and a ``timeout_s`` expiry are reaped at the top of the
    next scheduler iteration: between bursts, never inside one. The
    cancelled request keeps the tokens it had, its slot (and pages) come
    back, and the other request bursts on to its budget. The engine reads
    a clock the test moves, so the timeout fires where the test says."""
    clock = [100.0]
    monkeypatch.setattr(engine_module, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0], sleep=lambda s: None))
    _, _, model = models
    eng = _engine(model, arena, steps_per_call=K)
    a, b = (eng.submit(p, max_new_tokens=30) for p in _prompts(5, (4, 6)))
    _step_until(eng, lambda: len(eng._slot_req) == 2 and _bursts(eng)[-1:] == [K])
    held, held_b = len(a.tokens), len(b.tokens)
    assert a.cancel()
    eng.step()
    assert a.outcome == "cancelled" and a.finish_reason == "cancelled"
    assert len(a.tokens) == held and a.slot is None
    assert _bursts(eng)[-1] == K and len(b.tokens) == held_b + K
    t = eng.submit(_prompts(6, (5,))[0], max_new_tokens=30, timeout_s=0.05)
    _step_until(eng, lambda: len(eng._slot_req) == 2)
    eng.step()
    assert _bursts(eng)[-1] == K
    clock[0] += 0.06
    held_t = len(t.tokens)
    eng.step()
    assert t.outcome == "cancelled" and t.finish_reason == "timeout"
    assert len(t.tokens) == held_t
    eng.run()
    assert b.outcome == "finished" and len(b.tokens) == 30
    assert len(eng._free) == 2 and not eng._slot_req


def _arena_ptrs(engine) -> list:
    return [t.data_ptr() for layer in engine._arena for t in layer.values()
            if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_engine_keeps_buffer_addresses(models, arena):
    """Everything a captured step reads keeps its address: the arena
    leaves (prefill scatters, decode writes and copy-on-write forks update
    them in place), the page table, the weights (``load_params`` copies
    into them) and the decode step's device buffers."""
    _, _, model = models
    eng = _engine(model, arena, steps_per_call=K, kv_cache_dtype="int8")
    ptrs = {
        "arena": _arena_ptrs(eng),
        "params": [p.data_ptr() for p in model.parameters()],
        "state": [eng._state_dev.data_ptr(), eng._tok_dev.data_ptr(),
                  eng._pos_dev.data_ptr(), eng._act_dev.data_ptr(),
                  eng._burst_dev.data_ptr()],
    }
    if arena == "paged":
        ptrs["table"] = [eng._page_tables.data_ptr()]

    def now():
        got = {"arena": _arena_ptrs(eng), "params": [p.data_ptr() for p in model.parameters()],
               "state": [eng._state_dev.data_ptr(), eng._tok_dev.data_ptr(),
                         eng._pos_dev.data_ptr(), eng._act_dev.data_ptr(),
                         eng._burst_dev.data_ptr()]}
        if arena == "paged":
            got["table"] = [eng._page_tables.data_ptr()]
        return got

    shared = _prompts(7, (16,))[0]
    eng.generate_batched([shared, _prompts(8, (5,))[0]], max_new_tokens=6)
    # the same prompt again: a prefix hit whose boundary page the first
    # decode write forks (paged)
    eng.generate_batched([shared, shared[:11]], max_new_tokens=6)
    if arena == "paged":
        assert eng.page_forks > 0
    assert now() == ptrs
    model.load_params({k: v.clone() for k, v in model.state_dict().items()})
    assert now() == ptrs


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _FakeCuda:
    """The pieces of ``torch.cuda`` the capture helper touches, stubbed:
    the body runs for real on the CPU; under the stubbed capture it runs
    once, as a capture records it."""

    def __init__(self):
        self.graphs = []

    class Stream:
        def __init__(self, device):
            pass

        def wait_stream(self, other):
            pass

    def current_stream(self, device):
        return self.Stream(device)

    def stream(self, s):
        import contextlib

        return contextlib.nullcontext()

    def CUDAGraph(self):
        self.graphs.append(_FakeGraph())
        return self.graphs[-1]

    def graph(self, g, stream=None, capture_error_mode="global"):
        import contextlib

        return contextlib.nullcontext()

    def synchronize(self, device=None):
        pass


def test_capture_launch_delta_arithmetic(monkeypatch):
    """``capture`` runs the body ``WARMUP_CALLS`` times and once more under
    the capture; the warm-up launches count nowhere, the captured ones go
    to the step's record and not to the counters, and every replay adds
    the record once. The buffers listed in ``restore`` are put back after
    each warm-up call. A CPU device raises."""
    fake = _FakeCuda()
    monkeypatch.setattr(cuda_graphs.torch, "cuda", fake)
    kernels.reset_launch_counts()
    calls = []
    pos = torch.zeros(3, dtype=torch.long)

    def body():
        # what three paged decode launches and one ragged prefill launch
        # count (kernels._launch, past the library call)
        calls.append(pos.clone())
        for _ in range(3):
            kernels._count("paged_decode")
        kernels._count("ragged_prefill")
        pos.add_(1)
        return pos

    step = cuda_graphs.capture(body, "cuda", restore=(pos,))
    assert len(calls) == cuda_graphs.WARMUP_CALLS + 1
    assert all(int(c.sum()) == 0 for c in calls)  # each call saw the restored state
    assert kernels._record() is None
    assert sum(kernels.launch_counts.values()) == 0
    assert step.launches == {"paged_decode": 3, "ragged_prefill": 1}
    assert step.seconds >= 0
    for _ in range(5):
        assert step.replay() is pos
    assert fake.graphs[0].replays == 5
    assert kernels.launch_counts["paged_decode"] == 15
    assert kernels.launch_counts["ragged_prefill"] == 5
    assert sum(kernels.launch_counts.values()) == 20
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        cuda_graphs.capture(body, "cpu")
    with kernels.recording():
        with pytest.raises(RuntimeError, match="capture inside a capture"):
            with kernels.recording():
                pass


def test_a_capture_records_only_its_own_thread():
    """While one thread records a capture, a launch from another thread
    counts in :data:`launch_counts` and not in that capture's record, and
    the other thread may record a capture of its own."""
    import threading

    kernels.reset_launch_counts()
    seen = {}

    def other():
        kernels._count("dense_decode")
        with kernels.recording() as theirs:
            kernels._count("paged_decode")
        seen["theirs"] = dict(theirs)

    with kernels.recording() as ours:
        kernels._count("ragged_prefill")
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert ours == {"ragged_prefill": 1}
    assert seen["theirs"] == {"paged_decode": 1}
    assert kernels.launch_counts["dense_decode"] == 1
    assert sum(kernels.launch_counts.values()) == 1
    kernels.reset_launch_counts()


def test_a_capture_never_builds_a_kernel(monkeypatch):
    """A kernel whose library is not loaded when a capture reaches it
    raises with the cause, and nvcc never runs inside a capture (the
    capture's warm-up calls load every library first)."""
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    monkeypatch.setattr(kernels, "build", lambda names=None: pytest.fail("nvcc ran"))
    with pytest.raises(RuntimeError, match="paged_decode kernel is not loaded.*capture"):
        kernels._lib("paged_decode")


def test_cuda_engine_replays_its_captured_step(models, monkeypatch):
    """The engine's CUDA branch: ``warmup()`` captures the one step graph
    the engine replays (decode, or verify under spec) from parked slots,
    and every later step (K replays a burst) replays it, never the body
    itself. The capture is stubbed to a step that runs the body on the
    CPU and counts its replays; the engine serves on the CPU once its
    graph exists."""
    _, _, model = models
    captured = []

    class Step:
        def __init__(self, body, device, restore=()):
            self.body, self.device, self.restore, self.replays = body, device, restore, 0
            self.seconds = 0.0
            # warmup() loads parked slots before it captures
            self.parked = body.__name__ == "_verify_body" or not bool(
                body.__self__._act_dev.any())
            captured.append(self)

        def replay(self):
            self.replays += 1
            return self.body()

    monkeypatch.setattr(cuda_graphs, "capture", Step)
    monkeypatch.setattr(kernels, "build", lambda names=None: None)
    for spec in (0, 2):
        eng = _engine(model, "paged", steps_per_call=K, spec_draft_len=spec)
        eng.device = torch.device("cuda")  # the branch a CUDA engine takes
        eng.warmup()
        assert list(eng._graphs) == (["verify"] if spec else ["decode"])
        step = captured[-1]
        assert step.parked and step.device.type == "cuda"
        assert step.restore == (() if spec else (eng._tok_dev, eng._pos_dev))
        eng.device = torch.device("cpu")
        reqs = [eng.submit(p, max_new_tokens=NEW) for p in _prompts(9, (5, 7))]
        eng.run()
        assert all(r.outcome == "finished" for r in reqs)
        assert step.replays == eng.step_count if not spec else step.replays > 0
    assert len(captured) == 2


CLI = [sys.executable, "-m", "accelerate_tpu_torch.commands.serve", "replica", "--config",
       "tiny", "--device", "cpu", "--port", "0", "--page-size", "4", "--max-cache-len",
       "64", "--prefill-chunks", "4,8", "--num-slots", "2", "--steps-per-call", str(K)]


def test_replica_cli_steps_per_call_streams_the_engines_tokens():
    """``serve replica --steps-per-call 4 --device cpu`` over loopback: two
    concurrent streams carry the tokens of the in-process engine (K 4 and
    K 1 alike) on the same seeded weights."""
    proc = subprocess.Popen(CLI, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        lines = []
        reader = threading.Thread(target=lambda: lines.append(proc.stdout.readline()),
                                  daemon=True)
        reader.start()
        reader.join(timeout=120)
        assert lines and lines[0], proc.stderr.read() if proc.poll() is not None else ""
        url = json.loads(lines[0])["url"]
        prompts = [[int(t) for t in p] for p in _prompts(10, (7, 11))]
        got = [None, None]

        def client(i):
            req = urllib.request.Request(
                f"{url}/v1/submit",
                data=json.dumps({"prompt": prompts[i], "max_new_tokens": 12}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                got[i] = [json.loads(x) for x in resp.read().splitlines() if x.strip()]

        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        cfg = DecoderConfig.tiny(max_seq_len=256)
        model = DecoderLM(cfg, device="cpu").load_params(random_params(cfg, seed=0,
                                                                       device="cpu"))
        for k in (1, K):
            ref = ServingEngine(model, device="cpu", num_slots=2, max_cache_len=64,
                                prefill_chunks=(4, 8), page_size=4,
                                steps_per_call=k).generate_batched(
                [np.asarray(p) for p in prompts], max_new_tokens=12)
            for events, p, r in zip(got, prompts, ref):
                assert events[-1]["event"] == "done" and events[-1]["outcome"] == "finished"
                assert [e["token"] for e in events if e["event"] == "token"] == \
                    r[len(p):].tolist()
        proc.terminate()
        assert proc.wait(timeout=120) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


@pytest.mark.parametrize("k", [1, K])
@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_generate_batched_seed_contract(models, arena, k):
    """The module-level ``generate_batched`` builds min(len(prompts), 8)
    slots and passes the engine options through; request i with seed s
    samples the tokens of ``generate()`` with
    ``torch.Generator().manual_seed(s)`` (the reference's engine.py
    1056-1058, 2990-2991)."""
    _, _, model = models
    prompts = _prompts(11, (6, 9, 4))
    seeds = [0, 3, 5]
    outs = generate_batched(model, None, prompts, max_new_tokens=NEW, seeds=seeds,
                            device="cpu", max_cache_len=CACHE, prefill_chunks=CHUNKS,
                            page_size=ARENAS[arena], temperature=1.0, top_k=8,
                            steps_per_call=k)
    for p, s, out in zip(prompts, seeds, outs):
        ref = generate(model, torch.as_tensor(p)[None], max_new_tokens=NEW, temperature=1.0,
                       top_k=8, generator=torch.Generator().manual_seed(s))[0]
        np.testing.assert_array_equal(out, ref.numpy())


def test_generate_batched_matches_reference(models):
    """Greedy, the port's module-level ``generate_batched`` at K 4 against
    the JAX package's at K 4, on the flat arena (both defaults): the same
    prompt + continuation arrays."""
    jmodel, params, model = models
    prompts = _prompts(12, (5, 12, 3))
    ref = jax_generate_batched(jmodel, params, prompts, max_new_tokens=NEW,
                               max_cache_len=CACHE, prefill_chunks=CHUNKS, steps_per_call=K)
    got = generate_batched(model, None, prompts, max_new_tokens=NEW, device="cpu",
                           max_cache_len=CACHE, prefill_chunks=CHUNKS, steps_per_call=K)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
