"""The port's multi-tenant scheduling through its ``ServingEngine``
(``scheduler=`` and ``faults=``) against the JAX package's engine on the
CPU, on the same ``SchedulerConfig``, the same fault schedule and the
same scripted submissions, with the reference's weights carried through
``models/convert.py``.

The contracts held:
- preempted-and-resumed greedy requests give the reference's tokens and
  those of an uninterrupted run, on the paged and the flat arena and on
  quantized KV; sampled ones give the port's own uninterrupted run's
  (the resume samples nothing, so each generator draws as it would have);
- outcomes, shed reasons and preemption / resumption counts equal the
  reference's: bounded queues, per-tenant bounds, page exhaustion, the
  watermark shed under an injected squeeze, the pressure ladders;
- no scheduling action captures a new graph after ``warmup()`` (the
  port's counterpart of the reference's zero-recompile invariant);
- page refcounts return to baseline after 100 preempt, page-out and
  re-admit cycles.

The JAX engine runs its paged decode and ragged prefill kernels through
the Pallas interpreter, as its own tests do; the port's engine runs the
kernels' plain versions (CPU tensors).
"""

import time

import numpy as np
import pytest

import jax
import torch

from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.serving import FaultInjector as JaxFaults
from accelerate_tpu.serving import SchedulerConfig as JaxSchedulerConfig
from accelerate_tpu.serving import ServingEngine as JaxEngine
from accelerate_tpu.serving.faults import poison_on_token as jax_poison
from accelerate_tpu.serving.scheduler import TenantConfig as JaxTenantConfig
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.ops import kernels
from accelerate_tpu_torch.serving import FaultInjector, SchedulerConfig, ServingEngine, TenantConfig
from accelerate_tpu_torch.serving.faults import poison_on_token
from accelerate_tpu_torch.utils import cuda_graphs

PS = 8


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig.tiny(num_kv_heads=2, max_seq_len=64,
                          decode_kernel="interpret", prefill_kernel="interpret")
    jmodel = JaxLM(jcfg)
    params, _ = unbox_params(
        jmodel.init_variables(jax.random.PRNGKey(0), batch_size=1, seq_len=16)["params"])
    cfg = DecoderConfig.tiny(num_kv_heads=2, max_seq_len=64)
    model = DecoderLM(cfg, device="cpu").load_params(
        from_reference(jax.tree_util.tree_map(np.asarray, params), cfg))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(3, cfg.vocab_size, (n,)) for n in (5, 8, 12, 3)]
    return jmodel, params, model, prompts


# each side's own classes, so one script drives both engines
PORT = dict(Sched=SchedulerConfig, Tenant=TenantConfig, Faults=FaultInjector,
            poison=poison_on_token)
REF = dict(Sched=JaxSchedulerConfig, Tenant=JaxTenantConfig, Faults=JaxFaults,
           poison=jax_poison)


def _kw(side, kw):
    """Engine kwargs for ``side``: ``sched`` (a dict, None for FIFO; its
    ``tenants`` map to dicts of TenantConfig fields) and ``faults`` (a
    builder taking the side's FaultInjector class) become that side's
    objects."""
    kw = dict(kw)
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_cache_len", 64)
    kw.setdefault("prefill_chunks", (4, 8))
    kw.setdefault("page_size", PS)
    sched = kw.pop("sched", {})
    if sched is not None:
        sched = dict(sched)
        sched["tenants"] = {k: side["Tenant"](**v) for k, v in sched.get("tenants", {}).items()}
        kw["scheduler"] = side["Sched"](**sched)
    faults = kw.pop("faults", None)
    if faults is not None:
        kw["faults"] = faults(side["Faults"])
    return kw


def _port(models, **kw):
    _, _, model, _ = models
    return ServingEngine(model, device="cpu", **_kw(PORT, kw))


def _ref(models, **kw):
    jmodel, params, _, _ = models
    return JaxEngine(jmodel, params, **_kw(REF, kw))


def _both(models, script, **kw):
    """Run ``script(engine, side)`` (returns its requests) on the port's
    engine and the reference's, built alike from ``kw``; hold outcomes,
    reasons, tokens, prefix hits and preemption counts equal. Returns the
    port's engine and requests."""
    ref = _ref(models, **kw)
    jreqs = script(ref, REF)
    eng = _port(models, **kw)
    treqs = script(eng, PORT)
    assert len(treqs) == len(jreqs)
    for t, j in zip(treqs, jreqs):
        assert t.done and j.done
        assert (t.outcome, t.finish_reason, t.shed_reason) == \
            (j.outcome, j.finish_reason, j.shed_reason), (t.id, t.outcome, j.outcome)
        assert t.tokens == [int(x) for x in j.tokens], t.id
        assert (t.preemptions, t.prefix_hit) == (j.preemptions, j.prefix_hit), t.id
    assert (eng.preemptions, eng.resumptions, eng.step_count) == \
        (ref.preemptions, ref.resumptions, ref.step_count)
    assert (eng.requests_completed, eng.requests_shed, eng.requests_cancelled) == \
        (ref.requests_completed, ref.requests_shed, ref.requests_cancelled)
    return eng, treqs


def _alone(models, prompt, new, seed, **kw):
    """The request served alone on an idle FIFO engine: the uninterrupted run."""
    eng = _port(models, sched=None, **kw)
    req = eng.submit(prompt, max_new_tokens=new, seed=seed)
    eng.run()
    assert req.outcome == "finished"
    return req.tokens


def _preempt_script(prompts, low_new=10, high_new=4, **submit):
    """Run ``low`` to 3 tokens on the one slot, then submit a
    higher-priority request that steals it."""
    def script(eng, side):
        low = eng.submit(prompts[1], max_new_tokens=low_new, seed=3, priority=0, **submit)
        while len(low.tokens) < 3 and not low.done:
            eng.step()
        high = eng.submit(prompts[0], max_new_tokens=high_new, seed=7, priority=5, **submit)
        eng.run()
        return [low, high]
    return script


ARENAS = [("paged", "bf16"), ("flat", "bf16"), ("paged", "int8"), ("flat", "int8"),
          ("paged", "int4")]


@pytest.mark.parametrize("arena,kv", ARENAS)
def test_greedy_preempt_resume_matches_reference_and_uninterrupted(models, arena, kv):
    """Page out mid-generation, re-admit (through the prefix cache on the
    paged arena, by replaying everything on the flat one): the tokens equal
    the reference's and those of an uninterrupted run."""
    _, _, _, prompts = models
    kw = dict(num_slots=1, kv_cache_dtype=kv, page_size=PS if arena == "paged" else None)
    eng, (low, high) = _both(models, _preempt_script(prompts), **kw)
    assert eng.preemptions == eng.resumptions == 1
    assert low.preemptions == 1 and low.outcome == high.outcome == "finished"
    if arena == "paged":
        assert low.prefix_hit >= PS  # the replay rode the pages the page-out published
    assert low.tokens == _alone(models, prompts[1], 10, 3, **kw)
    assert high.tokens == _alone(models, prompts[0], 4, 7, **kw)
    m = eng.metrics()
    assert (m["serving/preemptions"], m["serving/resumptions"]) == (1, 1)
    assert m["serving/sched_admitted"] == 2


@pytest.mark.parametrize("arena,k", [("paged", 1), ("flat", 1), ("paged", 4)])
def test_sampled_preempt_resume_matches_uninterrupted(models, arena, k):
    """Sampled decoding is where a slipped draw shows: the resume samples
    nothing, so each request's generator draws exactly as in an
    uninterrupted run (decode bursts of 4 included)."""
    _, _, _, prompts = models
    kw = dict(num_slots=1, temperature=1.0, top_k=8, steps_per_call=k,
              page_size=PS if arena == "paged" else None)
    eng = _port(models, **kw)
    low, high = _preempt_script(prompts, low_new=12)(eng, PORT)
    assert low.preemptions == 1 and eng.resumptions == 1
    assert low.tokens == _alone(models, prompts[1], 12, 3, **kw)
    assert high.tokens == _alone(models, prompts[0], 4, 7, **kw)


@pytest.fixture
def graphs(monkeypatch):
    """The engine's CUDA branch on the CPU: ``cuda_graphs.capture`` stubbed
    to a step that counts its captures and replays the body eagerly.
    Returns ``(captured, warm)``; ``warm(engine)`` runs warmup() as a CUDA
    engine would."""
    captured = []

    class Step:
        def __init__(self, body, device, restore=()):
            self.body, self.replays, self.seconds = body, 0, 0.0
            captured.append(self)

        def replay(self):
            self.replays += 1
            return self.body()

    monkeypatch.setattr(cuda_graphs, "capture", Step)
    monkeypatch.setattr(kernels, "build", lambda names=None: None)

    def warm(eng):
        eng.device = torch.device("cuda")
        eng.warmup()
        eng.device = torch.device("cpu")

    return captured, warm


@pytest.mark.parametrize("arena", ["paged", "flat"])
def test_scheduling_actions_capture_no_graph_after_warmup(models, graphs, arena):
    """After warmup(), admit / preempt / page-out / re-admit / shed are
    data changes in the captured step's fixed buffers: the one graph
    warmup() captured replays every decode step, and none is captured
    later."""
    captured, warm = graphs
    _, _, _, prompts = models
    eng = _port(models, num_slots=1, sched=dict(max_queue_depth=3),
                page_size=PS if arena == "paged" else None)
    warm(eng)
    assert len(captured) == 1
    low = eng.submit(prompts[1], max_new_tokens=10, seed=3, priority=0)
    while len(low.tokens) < 3:
        eng.step()
    high = eng.submit(prompts[0], max_new_tokens=4, seed=7, priority=5)
    extra = [eng.submit(prompts[3], max_new_tokens=2, seed=9) for _ in range(4)]
    eng.run()
    assert eng.preemptions >= 1 and eng.resumptions >= 1
    assert any(r.outcome == "shed" for r in extra)
    assert low.outcome == high.outcome == "finished"
    assert len(captured) == 1 and captured[0].replays == eng.step_count
    assert low.tokens == _alone(models, prompts[1], 10, 3, num_slots=1,
                                page_size=PS if arena == "paged" else None)


def test_bounded_queue_sheds_at_submit(models):
    _, _, _, prompts = models

    def script(eng, side):
        reqs = [eng.submit(prompts[0], max_new_tokens=2, seed=i) for i in range(5)]
        shed = [r for r in reqs if r.outcome == "shed"]
        assert len(shed) == 3
        assert all(r.shed_reason == "queue_full" and r.done for r in shed)
        eng.run()
        return reqs

    eng, reqs = _both(models, script, sched=dict(max_queue_depth=2))
    assert all(r.outcome in ("finished", "shed") for r in reqs)
    assert eng.metrics()["serving/shed"] == 3


def test_per_tenant_bound_isolates_the_noisy_tenant(models):
    _, _, _, prompts = models

    def script(eng, side):
        noisy = [eng.submit(prompts[0], max_new_tokens=2, seed=i, tenant="noisy")
                 for i in range(4)]
        quiet = eng.submit(prompts[3], max_new_tokens=2, seed=9, tenant="quiet")
        assert sum(r.outcome == "shed" for r in noisy) >= 1
        assert all(r.shed_reason == "tenant_queue_full" for r in noisy if r.done)
        assert quiet.outcome is None  # the bound is per tenant
        eng.run()
        return noisy + [quiet]

    _, reqs = _both(models, script, sched=dict(tenants={"noisy": dict(max_queued=1)}))
    assert reqs[-1].outcome == "finished"


def test_page_exhaustion_sheds_instead_of_raising(models):
    """An admission that cannot get pages (no prefix cache to evict) is
    shed with ``page_exhausted``; step() never raises, and a later smaller
    request still serves."""
    _, _, _, prompts = models

    def script(eng, side):
        big = eng.submit(prompts[2], max_new_tokens=20, seed=0)
        eng.run()
        small = eng.submit(prompts[3], max_new_tokens=3, seed=1)
        eng.run()
        return [big, small]

    eng, (big, small) = _both(models, script, num_slots=1, num_pages=4, prefix_cache=False)
    assert big.outcome == "shed" and big.shed_reason == "page_exhausted"
    assert small.outcome == "finished"
    assert eng.metrics()["serving/shed"] == 1
    # no scheduler: the batch API raises rather than hand back truncated output
    fifo = _port(models, num_slots=1, num_pages=4, prefix_cache=False, sched=None)
    with pytest.raises(RuntimeError, match="did not finish"):
        fifo.generate_batched([prompts[2]], max_new_tokens=20)


def test_admission_pressure_preempts_lower_priority_victim(models):
    """A high-priority admission that cannot get pages pages out a
    strictly lower victim before it gives up (the ragged dispatch's
    ladder), with a free slot at hand (so no _maybe_preempt)."""
    _, _, _, prompts = models

    def script(eng, side):
        low = eng.submit(prompts[2], max_new_tokens=10, seed=1, priority=0)
        while len(low.tokens) < 7 and not low.done:
            eng.step()
        assert not low.done
        high = eng.submit(prompts[1], max_new_tokens=4, seed=2, priority=5)
        eng.run()
        return [low, high]

    kw = dict(num_slots=2, max_cache_len=24, num_pages=5, prefix_cache=False)
    eng, (low, high) = _both(models, script, **kw)
    assert high.outcome == "finished"
    assert eng.preemptions >= 1 and low.preemptions >= 1
    assert high.tokens == _alone(models, prompts[1], 4, 2, **kw)
    assert low.outcome in ("finished", "shed")


def test_decode_growth_pressure_preempts_lower_priority_victim(models):
    """A live high-priority slot that cannot grow its pages pages out the
    low-priority slot instead of wedging."""
    _, _, _, prompts = models

    def script(eng, side):
        low = eng.submit(prompts[1], max_new_tokens=16, seed=1, priority=0)
        high = eng.submit(prompts[3], max_new_tokens=20, seed=2, priority=5)
        eng.run()
        return [low, high]

    kw = dict(num_slots=2, max_cache_len=24, num_pages=6, prefix_cache=False)
    eng, (low, high) = _both(models, script, **kw)
    assert high.outcome == "finished" and eng.preemptions >= 1
    assert high.tokens == _alone(models, prompts[3], 20, 2, **kw)
    if low.outcome == "finished":
        assert low.tokens == _alone(models, prompts[1], 16, 1, **kw)


def test_watermark_shed_under_injected_page_squeeze(models):
    """A page squeeze drops the free fraction below the watermark: the
    newest lowest-priority queued request is shed, higher classes flow."""
    _, _, _, prompts = models

    def script(eng, side):
        hi = eng.submit(prompts[3], max_new_tokens=2, seed=0, priority=5)
        lo = [eng.submit(prompts[0], max_new_tokens=2, seed=i, priority=0) for i in range(3)]
        eng.run()
        eng._faults.release_all(eng)
        return [hi] + lo

    eng, reqs = _both(
        models, script, num_slots=1, num_pages=1 + 8 + 64,
        sched=dict(page_low_watermark=0.5),
        faults=lambda F: F(seed=0).squeeze_pages(at_step=0, pages=64, hold_steps=10_000))
    assert reqs[0].outcome == "finished"
    assert any(r.outcome == "shed" and r.shed_reason == "page_pressure" for r in reqs[1:])
    assert any(k == "squeeze_pages" for _, k, _ in eng._faults.log)


def test_watermark_shed_never_drops_work_preemption_could_place(models):
    """Under watermark pressure the shed pick is bounded to classes no
    live slot loses to: the lone high-priority request is preemption's
    job, never the shed's."""
    _, _, _, prompts = models

    def script(eng, side):
        lo = eng.submit(prompts[2], max_new_tokens=10, seed=1, priority=0)
        while len(lo.tokens) < 1 and not lo.done:
            eng.step()
        assert not lo.done
        hi = eng.submit(prompts[3], max_new_tokens=2, seed=0, priority=5)
        eng.run()
        eng._faults.release_all(eng)
        return [lo, hi]

    eng, (lo, hi) = _both(
        models, script, num_slots=1, num_pages=1 + 8 + 64,
        sched=dict(page_low_watermark=0.5),
        faults=lambda F: F(seed=0).squeeze_pages(at_step=3, pages=68, hold_steps=10_000))
    assert hi.outcome == "finished" and eng.preemptions >= 1
    assert hi.tokens == _alone(models, prompts[3], 2, 0, num_slots=1)
    assert lo.outcome in ("finished", "shed")


def test_preemptible_submit_requires_replayable_worst_case(models):
    """A preemptible request whose worst-case replay (prompt + all but one
    generated token) cannot chunk-plan within the slot is refused at
    submit, as the reference refuses it; without preemption the cold plan
    is the only one that must fit."""
    p16 = np.random.RandomState(9).randint(3, 256, (16,))
    kw = dict(num_slots=1, max_cache_len=24, prefill_chunks=(16,))
    for make in (_port, _ref):
        eng = make(models, **kw)
        with pytest.raises(ValueError, match="KV capacity"):
            eng.submit(p16, max_new_tokens=8, seed=0)
        eng2 = make(models, sched=dict(preemption=False), **kw)
        assert eng2.submit(p16, max_new_tokens=8, seed=0).outcome is None


def test_idle_steps_do_not_move_the_itl_controller(models):
    """The controller observes fresh ITL gaps, not steps: an idle engine
    polling must not replay the last window's p99 into it."""
    _, _, _, prompts = models
    eng = _port(models, sched=dict(itl_slo_ms=1e-6))  # unreachable SLO
    req = eng.submit(prompts[1], max_new_tokens=12, seed=0)
    eng.run()
    assert req.outcome == "finished"
    breaches, budget = eng._controller.breaches, eng._controller.budget
    assert breaches > 0
    for _ in range(64):
        eng.step()
    assert (eng._controller.breaches, eng._controller.budget) == (breaches, budget)


def test_poisoned_request_cancelled_not_loop_killed(models):
    _, _, _, prompts = models

    def script(eng, side):
        bad = eng.submit(prompts[0], max_new_tokens=4, seed=0, on_token=side["poison"])
        ok = eng.submit(prompts[3], max_new_tokens=3, seed=1)
        eng.run()
        return [bad, ok]

    eng, (bad, ok) = _both(models, script)
    assert bad.outcome == "cancelled" and bad.finish_reason == "callback_error"
    assert ok.outcome == "finished"
    assert eng.metrics()["serving/cancelled"] == 1


def test_cancel_and_timeout_under_the_scheduler(models):
    """A cancel frees the slot and pages at the next step; timeouts end
    queued and live requests alike; the engine serves on."""
    _, _, _, prompts = models
    eng = _port(models, num_slots=1, prefix_cache=False)
    req = eng.submit(prompts[1], max_new_tokens=30, seed=0)
    while len(req.tokens) < 2:
        eng.step()
    assert eng._allocator.in_use > 0
    assert req.cancel()
    eng.step()
    assert req.outcome == "cancelled" and eng._allocator.in_use == 0
    live = eng.submit(prompts[0], max_new_tokens=40, seed=0, timeout_s=0.001)
    queued = eng.submit(prompts[1], max_new_tokens=2, seed=1, timeout_s=0.001)
    fresh = eng.submit(prompts[3], max_new_tokens=2, seed=2)
    time.sleep(0.01)
    eng.run()
    assert live.finish_reason == queued.finish_reason == "timeout"
    assert fresh.outcome == "finished"


def test_drain_mid_burst_finishes_or_sheds_everything(models):
    _, _, _, prompts = models

    def script(eng, side):
        reqs = [eng.submit(prompts[i % 4], max_new_tokens=4, seed=i) for i in range(5)]
        while not any(r.tokens for r in reqs):
            eng.step()
        summary = eng.drain()
        assert summary["completed"] + summary["shed"] == len(reqs)
        late = eng.submit(prompts[0], max_new_tokens=2, seed=9)
        return reqs + [late]

    eng, reqs = _both(models, script, num_slots=1)
    assert all(r.outcome in ("finished", "shed") for r in reqs)
    assert any(r.shed_reason == "draining" for r in reqs[:-1])
    assert reqs[-1].outcome == "shed" and reqs[-1].shed_reason == "draining"
    tail = _port(models, num_slots=1)
    req = tail.submit(prompts[0], max_new_tokens=50, seed=0)
    while len(req.tokens) < 1:
        tail.step()
    tail.drain(timeout_s=0.0)
    assert req.finish_reason == "drain_timeout" and len(tail._free) == tail.num_slots


def test_no_leak_across_100_preempt_resume_cycles(models):
    """Refcounts return to baseline after 100 preempt, page-out and
    re-admit cycles with copy-on-write forks and prefix hits between
    them; every resumed request's tokens are its uninterrupted run's."""
    _, _, _, prompts = models
    eng = _port(models, num_slots=1)
    free0 = eng._allocator.free_count
    rng = np.random.RandomState(5)
    alone = {}
    for i in range(100):
        p = prompts[2] if i % 3 == 0 else rng.randint(3, 256, (4 + i % 9,))
        low = eng.submit(p, max_new_tokens=4, seed=i, priority=0)
        while len(low.tokens) < 2 and not low.done:
            eng.step()
        hi = eng.submit(prompts[3], max_new_tokens=1, seed=i, priority=5)
        eng.run()
        assert low.outcome == hi.outcome == "finished"
        if i % 3 == 0:
            alone.setdefault("t", _alone(models, p, 4, i, num_slots=1))
            assert low.tokens == alone["t"]
    assert eng.preemptions >= 90 and eng.resumptions == eng.preemptions
    assert eng._prefix.hits >= 30 and eng.page_forks >= 1
    eng._prefix.clear()
    assert eng._allocator.in_use == 0 and eng._allocator.free_count == free0


def _isolation_burst(models, *, storm: bool, chunk_delay_s: float, slo_ms: float):
    """One seeded mixed-tenant run: tenant B ("interactive", priority 5)
    sends short prompts; with ``storm`` tenant A ("batch", priority 0)
    floods long prompts mid-flight through the fault injector. Injected
    prefill delays make a dispatch's cost fixed, so B's ITL reads the
    scheduling interference. Returns (B's gaps in ms, requests, engine)."""
    rng = np.random.RandomState(42)
    stamps = {}

    def stamp(tok, req):
        stamps.setdefault(req.id, []).append(time.perf_counter())

    a_prompts = [rng.randint(3, 256, (24,)) for _ in range(4)]
    a_reqs = []

    def build(F):
        faults = F(seed=1).delay_prefill(every=1, delay_s=chunk_delay_s)
        if storm:
            def fire(engine):
                for i, p in enumerate(a_prompts):
                    a_reqs.append(engine.submit(p, max_new_tokens=3, seed=100 + i,
                                                tenant="batch", priority=0))
            faults.storm(at_step=2, fire=fire)
        return faults

    eng = _port(models, prefill_chunks=(4,), sched=dict(itl_slo_ms=slo_ms), faults=build)
    eng.warmup()
    b_prompts = [rng.randint(3, 256, (4,)) for _ in range(4)]
    b_reqs = [eng.submit(p, max_new_tokens=12, seed=i, tenant="interactive", priority=5,
                         on_token=stamp) for i, p in enumerate(b_prompts)]
    eng.run()
    gaps = []
    for req in b_reqs:
        ts = stamps.get(req.id, [])
        gaps += [1e3 * (b - a) for a, b in zip(ts, ts[1:])]
    return gaps, b_reqs + a_reqs, eng


def test_storm_isolation_smoke(models):
    """Tenant A's prefill storm moves tenant B's ITL p99 by a bounded
    factor, and every request ends with a definite outcome."""
    delay = 0.012
    slo = 1e3 * delay + 10.0
    base_gaps, base_reqs, _ = _isolation_burst(models, storm=False, chunk_delay_s=delay,
                                               slo_ms=slo)
    storm_gaps, storm_reqs, eng = _isolation_burst(models, storm=True, chunk_delay_s=delay,
                                                   slo_ms=slo)
    p99_base = float(np.percentile(base_gaps, 99))
    p99_storm = float(np.percentile(storm_gaps, 99))
    bound = 3.0 * (p99_base + 1e3 * delay)
    assert p99_storm <= bound, (p99_storm, p99_base, bound)
    for req in base_reqs + storm_reqs:
        assert req.done and req.outcome in ("finished", "shed", "cancelled")
    assert all(r.outcome == "finished" for r in storm_reqs if r.tenant == "interactive")
    m = eng.metrics()
    assert "serving/itl_budget" in m and "serving/itl_budget_adjustments" in m
    assert m["serving/quota_interactive_tokens_used"] >= 12


def test_controller_cuts_prefill_budget_under_breach(models):
    """With an unreachable SLO the controller backs the dispatches-per-step
    budget off its starting point."""
    _, reqs, eng = _isolation_burst(models, storm=True, chunk_delay_s=0.012, slo_ms=2.0)
    assert eng._controller.breaches > 0 and eng._controller.budget < 1.0
    assert eng.metrics()["serving/itl_budget"] < 1.0
    assert all(r.done for r in reqs)


def test_seeded_fault_sweep_every_request_terminates(models, graphs):
    """Delays, a page squeeze, a poisoned request and a zero timeout across
    three tenants (the reference sweeps three seeds; this runs its first):
    every request reaches a definite outcome, the one graph warmup()
    captured serves the whole run, and no page leaks."""
    captured, warm = graphs
    seed = 0
    rng = np.random.RandomState(seed)
    eng = _port(
        models, num_slots=3,
        sched=dict(itl_slo_ms=25.0, max_queue_depth=12,
                   tenants={"noisy": dict(max_queued=3, quota=64.0)}),
        faults=lambda F: (F(seed=seed).delay_decode(prob=0.2, delay_s=0.002)
                          .delay_prefill(every=3, delay_s=0.004)
                          .squeeze_pages(at_step=6, pages=10, hold_steps=6)))
    warm(eng)
    reqs = []
    for i in range(18):
        tenant = ("noisy", "steady", "vip")[i % 3]
        kw = {}
        if i == 7:
            kw["on_token"] = poison_on_token
        if i == 11:
            kw["timeout_s"] = 0.0
        reqs.append(eng.submit(rng.randint(3, 256, (3 + (i * 7) % 20,)),
                               max_new_tokens=2 + i % 6, seed=i, tenant=tenant,
                               priority={"noisy": 0, "steady": 2, "vip": 5}[tenant], **kw))
        if i % 5 == 4:
            for _ in range(3):
                eng.step()
    eng.run()
    eng._faults.release_all(eng)
    for req in reqs:
        assert req.done and req.outcome in ("finished", "shed", "cancelled"), req.id
    assert any(r.outcome == "cancelled" for r in reqs)
    assert any(k == "squeeze_pages" for _, k, _ in eng._faults.log)
    assert len(captured) == 1
    eng._prefix.clear()
    assert eng._allocator.in_use == 0
