"""The port's scheduling policy and fault injection
(``accelerate_tpu_torch/serving/scheduler.py`` and ``faults.py``) against
the JAX package's on the CPU.

Both modules are plain python, so parity is exact: the same seeded
sequence of operations under one fake clock gives the same admissions,
picks, shed decisions, victims, gauges, prefill budgets and fault logs
on either side.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from accelerate_tpu.serving import faults as ref_faults
from accelerate_tpu.serving import scheduler as ref_sched
from accelerate_tpu_torch.serving import faults as port_faults
from accelerate_tpu_torch.serving import scheduler as port_sched

ROOT = Path(__file__).resolve().parent.parent


class Req:
    """The request fields the policy reads."""

    def __init__(self, rid, tenant, priority, deadline_s, submit_t, prompt_len, max_new):
        self.id = rid
        self.tenant = tenant
        self.priority = priority
        self.deadline_s = deadline_s
        self.submit_t = submit_t
        self.prompt = np.zeros((prompt_len,), np.int32)
        self.max_new_tokens = max_new
        self.tokens = []
        self.done = False


def _config(mod, variant: int):
    """A scheduler config of either module: tenants with weights, quotas
    and queue bounds, small global bounds, and (variant 1) a tenant-map
    bound low enough for idle reaping."""
    tc = mod.TenantConfig
    tenants = {"batch": tc(weight=1.0, quota=40.0, max_queued=6),
               "chat": tc(weight=4.0),
               "vip": tc(weight=2.0, quota=12.0, max_queued=None)}
    return mod.SchedulerConfig(
        tenants=tenants, max_queue_depth=12, max_tenant_queue_depth=4,
        quota_window_s=0.5, max_tenants=5 if variant else None,
        preemption=variant != 2, itl_slo_ms=20.0)


def _drive(mod, seed: int, variant: int):
    """One seeded run of ``mod``'s MultiTenantScheduler: a trace of every
    answer it gives, the gauges after each operation, and the budget
    trajectory of a PrefillBudgetController fed a seeded p99 series."""
    clock = [0.0]
    sched = mod.MultiTenantScheduler(_config(mod, variant), now_fn=lambda: clock[0])
    rng = np.random.RandomState(seed)
    names = ["batch", "chat", "vip", "default"] + [f"u{i}" for i in range(6)]
    live = {}  # slot -> request
    reqs = {}
    trace = []
    for step in range(400):
        op = rng.randint(10)
        if op <= 2:
            rid = len(reqs)
            tenant = names[rng.randint(len(names))]
            dl = None if rng.rand() < 0.5 else float(rng.randint(1, 20)) / 10
            r = reqs[rid] = Req(rid, tenant, int(rng.choice([0, 0, 2, 5])), dl, clock[0],
                                int(rng.randint(1, 300)), int(rng.randint(1, 64)))
            trace.append(("admit", rid, sched.admit(r)))
        elif op == 3:
            r = sched.next_request()
            trace.append(("next", None if r is None else r.id))
            if r is not None:
                free = [s for s in range(4) if s not in live]
                if free:
                    live[free[0]] = r
        elif op == 4 and live:
            slot = sorted(live)[rng.randint(len(live))]
            r = live.pop(slot)
            sched.requeue(r)
            trace.append(("requeue", r.id))
        elif op == 5:
            tenant = names[rng.randint(len(names))]
            n = int(rng.randint(1, 30))
            sched.note_tokens(tenant, n)
            for r in live.values():
                r.tokens.append(0)
            trace.append(("note", tenant, n))
        elif op == 6:
            cap = None if rng.rand() < 0.4 else int(rng.choice([1, 3, 6]))
            v = sched.pick_shed(max_priority=cap)
            shed = v is not None and rng.rand() < 0.6 and sched.shed(v)
            trace.append(("shed", cap, None if v is None else v.id, shed))
        elif op == 7:
            p = int(rng.choice([0, 2, 5, 9]))
            v = sched.pick_victim(sorted(live.items()), p)
            trace.append(("victim", p, None if v is None else (v[0], v[1].id)))
        elif op == 8:
            q = sched.queued()
            if q and rng.rand() < 0.5:
                r = q[rng.randint(len(q))]
                trace.append(("remove", r.id, sched.remove(r)))
            trace.append(("peek", sched.peek_priority()))
        else:
            clock[0] += float(rng.exponential(0.2))
            trace.append(("tick", round(clock[0], 9)))
        trace.append(("metrics", sched.metrics(), sched.total_queued,
                      sorted(r.id for r in sched.queued())))
    ctl = mod.PrefillBudgetController(20.0, budget=1.0, min_budget=0.25, max_budget=4.0,
                                      observe_every=3, min_samples=4)
    budgets = []
    for _ in range(200):
        p99 = None if rng.rand() < 0.1 else float(rng.gamma(2.0, 9.0))
        budgets.append((ctl.observe(p99, samples=int(rng.randint(0, 20))), ctl.breaches,
                        ctl.adjustments))
    return trace, budgets


@pytest.mark.parametrize("variant", [0, 1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_decisions_match_reference(seed, variant):
    """Admissions and their shed reasons, WFQ / priority / EDF picks,
    requeues at the front of a class, quota billing, shed picks, victims,
    peeks, removals and every metrics() dict, plus the AIMD budget
    trajectory, equal the reference's under a shared fake clock."""
    port_trace, port_budgets = _drive(port_sched, seed, variant)
    ref_trace, ref_budgets = _drive(ref_sched, seed, variant)
    assert len(port_trace) == len(ref_trace)
    for i, (a, b) in enumerate(zip(port_trace, ref_trace)):
        assert a == b, (i, a, b)
    assert port_budgets == ref_budgets
    kinds = {t[0] for t in port_trace}
    assert {"admit", "next", "requeue", "shed", "victim", "note"} <= kinds
    # the run exercised both the accept and the reject branches
    admits = [t[2] for t in port_trace if t[0] == "admit"]
    assert any(ok for ok, _ in admits) and any(not ok for ok, _ in admits)


def test_shed_vocabulary_and_controller_errors_match_reference():
    for name in ("SHED_QUEUE_FULL", "SHED_TENANT_QUEUE_FULL", "SHED_PAGE_PRESSURE",
                 "SHED_PAGE_EXHAUSTED", "SHED_DRAINING"):
        assert getattr(port_sched, name) == getattr(ref_sched, name)
    for kw in ({"slo_ms": 0}, {"slo_ms": 5, "budget": 9.0}, {"slo_ms": 5, "decrease": 1.0}):
        for mod in (port_sched, ref_sched):
            with pytest.raises(ValueError):
                mod.PrefillBudgetController(**kw)
    from dataclasses import asdict

    assert asdict(port_sched.SchedulerConfig()) == asdict(ref_sched.SchedulerConfig())
    assert asdict(port_sched.TenantConfig()) == asdict(ref_sched.TenantConfig())


class Allocator:
    """The allocator surface the page squeeze reads: a finite free list."""

    def __init__(self, n):
        self.free = list(range(1, n))[::-1]
        self.released = []

    def alloc(self):
        return self.free.pop() if self.free else None

    def release(self, page):
        self.released.append(page)
        self.free.append(page)


class Engine:
    def __init__(self, pages):
        self.step_count = 0
        self._allocator = Allocator(pages) if pages else None


def _drive_faults(mod, seed: int):
    """One seeded schedule of ``mod``'s FaultInjector through its engine
    and network hooks; returns its log, its sleeps and every answer."""
    sleeps = []
    fired = []
    inj = (mod.FaultInjector(seed=seed, sleep_fn=sleeps.append)
           .delay_decode(prob=0.3, delay_s=0.002)
           .delay_prefill(every=3, delay_s=0.004, start=2, stop=30)
           .squeeze_pages(at_step=5, pages=6, hold_steps=4)
           .squeeze_pages(at_step=12, pages=50, hold_steps=2)
           .storm(at_step=7, fire=lambda e: fired.append(e.step_count))
           .refuse_connect(replica="r1", count=2)
           .refuse_connect(count=None, prob=0.2)
           .slow_replica(replica="r0", delay_s=0.01, count=3)
           .drop_stream(replica="r1", after_tokens=2, count=2)
           .wrong_token(after_tokens=3, count=4))
    eng = Engine(pages=20)
    rng = np.random.RandomState(seed)
    answers = []
    for _ in range(60):
        inj.on_step(eng)
        if rng.rand() < 0.6:
            inj.before_prefill(eng)
        inj.before_decode(eng)
        if rng.rand() < 0.7:
            eng.step_count += 1
        replica = f"r{rng.randint(3)}"
        try:
            inj.before_connect(replica)
            answers.append(("connect", replica))
        except ConnectionRefusedError:
            answers.append(("refused", replica))
        for i in range(4):
            try:
                inj.on_stream_event(replica, i)
            except mod.StreamDropped:
                answers.append(("dropped", replica, i))
                break
            answers.append(("token", inj.corrupt_token(replica, i, 100 + i)))
    free_before = len(eng._allocator.free)
    inj.release_all(eng)
    answers.append(("released", len(eng._allocator.free) - free_before))
    answers.append(("cleared", inj.clear_network("wrong_token"), inj.clear_network()))
    flat = Engine(pages=0)
    inj2 = mod.FaultInjector(seed=seed).squeeze_pages(at_step=0, pages=4)
    inj2.on_step(flat)  # no arena to squeeze: the fault disarms
    return inj.log, sleeps, fired, answers, inj2.log


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fault_injector_log_matches_reference(seed):
    port = _drive_faults(port_faults, seed)
    ref = _drive_faults(ref_faults, seed)
    assert port == ref
    log = port[0]
    kinds = {k for _, k, _ in log}
    assert {"delay_decode", "delay_prefill", "squeeze_pages", "release_pages", "storm",
            "refuse_connect", "slow_replica", "drop_stream", "wrong_token"} <= kinds


def test_fault_builders_raise_where_the_reference_raises():
    for mod in (port_faults, ref_faults):
        inj = mod.FaultInjector()
        for call in (lambda: inj.delay_decode(), lambda: inj.delay_prefill(every=1, prob=0.5),
                     lambda: inj.refuse_connect(count=None),
                     lambda: inj.slow_replica(count=1, prob=0.5)):
            with pytest.raises(ValueError):
                call()
    with pytest.raises(port_faults.PoisonError):
        port_faults.poison_on_token(5, Req(3, "t", 0, None, 0.0, 1, 1))
    assert issubclass(port_faults.StreamDropped, ConnectionError)


def test_policy_modules_import_neither_jax_nor_the_reference():
    """The port's scheduler and faults modules are its own copies: importing
    them (and the engine that wires them) pulls in neither jax nor the
    JAX package."""
    code = ("import sys\n"
            "import accelerate_tpu_torch.serving.scheduler\n"
            "import accelerate_tpu_torch.serving.faults\n"
            "import accelerate_tpu_torch.serving.engine\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'accelerate_tpu' or m.startswith('accelerate_tpu.'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    for name in ("scheduler.py", "faults.py"):
        src = (ROOT / "accelerate_tpu_torch" / "serving" / name).read_text()
        imports = [line for line in src.splitlines() if line.startswith(("import ", "from "))]
        assert not any("jax" in line or "accelerate_tpu." in line or "torch" in line
                       for line in imports), imports
