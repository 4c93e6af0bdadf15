"""The port's telemetry modules (``accelerate_tpu_torch/telemetry``,
``utils/phases.py``) against the reference's on the CPU.

Two halves:
- parity: the same numpy-seeded inputs and the same fake clock go through
  the reference's and the port's ``StreamingHistogram`` (quantiles,
  merges, exemplar reservoirs, the exposition's rebuild),
  ``GoodputLedger``, ``UsageAccountant`` (windows, rates, integrals,
  snapshots), ``ArtifactWriter`` (rotation), ``SpanRecorder`` (the
  Chrome-trace lines), ``RequestTracer`` (the records) and
  ``prometheus_text`` (a session's histograms with exemplars). Tolerance:
  exact, except floating-point quantiles, which agree to 1e-12 relative;
- the jax-free serving cases of the reference's ``tests/test_telemetry.py``
  (``TestSpans``, ``TestStreamingHistogram``, ``TestExemplarReservoir``,
  ``TestArtifactWriter``, ``TestGoodputLedger``, ``TestFlightRecorder``,
  ``TestRequestTracerDrain``, ``TestExporter``), run against the port.
"""

from __future__ import annotations

import json
import os
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

from accelerate_tpu.telemetry import artifacts as ref_artifacts
from accelerate_tpu.telemetry import goodput as ref_goodput
from accelerate_tpu.telemetry import histograms as ref_hist
from accelerate_tpu.telemetry import requests as ref_requests
from accelerate_tpu.telemetry import spans as ref_spans
from accelerate_tpu.telemetry import usage as ref_usage
from accelerate_tpu.telemetry.exporter import prometheus_text as ref_prometheus_text
from accelerate_tpu_torch import telemetry as tel
from accelerate_tpu_torch.telemetry import artifacts, goodput, histograms, requests, usage
from accelerate_tpu_torch.telemetry import spans as spans_mod
from accelerate_tpu_torch.telemetry.exporter import prometheus_text
from accelerate_tpu_torch.telemetry.metrics import device_memory_stats, peak_flops, peak_hbm_bw

ROOT = Path(__file__).resolve().parent.parent
QUANTILE_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _disarm_spans():
    yield
    if tel.current_session() is not None:
        tel.current_session().close()
    spans_mod.disarm()
    ref_spans.disarm()


# -- parity with the reference's modules --------------------------------------


def _observations(seed: int, n: int):
    """(value, exemplar) pairs: lognormal latencies, every third without an
    exemplar, exemplar timestamps fixed so both sides store the same."""
    rng = np.random.RandomState(seed)
    vals = rng.lognormal(mean=-4.0, sigma=1.5, size=n)
    out = []
    for i, v in enumerate(vals):
        ex = None if i % 3 == 2 else {"request_id": f"req-{seed}-{i}",
                                      "unix_s": 1000.0 + i, "replica": f"r{i % 2}"}
        out.append((float(v), ex))
    return out


def _fill(cls, obs):
    h = cls()
    for v, ex in obs:
        h.observe(v, exemplar=ex)
    return h


def _hist_view(h):
    """Everything a histogram reports, quantiles apart."""
    return {
        "counts": dict(h.counts), "count": h.count, "sum": h.sum, "min": h.min, "max": h.max,
        "buckets": h.cumulative_buckets(),
        "exposition_exemplars": h.exposition_exemplars(),
        "near": [h.exemplar_near_quantile(q) for q in (0.5, 0.9, 0.99, 0.999)],
    }


def _assert_quantiles(t, r):
    for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0):
        a, b = t.quantile(q), r.quantile(q)
        assert (a is None) == (b is None)
        if a is not None:
            assert a == pytest.approx(b, rel=QUANTILE_RTOL, abs=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_matches_reference(seed):
    obs = _observations(seed, 4000)
    t, r = _fill(histograms.StreamingHistogram, obs), _fill(ref_hist.StreamingHistogram, obs)
    assert _hist_view(t) == _hist_view(r)
    _assert_quantiles(t, r)
    assert t.snapshot() == r.snapshot()
    assert histograms.percentile_keys("serving/itl", t) == \
        ref_hist.percentile_keys("serving/itl", r)
    # merges, both ways round, and the exposition's rebuild
    obs2 = _observations(seed + 10, 1500)
    t2, r2 = _fill(histograms.StreamingHistogram, obs2), _fill(ref_hist.StreamingHistogram, obs2)
    t.merge(t2)
    r.merge(r2)
    assert _hist_view(t) == _hist_view(r)
    _assert_quantiles(t, r)
    ex = sorted(t.exposition_exemplars().items())
    tb = histograms.StreamingHistogram.from_cumulative(t.cumulative_buckets(), sum_value=t.sum,
                                                       exemplars=ex)
    rb = ref_hist.StreamingHistogram.from_cumulative(r.cumulative_buckets(), sum_value=r.sum,
                                                     exemplars=ex)
    assert _hist_view(tb) == _hist_view(rb)
    _assert_quantiles(tb, rb)


@pytest.mark.parametrize("seed", [0, 1])
def test_goodput_ledger_matches_reference(seed):
    rng = np.random.RandomState(seed)
    now = [0.0]
    clock = lambda: now[0]  # noqa: E731
    t, r = goodput.GoodputLedger(clock=clock), ref_goodput.GoodputLedger(clock=clock)
    for _ in range(200):
        op = rng.randint(4)
        a, b, c = (float(x) for x in rng.exponential(0.05, size=3))
        comp = b * (rng.rand() < 0.1)
        for led in (t, r):
            if op == 0:
                led.on_step(a, compile_s=comp, data_wait_s=c)
            elif op == 1:
                led.note_phase("checkpoint/save" if a > 0.05 else "dispatch", b)
            elif op == 2:
                led.note_stall(c)
            else:
                led.add("data_wait", a)
        now[0] += float(rng.exponential(0.2))
        assert t.totals() == r.totals()
    assert t.fractions() == r.fractions()
    assert t.rollup_keys() == r.rollup_keys()
    assert t.snapshot() == r.snapshot()


@pytest.mark.parametrize("seed", [0, 1])
def test_usage_accountant_matches_reference(seed, tmp_path):
    rng = np.random.RandomState(seed)
    now = [0.0]
    clock = lambda: now[0]  # noqa: E731
    t = usage.UsageAccountant(clock=clock, max_tenants=5, window_marks=16)
    r = ref_usage.UsageAccountant(clock=clock, max_tenants=5, window_marks=16)
    tenants = [f"t{i}" for i in range(7)]  # past max_tenants: the overflow fold
    for step in range(400):
        name = tenants[rng.randint(len(tenants))]
        op = rng.randint(9)
        n = int(rng.randint(1, 9))
        for acc in (t, r):
            if op == 0:
                acc.note_submit(name)
            elif op == 1:
                acc.note_outcome(name, ("finished", "shed", "cancelled", "evicted")[n % 4])
            elif op == 2:
                acc.note_preempt(name)
            elif op == 3:
                acc.note_prefill(name, n)
            elif op == 4:
                acc.note_decode(name, n)
            elif op == 5:
                acc.note_prefix_hit(name, n)
            elif op == 6:
                acc.note_compute(name, n * 0.37)
            elif op == 7:
                acc.note_pages(name, n - 4)
            else:
                acc.note_tier_bytes(name, ("host", "disk", "peer")[n % 3], n * 1024 - 4096)
        now[0] += float(rng.exponential(0.05))
        if step % 25 == 0:
            t.mark()
            r.mark()
    assert t.totals() == r.totals()
    assert t.rollup_keys() == r.rollup_keys()
    assert t.snapshot() == r.snapshot()
    for secs in (0.1, 1.0, 5.0, 100.0):
        assert t.window(secs) == r.window(secs)
        assert t.rates(secs) == r.rates(secs)
    t.write_snapshot(str(tmp_path / "usage-host0.json"))
    r.write_snapshot(str(tmp_path / "usage-host1.json"))
    assert usage.load_usage(str(tmp_path)) == ref_usage.load_usage(str(tmp_path))


def test_artifact_writer_rotation_matches_reference(tmp_path):
    rng = np.random.RandomState(0)
    recs = [{"seq": i, "pad": "x" * int(rng.randint(10, 120))} for i in range(600)]
    for side, mod in (("port", artifacts), ("ref", ref_artifacts)):
        w = mod.ArtifactWriter(str(tmp_path / side / "requests-host0.jsonl"),
                               max_bytes=2048, max_generations=2)
        for rec in recs:
            w.write(rec)
        w.close()
    views = {}
    for side in ("port", "ref"):
        files = artifacts.artifact_files(str(tmp_path / side), "requests-host*.jsonl")
        views[side] = ([os.path.basename(f) for f in files],
                       [Path(f).read_bytes() for f in files],
                       artifacts.read_jsonl(str(tmp_path / side), "requests-host*.jsonl"))
    assert views["port"] == views["ref"]
    assert views["port"][0] == ["requests-host0.jsonl.2", "requests-host0.jsonl.1",
                                "requests-host0.jsonl"]
    assert ref_artifacts.read_jsonl(str(tmp_path / "port"), "requests-host*.jsonl") == \
        views["ref"][2]


def test_span_recorder_lines_match_reference(tmp_path):
    rng = np.random.RandomState(0)
    t = spans_mod.SpanRecorder(str(tmp_path / "port.jsonl"), process_index=2)
    r = ref_spans.SpanRecorder(str(tmp_path / "ref.jsonl"), process_index=2)
    r._epoch = t._epoch
    for i in range(50):
        t0 = t._epoch + float(rng.exponential(1.0))
        dur = float(rng.exponential(0.01))
        args = {"request_id": i, "slot": i % 3} if i % 2 else None
        for rec in (t, r):
            rec.emit(f"serving/span{i % 4}", t0, dur, cat="serving", args=args)
    t.close()
    r.close()
    lt = [json.loads(x) for x in open(tmp_path / "port.jsonl")]
    lr = [json.loads(x) for x in open(tmp_path / "ref.jsonl")]
    lt[0]["args"].pop("epoch_unix_s")
    lr[0]["args"].pop("epoch_unix_s")
    assert lt == lr
    assert [e["name"] for e in t.ring] == [e["name"] for e in r.ring]
    assert spans_mod.load_chrome_trace(str(tmp_path / "port.jsonl"))["traceEvents"][1:] == \
        ref_spans.load_chrome_trace(str(tmp_path / "ref.jsonl"))["traceEvents"][1:]


def _req(i, prompt_len=5):
    return types.SimpleNamespace(id=i, prompt=np.zeros(prompt_len, np.int32),
                                 max_new_tokens=8, tenant=f"t{i % 2}", priority=i % 3,
                                 submit_t=time.perf_counter(), finish_t=None,
                                 outcome=None, shed_reason=None, prefix_hit=i,
                                 pages_allocated=2 * i, spec_proposed=0, spec_accepted=0,
                                 prefill_kernel="ragged", replica="r0" if i % 2 else None)


def test_request_tracer_records_match_reference(tmp_path):
    """The same lifecycle through both tracers (no session): the records
    equal but the timings, and an unfinished request drains ``evicted``."""
    out = {}
    for side, mod in (("port", requests), ("ref", ref_requests)):
        tr = mod.RequestTracer(None, str(tmp_path / f"{side}.jsonl"), itl_series_max=3)
        tr.session = types.SimpleNamespace(histogram=lambda name: histograms.StreamingHistogram(),
                                           recorder=None, flight=None)
        reqs = [_req(i) for i in range(4)]
        for i, q in enumerate(reqs):
            tr.on_submit(q)
            tr.on_admission(q, i % 2, 0.001)
            tr.on_prefill_chunk(q, i % 2, 0, 8, time.perf_counter(), 0.002)
            if i == 1:
                tr.on_preempt(q)
                tr.on_resume(q, 0)
            if i < 3:
                tr.on_first_token(q, 0.01)
                for k in range(1, 6):
                    tr.on_token(q, 0.003, k)
                q.outcome = ("finished", "shed", "cancelled")[i]
                q.shed_reason = "queue_full" if i == 1 else None
                q.finish_t = time.perf_counter()
                tr.on_finish(q, ("budget", "shed", "timeout")[i])
        assert [x["request_id"] for x in tr.inflight()] == [3]
        tr.close()
        out[side] = [json.loads(x) for x in open(tmp_path / f"{side}.jsonl")]
    timing = ("submit_unix_s", "finish_unix_s", "total_ms", "compiles_in_flight")

    def strip(rec):
        rec = {k: v for k, v in rec.items() if k not in timing}
        rec["prefill_chunks"] = [{k: v for k, v in c.items() if k != "ms"}
                                 for c in rec["prefill_chunks"]]
        return rec

    assert [strip(x) for x in out["port"]] == [strip(x) for x in out["ref"]]
    assert [set(x) for x in out["port"]] == [set(x) for x in out["ref"]]
    assert out["port"][-1]["outcome"] == "evicted" and out["port"][-1]["request_id"] == 3


def test_exposition_of_histograms_matches_reference(tmp_path):
    """A session's histograms and their exemplars render line for line as
    the reference's do (the gauge sections differ: the reference's session
    carries parts the port does not build yet)."""
    from accelerate_tpu.telemetry import TelemetryConfig as JaxTelemetryConfig
    from accelerate_tpu.telemetry import TelemetrySession as JaxTelemetrySession

    obs = {name: _observations(i, 300)
           for i, name in enumerate(("serving/ttft", "serving/itl", "serving/queue_wait"))}
    texts = []
    for cls, cfg in ((tel.TelemetrySession, tel.TelemetryConfig),
                     (JaxTelemetrySession, JaxTelemetryConfig)):
        kw = dict(trace_dir=str(tmp_path / cls.__module__), flight_hooks=False)
        if cls is JaxTelemetrySession:
            kw["timeline_interval_s"] = 0
        session = cls(cfg(**kw))
        try:
            for name, pairs in obs.items():
                h = session.histogram(name)
                for v, ex in pairs:
                    h.observe(v, exemplar=ex)
            texts.append(prometheus_text(session) if cls is tel.TelemetrySession
                         else ref_prometheus_text(session))
            rollup = session.rollup()
            texts.append({k: v for k, v in rollup.items() if k.startswith("serving/")})
        finally:
            session.close()

    def hist_lines(text):
        return [line for line in text.splitlines() if "_seconds" in line]

    assert hist_lines(texts[0]) == hist_lines(texts[2])
    assert len(hist_lines(texts[0])) > 3 * 10
    assert texts[1] == texts[3]  # percentile keys and p99 exemplars alike


def test_peaks_and_memory_on_the_cpu():
    """No card here: no peak (so no MFU key) and no memory gauges; the
    H100 is named by its card name."""
    assert peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert peak_hbm_bw("NVIDIA H100 80GB HBM3") == 3.35e12
    assert peak_flops("NVIDIA A100-SXM4-80GB") is None
    assert peak_flops() is None and peak_hbm_bw() is None
    assert device_memory_stats(per_device=True) == {}


# -- the reference's jax-free serving cases, against the port ----------------


class TestSpans:
    def test_jsonl_is_chrome_trace(self, tmp_path):
        path = str(tmp_path / "trace.jsonl")
        spans_mod.arm(path, process_index=3, ring=8)
        with spans_mod.span("outer", phase="demo"):
            with spans_mod.span("inner"):
                time.sleep(0.01)
        spans_mod.disarm()
        lines = [json.loads(line) for line in open(path) if line.strip()]
        assert lines[0]["ph"] == "M"  # process_name metadata
        events = [e for e in lines if e["ph"] == "X"]
        by_name = {e["name"]: e for e in events}
        assert set(by_name) == {"outer", "inner"}
        for e in events:
            assert {"name", "ph", "ts", "dur", "pid", "tid"} <= set(e)
            assert e["pid"] == 3
        outer, inner = by_name["outer"], by_name["inner"]
        assert outer["tid"] == inner["tid"]
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
        trace = spans_mod.load_chrome_trace(path)
        assert isinstance(trace["traceEvents"], list) and len(trace["traceEvents"]) == 3

    def test_span_noop_when_disarmed(self):
        with spans_mod.span("nothing"):
            pass
        assert spans_mod.last_spans() == []

    def test_last_spans_ring(self, tmp_path):
        spans_mod.arm(str(tmp_path / "t.jsonl"), ring=2)
        for name in ("a", "b", "c"):
            with spans_mod.span(name):
                pass
        assert [s["name"] for s in spans_mod.last_spans()] == ["b", "c"]

    def test_phases_bridge(self, tmp_path):
        from accelerate_tpu_torch.utils import phases

        path = str(tmp_path / "phases.jsonl")
        spans_mod.arm(path)
        acc = phases.collect_phases()
        with phases.phase("ckpt_read"):
            time.sleep(0.005)
        assert acc["ckpt_read"] >= 0.005
        assert phases.phases_snapshot() == acc
        phases.add_phase("thread_wall", 0.25)
        assert acc["thread_wall"] == 0.25
        spans_mod.disarm()
        names = [json.loads(line)["name"] for line in open(path) if line.strip()]
        assert "ckpt_read" in names
        phases._ACTIVE = None

    def test_annotate_bridges_into_torch_profiler(self, tmp_path):
        """``annotate=True`` brackets the span with
        ``torch.profiler.record_function``: the span's name shows in a
        profiler trace taken around it."""
        import torch

        spans_mod.arm(str(tmp_path / "t.jsonl"))
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with spans_mod.span("serving/annotated", annotate=True):
                torch.ones(4).sum()
        assert any(e.key == "serving/annotated" for e in prof.key_averages())


class TestStreamingHistogram:
    def test_quantiles_within_bucket_error(self):
        h = histograms.StreamingHistogram()
        for i in range(1, 1001):  # 1ms .. 1s, uniform
            h.add(i / 1000)
        assert h.quantile(0.50) == pytest.approx(0.5, rel=0.13)
        assert h.quantile(0.95) == pytest.approx(0.95, rel=0.13)
        assert h.quantile(0.99) == pytest.approx(0.99, rel=0.13)
        snap = h.snapshot()
        assert snap["count"] == 1000
        assert snap["min_s"] == 0.001 and snap["max_s"] == 1.0
        assert snap["sum_s"] == pytest.approx(500.5)

    def test_empty_and_garbage_inputs(self):
        h = histograms.StreamingHistogram()
        assert h.quantile(0.5) is None and h.snapshot() == {}
        h.add(-1.0)
        h.add(float("nan"))
        assert h.count == 0
        h.add(0.0)
        assert h.count == 1 and h.quantile(0.99) == 0.0

    def test_cumulative_buckets_are_monotone_and_complete(self):
        h = histograms.StreamingHistogram()
        for v in (0.001, 0.002, 0.004, 0.1, 0.1, 3.0):
            h.add(v)
        buckets = h.cumulative_buckets()
        les = [le for le, _ in buckets]
        cums = [c for _, c in buckets]
        assert les == sorted(les)
        assert cums == sorted(cums) and cums[-1] == h.count

    def test_merge_matches_combined_stream(self):
        a, b, both = (histograms.StreamingHistogram() for _ in range(3))
        for i, v in enumerate(x / 100 for x in range(1, 200)):
            (a if i % 2 else b).add(v)
            both.add(v)
        a.merge(b)
        assert a.count == both.count and a.sum == pytest.approx(both.sum)
        assert a.quantile(0.95) == both.quantile(0.95)
        with pytest.raises(ValueError, match="layouts differ"):
            a.merge(histograms.StreamingHistogram(growth=1.5))

    def test_percentile_keys(self):
        h = histograms.StreamingHistogram()
        assert histograms.percentile_keys("serving/ttft", h) == {}
        h.add(0.1)
        out = histograms.percentile_keys("serving/ttft", h)
        assert out["serving/ttft_count"] == 1
        assert out["serving/ttft_p99_ms"] == pytest.approx(100, rel=0.13)


class TestExemplarReservoir:
    def test_bounded_under_10k_observations(self):
        rng = np.random.RandomState(0)
        h = histograms.StreamingHistogram()
        worst = 0.0
        for i in range(10_000):
            v = float(rng.lognormal(mean=-3.0, sigma=1.0))
            worst = max(worst, v)
            h.observe(v, exemplar={"request_id": f"req-{i}", "replica": "r0"})
        assert h.count == 10_000
        for res in h.exemplars.values():
            assert 1 <= len(res) <= histograms.EXEMPLARS_PER_BUCKET
        kept = [e for res in h.exemplars.values() for e in res]
        assert max(histograms._entry_value(e) for e in kept) == pytest.approx(worst)
        near = h.exemplar_near_quantile(0.999)
        assert near is not None and near["value"] >= h.quantile(0.99) * 0.8
        for le, entry in h.exposition_exemplars().items():
            assert set(entry) >= {"request_id", "value", "unix_s"}
            assert entry["value"] <= le * 1.0001
            assert entry["replica"] == "r0"

    def test_disabled_and_anonymous_observations_cost_nothing(self):
        h = histograms.StreamingHistogram()
        h.exemplars_enabled = False
        h.observe(0.1, exemplar={"request_id": "req-0"})
        h.observe(0.2)
        h.exemplars_enabled = True
        h.observe(0.3, exemplar={"replica": "r0"})  # no request_id: dropped
        assert h.count == 3 and h.exemplars == {}
        assert h.exemplar_near_quantile(0.99) is None

    def test_merge_unions_bounded_newest_wins(self):
        a, b = histograms.StreamingHistogram(), histograms.StreamingHistogram()
        for h, rid, v, t in [(a, "a-old", 0.1000, 10.0), (a, "a-max", 0.1040, 20.0),
                             (b, "b-mid", 0.1010, 30.0), (b, "b-new", 0.1020, 40.0)]:
            h.observe(v, exemplar={"request_id": rid, "unix_s": t})
        a.merge(b)
        assert len(a.exemplars) == 1
        (res,) = a.exemplars.values()
        assert len(res) <= histograms.EXEMPLARS_PER_BUCKET
        assert {e["request_id"] for e in res} == {"a-max", "b-new"}
        assert res[0]["request_id"] == "a-max"

    def test_percentile_keys_name_p99_culprit(self):
        h = histograms.StreamingHistogram()
        for i in range(97):
            h.observe(0.010, exemplar={"request_id": f"fast-{i}"})
        for i in range(3):
            h.observe(1.5, exemplar={"request_id": f"slow-{i}"})
        out = histograms.percentile_keys("serving/itl", h)
        assert out["serving/itl_p99_exemplar"].startswith("slow-")
        assert isinstance(out["serving/itl_p99_ms"], float)


class TestArtifactWriter:
    def test_rotation_stays_bounded_with_zero_reader_errors(self, tmp_path):
        path = str(tmp_path / "requests-host0.jsonl")
        w = artifacts.ArtifactWriter(path, max_bytes=4096, max_generations=3)
        n = 2000
        for i in range(n):
            w.write({"request_id": f"req-{i}", "seq": i, "pad": "x" * 40})
        w.close()
        assert w.rotations > 3
        files = artifacts.artifact_files(str(tmp_path), "requests-host*.jsonl")
        assert 1 <= len(files) <= 4
        for f in files:
            assert os.path.getsize(f) <= 4096 + 256
        seqs = [r["seq"] for r in artifacts.read_jsonl(str(tmp_path), "requests-host*.jsonl")]
        assert seqs == sorted(seqs)
        assert seqs[-1] == n - 1

    def test_torn_tail_skipped_earlier_records_intact(self, tmp_path):
        path = str(tmp_path / "alerts-host0.jsonl")
        w = artifacts.ArtifactWriter(path)
        for i in range(5):
            w.write({"seq": i})
        w.close()
        with open(path, "ab") as fh:  # a kill -9 mid-append
            fh.write(b'{"seq": 5, "never_fini')
        assert [r["seq"] for r in artifacts.read_jsonl(path)] == [0, 1, 2, 3, 4]


class TestGoodputLedger:
    def test_fractions_sum_to_one_under_synthetic_session(self):
        now = [0.0]
        led = goodput.GoodputLedger(clock=lambda: now[0])
        for _ in range(6):
            led.on_step(wall_s=1.0, compile_s=0.2, data_wait_s=0.1)
        led.note_phase("checkpoint/save", 1.5)
        led.note_phase("dispatch_total", 9.0)  # non-checkpoint phase: ignored
        led.note_stall(0.5)
        now[0] = 10.0
        fr = led.fractions()
        assert sum(fr.values()) == pytest.approx(1.0)
        assert fr["compute"] == pytest.approx(0.42)
        assert fr["compile"] == pytest.approx(0.12)
        assert fr["data_wait"] == pytest.approx(0.06)
        assert fr["checkpoint"] == pytest.approx(0.15)
        assert fr["stall"] == pytest.approx(0.05)
        assert fr["idle"] == pytest.approx(0.20)
        keys = led.rollup_keys()
        assert keys["goodput/goodput_frac"] == pytest.approx(0.42)

    def test_overlapping_instrumentation_renormalizes(self):
        now = [0.0]
        led = goodput.GoodputLedger(clock=lambda: now[0])
        led.on_step(wall_s=8.0)
        led.note_stall(4.0)
        now[0] = 10.0
        assert sum(led.fractions().values()) == pytest.approx(1.0)

    def test_compute_clamps_when_compile_exceeds_wall(self):
        led = goodput.GoodputLedger()
        led.on_step(wall_s=0.5, compile_s=2.0)
        t = led.totals()
        assert t["compute"] == 0.0 and t["compile"] == pytest.approx(2.0)

    def test_checkpoint_phase_feeds_armed_ledger(self):
        from accelerate_tpu_torch.utils import phases

        led = goodput.arm(goodput.GoodputLedger())
        try:
            with phases.phase("checkpoint/save"):
                time.sleep(0.01)
            assert led.totals()["checkpoint"] >= 0.01
        finally:
            goodput.disarm()
        assert goodput.ledger() is None


class TestFlightRecorder:
    def test_ring_bounded_and_bundle_contents(self, tmp_path):
        from accelerate_tpu_torch.telemetry.recorder import FlightRecorder

        fr = FlightRecorder(None, dump_dir=str(tmp_path), capacity=16)
        for i in range(40):
            fr.note("evt", i=i)
        assert len(fr.ring) == 16
        path = fr.dump("manual", extra={"marker": "x"})
        data = json.load(open(path))
        assert data["reason"] == "manual" and data["marker"] == "x"
        assert [e["i"] for e in data["events"]] == list(range(24, 40))
        assert "thread_stacks" in data and "compile_counters" in data
        assert set(data["compile_counters"]) == {"count", "seconds", "cache_hits"}

    def test_excepthook_chains_and_dumps(self, tmp_path):
        from accelerate_tpu_torch.telemetry.recorder import FlightRecorder

        fr = FlightRecorder(None, dump_dir=str(tmp_path))
        prev_called = []
        old_hook = sys.excepthook
        sys.excepthook = lambda *a: prev_called.append(a)
        try:
            fr.install_hooks()
            try:
                raise ValueError("boom-for-the-bundle")
            except ValueError:
                sys.excepthook(*sys.exc_info())
            assert fr.dump_count == 1
            assert prev_called, "previous excepthook must still run"
            data = json.load(open(fr.last_bundle_path))
            assert data["reason"] == "unhandled_exception"
            assert "boom-for-the-bundle" in data["exception"]
        finally:
            fr.uninstall_hooks()
            sys.excepthook = old_hook

    def test_sigterm_dumps_bundle_in_subprocess(self, tmp_path):
        """SIGTERM must leave a debug bundle behind and still terminate
        the process with the default disposition."""
        import subprocess

        code = (
            "import os, signal\n"
            "from accelerate_tpu_torch.telemetry import TelemetryConfig, TelemetrySession\n"
            f"s = TelemetrySession(TelemetryConfig(trace_dir={str(tmp_path)!r}, "
            "spans=False, watchdog=False))\n"
            "s.flight.note('marker', detail='pre-term')\n"
            "os.kill(os.getpid(), signal.SIGTERM)\n"
            "raise SystemExit('unreachable: SIGTERM must terminate')\n"
        )
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, env=env, timeout=300, cwd=ROOT)
        assert r.returncode == -15, (r.returncode, r.stdout, r.stderr)
        bundles = sorted(tmp_path.glob("flightrec-host0-*.json"))
        assert bundles, r.stderr
        data = json.load(open(bundles[-1]))
        assert data["reason"] == "sigterm"
        assert any(e.get("kind") == "marker" for e in data["events"])


class TestRequestTracerDrain:
    def test_close_drains_inflight_as_evicted(self, tmp_path):
        path = str(tmp_path / "requests.jsonl")
        tracer = requests.RequestTracer(None, path)
        req = types.SimpleNamespace(prompt=np.zeros(4, np.int32), id=7,
                                    max_new_tokens=8, submit_t=time.perf_counter())
        tracer.on_submit(req)
        assert [r["request_id"] for r in tracer.inflight()] == [7]
        tracer.close()
        recs = [json.loads(line) for line in open(path)]
        assert len(recs) == 1
        assert recs[0]["request_id"] == 7
        assert recs[0]["finish_reason"] == "evicted"
        assert recs[0]["total_ms"] >= 0 and recs[0]["compiles_in_flight"] == 0
        assert tracer.inflight() == []


class TestExporter:
    def test_prometheus_text_renders_gauges_and_histograms(self, tmp_path):
        session = tel.TelemetrySession(tel.TelemetryConfig(
            trace_dir=str(tmp_path), spans=False, watchdog=False, flight_hooks=False))
        try:
            h = session.histogram("serving/ttft")
            for v in (0.01, 0.02, 0.5):
                h.add(v)
            session.window.add({"step": 1, "wall_s": 0.5, "tokens": 100})
            text = prometheus_text(session)
            assert "# TYPE att_sys_tokens_per_s gauge" in text
            assert "# TYPE att_serving_ttft_seconds histogram" in text
            assert 'att_serving_ttft_seconds_bucket{le="+Inf"} 3' in text
            assert "att_serving_ttft_seconds_count 3" in text
            assert "att_serving_ttft_seconds_p99" in text
            cums = [int(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                    if line.startswith("att_serving_ttft_seconds_bucket")]
            assert cums == sorted(cums)
        finally:
            session.close()

    def test_scrape_thread_serves_metrics(self, tmp_path):
        import urllib.request

        session = tel.TelemetrySession(tel.TelemetryConfig(
            trace_dir=str(tmp_path), spans=False, watchdog=False, flight_hooks=False,
            exporter_port=0))
        try:
            assert session.exporter is not None and session.exporter.port
            session.histogram("serving/itl").add(0.002)
            url = f"http://127.0.0.1:{session.exporter.port}/metrics"
            body = urllib.request.urlopen(url, timeout=10).read().decode()
            assert "att_serving_itl_seconds_count 1" in body
        finally:
            session.close()
        assert session.exporter.server is None  # closed with the session


class TestConfigResolution:
    def test_resolve(self):
        assert tel.resolve_config(False) is None
        assert isinstance(tel.resolve_config(True), tel.TelemetryConfig)
        cfg = tel.TelemetryConfig(enabled=False)
        assert tel.resolve_config(cfg) is None
        with pytest.raises(TypeError):
            tel.resolve_config("yes")

    def test_env_gate(self, monkeypatch):
        for k in ("ATT_TELEMETRY", "ATT_TELEMETRY_WATCHDOG_S", "ATT_TELEMETRY_DIR",
                  "ATT_TELEMETRY_PORT", "ATT_TELEMETRY_PROFILE_STEPS"):
            monkeypatch.delenv(k, raising=False)
        assert tel.resolve_config(None) is None
        monkeypatch.setenv("ATT_TELEMETRY", "1")
        monkeypatch.setenv("ATT_TELEMETRY_DIR", "/tmp/x")
        monkeypatch.setenv("ATT_TELEMETRY_PORT", "9109")
        cfg = tel.resolve_config(None)
        assert cfg.trace_dir == "/tmp/x" and cfg.exporter_port == 9109
        monkeypatch.setenv("ATT_TELEMETRY_PROFILE_STEPS", "3:5")
        assert tel.resolve_config(None).profile_steps == (3, 5)
