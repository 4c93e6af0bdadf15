"""The port's ``Accelerator`` methods, trackers and training telemetry
against the JAX package's, on the CPU.

- ``gather``, ``gather_for_metrics``, ``reduce``, ``pad_across_processes``,
  ``set_trigger`` / ``check_trigger``, ``no_sync``, ``join_uneven_inputs``,
  ``autocast``, ``get_tracker`` give the reference's answers on one
  process for the same inputs; ``clip_grad_value_`` clips (the reference
  raises: ROADMAP queue 3); ``prepare_for_eval`` places a batch.
- ``JSONLTracker``'s ``metrics.jsonl`` has the reference's lines for the
  same calls (its clock aside); the import-gated trackers route through
  faked wandb / mlflow / comet_ml / aim / clearml / dvclive modules as the
  reference's tests show (``tests/test_tracking.py``'s fixture), end to end
  through ``Accelerator(log_with=...)``; ``filter_trackers`` skips what is
  not importable and raises on what it does not know.
- ``log_system_metrics`` after the same fp16 loop has the reference's
  keys but those of parts the port does not build (the cost registry's
  ``exe/*``, forensics' ``sys/recompiles_diagnosed``, JAX's compile
  counters) and ``sys/mfu_pct``, which the port reports only where it
  knows the card's peak (an H100): given one, it is there and equals the
  window's FLOPs over its wall. ``prometheus_metrics`` carries the series;
  ``metrics_jsonl`` writes one line an update; data loaders bill their
  wait; ``end_training`` closes the session and the trackers.
- ``CaptureWindow`` opens and closes a ``torch.profiler`` window at the
  configured steps and writes its trace.
"""

import json
import time

import numpy as np
import pytest

import jax
import optax
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model
from accelerate_tpu import tracking as ref_tracking
from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.state import AcceleratorState as JaxState
from accelerate_tpu.telemetry import TelemetryConfig as JaxTelemetryConfig
from accelerate_tpu_torch import Accelerator, DataLoader, tracking
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import random_params
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.telemetry import TelemetryConfig, current_session
from accelerate_tpu_torch.telemetry.recorder import CaptureWindow
from test_tracking import fake_modules  # noqa: F401 (the reference's faked backends)

SEQ = 128


@pytest.fixture
def jax_acc():
    JaxState._reset_state(reset_partial_state=True)
    yield JaxAccelerator()
    JaxState._reset_state(reset_partial_state=True)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_collectives_equal_the_reference_on_one_process(jax_acc):
    acc = Accelerator(device="cpu")
    x = np.random.RandomState(0).standard_normal((3, 5)).astype(np.float32)
    tree = {"a": x, "b": [x[:1], x[1:]]}
    ptree = {"a": torch.from_numpy(x), "b": [torch.from_numpy(x[:1]), torch.from_numpy(x[1:])]}
    for name, args, kwargs in (("gather", (), {}), ("reduce", ("sum", 2.0), {}),
                               ("reduce", ("mean", 1.0), {}),
                               ("pad_across_processes", (), {"dim": 1, "pad_index": -1})):
        want = getattr(jax_acc, name)(tree, *args, **kwargs)
        got = getattr(acc, name)(ptree, *args, **kwargs)
        np.testing.assert_allclose(_np(got["a"]), np.asarray(want["a"]), err_msg=name)
        for g, w in zip(got["b"], want["b"]):
            np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=name)
    for data in (torch.from_numpy(x), ["a", "b"], {"n": 3}):
        want = jax_acc.gather_for_metrics(data.numpy() if isinstance(data, torch.Tensor)
                                          else data)
        got = acc.gather_for_metrics(data)
        if isinstance(data, torch.Tensor):
            np.testing.assert_array_equal(_np(got), np.asarray(want))
        else:
            assert got == want
    assert acc.gather_for_metrics(["x"], use_gather_object=True) == \
        jax_acc.gather_for_metrics(["x"], use_gather_object=True)
    with pytest.raises(ValueError, match="reduction"):
        acc.reduce(ptree, "max")


def test_trigger_and_contexts_equal_the_reference(jax_acc):
    acc = Accelerator(device="cpu", gradient_accumulation_steps=2)
    for a in (jax_acc, acc):
        assert a.check_trigger() is False
        a.set_trigger()
    assert acc.check_trigger() is jax_acc.check_trigger() is True
    assert acc.check_trigger() is jax_acc.check_trigger() is False
    for a in (jax_acc, acc):
        assert a.sync_gradients
        with a.no_sync():
            assert not a.sync_gradients
        assert a.sync_gradients
        with a.join_uneven_inputs([]), a.autocast():
            pass
    assert type(acc.get_tracker("wandb")) is tracking.GeneralTracker
    assert acc.get_tracker("wandb").tracker is None
    assert type(jax_acc.get_tracker("wandb")).__name__ == "GeneralTracker"
    batch = acc.prepare_for_eval({"x": np.ones((2, 3), np.float32)})
    assert isinstance(batch["x"], torch.Tensor) and batch["x"].device.type == "cpu"


def test_clip_grad_value_clips_now():
    """The reference raises (its update is one sharded program); the port
    clamps every gradient entry in place, as upstream accelerate does."""
    acc = Accelerator(device="cpu")
    w = acc.prepare(torch.nn.Linear(4, 3))
    (w(torch.full((2, 4), 10.0)) ** 2).sum().backward()
    assert w.weight.grad.abs().max() > 1.0
    acc.clip_grad_value_(clip_value=0.5)
    assert w.weight.grad.abs().max() == 0.5 and w.bias.grad.abs().max() <= 0.5
    JaxState._reset_state(reset_partial_state=True)
    with pytest.raises(NotImplementedError):
        JaxAccelerator().clip_grad_value_(clip_value=0.5)
    JaxState._reset_state(reset_partial_state=True)


# -- trackers -----------------------------------------------------------------


def _jsonl_lines(cls, tmp_path, name):
    t = cls(name, tmp_path)
    t.store_init_configuration({"lr": 0.1, "nested": {"b": 2}})
    t.log({"loss": 1.5, "n": np.float32(2.0), "arr": np.arange(3)}, step=0)
    t.log({"loss": torch.tensor(1.0) if cls is tracking.JSONLTracker else 1.0}, step=1)
    t.finish()
    lines = [json.loads(line) for line in open(tmp_path / name / "metrics.jsonl")]
    for line in lines:
        line.pop("time", None)
    return lines


def test_jsonl_tracker_matches_the_reference_format(tmp_path):
    assert _jsonl_lines(tracking.JSONLTracker, tmp_path, "port") == \
        _jsonl_lines(ref_tracking.JSONLTracker, tmp_path, "ref")


def test_faked_backends_route_as_the_reference(fake_modules, tmp_path):  # noqa: F811
    """Each import-gated tracker makes the calls the reference's makes on
    the same faked module, and ``Accelerator(log_with=...)`` routes
    init_trackers / log / end_training through one."""
    cases = (("wandb", "WandBTracker", ("proj",), {"tags": ["a"]}),
             ("mlflow", "MLflowTracker", ("exp",), {}),
             ("comet_ml", "CometMLTracker", ("proj",), {}),
             ("aim", "AimTracker", ("run",), {"logging_dir": str(tmp_path)}),
             ("clearml", "ClearMLTracker", ("proj",), {}),
             ("dvclive", "DVCLiveTracker", ("run",), {}))
    for module, cls, args, kwargs in cases:
        calls = fake_modules[module]
        for impl in (ref_tracking, tracking):
            start = len(calls)
            t = getattr(impl, cls)(*args, **kwargs)
            t.store_init_configuration({"lr": 0.1, "huge": "x" * 1000})
            t.log({"loss": 1.0, "note": "s", "group": {"a": 1.0}}, step=3)
            t.finish()
            made = calls[start:]
            if impl is ref_tracking:
                want = made
        assert [(c[0], repr(c[1]), repr(c[2])) for c in made] == \
            [(c[0], repr(c[1]), repr(c[2])) for c in want], module
    assert set(tracking.get_available_trackers()) >= {
        tracking.LoggerType(n) for n, *_ in cases}
    acc = Accelerator(device="cpu", log_with="wandb")
    acc.init_trackers("proj", config={"lr": 0.1})
    acc.log({"loss": 2.0}, step=0)
    assert acc.get_tracker("wandb").tracker is not None
    acc.end_training()
    names = [c[0] for c in fake_modules["wandb"]]
    assert names[-3:] == ["config.update", "run.log", "run.finish"]


def test_filter_trackers(tmp_path, monkeypatch):
    assert tracking.filter_trackers(None) == []
    with pytest.raises(ValueError, match="Unknown tracker"):
        tracking.filter_trackers("nope", str(tmp_path))
    with pytest.raises(ValueError, match="logging_dir"):
        tracking.filter_trackers("jsonl")
    monkeypatch.setattr(tracking, "_available", lambda *names: False)
    assert tracking.filter_trackers(["jsonl", "wandb"], str(tmp_path)) == [
        tracking.LoggerType.JSONL]
    blank = tracking.GeneralTracker()
    assert tracking.filter_trackers([blank]) == [blank]


# -- training telemetry -------------------------------------------------------


def _ids():
    return np.random.RandomState(0).randint(0, 256, (3, 2, SEQ)).astype(np.int32)


def _reference_keys(tmp_path) -> set:
    JaxState._reset_state(reset_partial_state=True)
    acc = JaxAccelerator(mixed_precision="fp16", telemetry=JaxTelemetryConfig(
        trace_dir=str(tmp_path / "ref"), flight_hooks=False, timeline_interval_s=0))
    cfg = JaxConfig.tiny(num_kv_heads=2, max_seq_len=SEQ, attention_impl="xla")
    definition = JaxLM(cfg, mesh=acc.mesh)
    variables = definition.init_variables(jax.random.PRNGKey(0), batch_size=2, seq_len=SEQ)
    model, opt = acc.prepare(Model(definition, variables), optax.adamw(1e-3))
    for ids in _ids():
        with acc.accumulate(model):
            acc.backward(model(input_ids=ids, labels=ids)["loss"])
            opt.step()
            opt.zero_grad()
    keys = set(acc.log_system_metrics())
    acc.end_training()
    JaxState._reset_state(reset_partial_state=True)
    return keys


def _port_loop(tmp_path, **acc_kw):
    cfg = DecoderConfig.tiny(num_kv_heads=2, max_seq_len=SEQ, attention_impl="xla")
    model = DecoderLM(cfg, device="cpu", param_dtype=torch.float32).load_params(
        random_params(cfg, device="cpu", dtype=torch.float32))
    acc = Accelerator(mixed_precision="fp16", device="cpu", **acc_kw)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    loader = DataLoader([{"input_ids": row, "labels": row} for row in _ids().reshape(6, SEQ)],
                        batch_size=2)
    model, opt, loader = acc.prepare(model, opt, loader)
    values = []
    for batch in loader:
        with acc.accumulate(model):
            acc.backward(model(**batch)["loss"])
            opt.step()
            opt.zero_grad()
        values.append(acc.log_system_metrics())
    return acc, values


def test_rollup_keys_match_the_reference(tmp_path):
    want = _reference_keys(tmp_path)
    acc, values = _port_loop(tmp_path, telemetry=TelemetryConfig(
        trace_dir=str(tmp_path / "port"), flight_hooks=False, timeline_interval_s=0))
    got = set(values[-1])
    unbuilt = {k for k in want if k.startswith("exe/")}        # the cost registry
    unbuilt |= {"sys/recompiles_diagnosed"}                    # forensics
    unbuilt |= {k for k in want if k.startswith("sys/compile")}  # JAX's compiles, cache hits
    unbuilt |= {"sys/mfu_pct"}                                 # no known peak off an H100
    assert got == want - unbuilt
    assert (values[-1]["sys/loss_scale"], values[-1]["sys/last_step_skipped"]) == (
        acc.loss_scale.scale, acc.optimizer_step_was_skipped)
    assert values[-1]["sys/step"] == 3 and values[-1]["sys/data_wait_s"] > 0.0
    acc.end_training()
    assert current_session() is None


def test_mfu_metrics_file_and_exposition(tmp_path):
    """Given a peak, ``sys/mfu_pct`` is the window's FLOPs over its wall
    and the peak, to 1e-9; the per-update metrics file holds one line an
    update after the first (its clock start) with tokens, loss and MFU;
    the exposition carries the training series; JSONL trackers get every
    ``log_system_metrics`` call."""
    acc, _ = _port_loop(tmp_path, project_dir=str(tmp_path), log_with="jsonl",
                        telemetry=TelemetryConfig(trace_dir=str(tmp_path / "t"),
                                                  flight_hooks=False, timeline_interval_s=0,
                                                  metrics_jsonl=True))
    session = acc.telemetry
    session._peak = 1e12
    values = session.rollup()
    recs = list(session.window.records)
    flops = sum(r["flops"] for r in recs)
    wall = sum(r["wall_s"] for r in recs)
    assert values["sys/mfu_pct"] == pytest.approx(100.0 * flops / wall / 1e12, rel=1e-9)
    cfg = acc.model_config
    assert recs[-1]["flops"] == 2 * SEQ * (6 * cfg.num_params + 6 * cfg.num_layers * SEQ
                                           * cfg.embed_dim)
    text = acc.prometheus_metrics()
    for series in ("att_sys_loss_scale", "att_sys_loss ", "att_sys_tokens_per_s",
                   "att_sys_mfu_pct"):
        assert series in text, series
    acc.init_trackers("run")
    acc.log_system_metrics()
    acc.end_training()
    lines = [json.loads(line) for line in open(tmp_path / "t" / "metrics-host0.jsonl")]
    assert len(lines) == 2 and all({"tokens", "loss", "wall_s"} <= set(line) for line in lines)
    logged = [json.loads(line) for line in open(tmp_path / "run" / "metrics.jsonl")]
    assert logged[-1]["event"] == "log" and "sys/loss_scale" in logged[-1]["values"]


def test_telemetry_methods_need_a_session():
    acc = Accelerator(device="cpu")
    for call in (acc.log_system_metrics, acc.prometheus_metrics):
        with pytest.raises(RuntimeError, match="telemetry is not enabled"):
            call()
    acc.end_training()  # nothing to close


def test_capture_window_opens_and_closes_a_torch_profiler_window(tmp_path):
    """Steps 2..4 of ``profile_steps`` (2, 4): the window starts at step
    2 and stops at 4, one Chrome trace written; an armed trigger opens a
    window of ``window_steps`` at the next step; the injected start/stop
    callables see the same walk."""
    window = CaptureWindow(str(tmp_path), start_step=2, stop_step=4, window_steps=2)
    active = []
    for step in range(1, 7):
        window.on_step(step)
        torch.ones(8).sum()
        active.append(window.active)
    assert active == [False, True, True, False, False, False]
    assert window.captures == 1 and len(window.paths) == 1
    trace = json.load(open(window.paths[0]))
    assert "traceEvents" in trace
    calls = []
    armed = CaptureWindow(str(tmp_path), window_steps=2, start_fn=lambda d: calls.append("start"),
                          stop_fn=lambda: calls.append("stop"))
    assert armed.arm("itl_p99_slo") and not armed.arm("again")
    for step in range(10, 14):
        armed.on_step(step)
    assert calls == ["start", "stop"] and armed.reason == "itl_p99_slo"
    assert not armed.arm("third")  # one auto-arm a session


def test_session_builds_the_capture_window_from_the_config(tmp_path):
    acc = Accelerator(device="cpu", telemetry=TelemetryConfig(
        trace_dir=str(tmp_path), flight_hooks=False, timeline_interval_s=0,
        profile_steps=(1, 2)))
    assert isinstance(acc.telemetry.capture, CaptureWindow)
    assert acc.telemetry.capture.out_dir == str(tmp_path / "profile")
    acc.end_training()
    assert time.time() > 0 and current_session() is None
