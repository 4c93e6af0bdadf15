"""The port's ``get_logger``, ``tqdm`` and ``Accelerator.profile``
against the JAX package's, on the CPU.

- ``get_logger``: at each place of a 2-process topology (set alike on
  both singletons), the records of ``main_process_only`` True / False
  and ``in_order`` equal the reference's; ``warning_once`` logs once;
  ``ACCELERATE_TPU_LOG_LEVEL`` and ``log_level`` set the level as the
  reference's do. Before any state exists and without CUDA the port's
  logger logs on process 0 and creates no state (the reference builds a
  ``PartialState`` there, which in the port would raise without CUDA).
- ``tqdm`` is disabled off the main process (off the node's main with
  ``local=True``) as the reference's is, works without CUDA or a state,
  and passes the iterable through where ``tqdm`` is not installed.
- ``Accelerator(cpu=True).profile`` writes a Chrome trace that parses
  and holds an ``annotate`` range and the ops inside it, calls
  ``on_trace_ready``, and with a schedule writes one trace a cycle.
"""

import json
import logging
import shutil
import sys

import numpy as np
import pytest
import torch

from accelerate_tpu import logging as ref_logging
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu.utils.tqdm import tqdm as ref_tqdm
from accelerate_tpu_torch import Accelerator, PartialState, ProfileKwargs
from accelerate_tpu_torch import logging as port_logging
from accelerate_tpu_torch.utils.tqdm import tqdm as port_tqdm
from accelerate_tpu_torch.utils.profiler import annotate


@pytest.fixture
def fresh():
    PartialState._reset_state()
    JaxAcceleratorState._reset_state(reset_partial_state=True)
    yield
    PartialState._reset_state()
    JaxAcceleratorState._reset_state(reset_partial_state=True)


def _place(index, count, local=None):
    states = (PartialState(cpu=True), JaxPartialState(cpu=True))
    for s in states:
        s.process_index, s.num_processes = index, count
        s.local_process_index = index if local is None else local
    return states


def _records(module, name, caplog, monkeypatch, state_cls):
    """The messages ``module.get_logger`` emits for a fixed script of calls."""
    waits = []
    monkeypatch.setattr(state_cls, "wait_for_everyone", lambda self: waits.append(1))
    caplog.clear()
    log = module.get_logger(name, log_level="INFO")
    with caplog.at_level(logging.INFO, logger=name):
        log.info("main only")
        log.info("everyone", main_process_only=False)
        log.warning("in order", in_order=True)
        log.warning("in order everyone", main_process_only=False, in_order=True)
        log.debug("below the level", main_process_only=False)
        for _ in range(3):
            log.warning_once("once %s", name)
    return [(r.levelname, r.getMessage()) for r in caplog.records], len(waits)


@pytest.mark.parametrize("index", [0, 1])
def test_logger_matches_the_reference(fresh, caplog, monkeypatch, index):
    _place(index, 2)
    got = _records(port_logging, "port.test", caplog, monkeypatch, PartialState)
    want = _records(ref_logging, "ref.test", caplog, monkeypatch, JaxPartialState)
    fix = [(lvl, msg.replace("ref.test", "port.test")) for lvl, msg in want[0]]
    assert got[0] == fix
    assert got[1] == want[1]  # the barriers in_order waits at
    if index == 0:
        assert ("WARNING", "once port.test") in got[0]
    else:
        assert ("INFO", "main only") not in got[0] and ("INFO", "everyone") in got[0]


def test_log_level_variable_matches_the_reference(fresh, monkeypatch):
    root = logging.getLogger().level
    try:
        for level in ("DEBUG", "error", None):
            if level is None:
                monkeypatch.delenv("ACCELERATE_TPU_LOG_LEVEL", raising=False)
            else:
                monkeypatch.setenv("ACCELERATE_TPU_LOG_LEVEL", level)
            a = port_logging.get_logger(f"port.level.{level}")
            b = ref_logging.get_logger(f"ref.level.{level}")
            assert a.logger.level == b.logger.level
            assert a.logger.root.level == b.logger.root.level
        assert port_logging.get_logger("x.y", log_level="warning").logger.level == logging.WARNING
    finally:
        logging.getLogger().setLevel(root)


def test_logger_and_tqdm_need_no_state_or_cuda(fresh, caplog, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    log = port_logging.get_logger("port.nostate", log_level="INFO")
    with caplog.at_level(logging.INFO, logger="port.nostate"):
        log.info("before any state")
        log.info("with the keywords", main_process_only=True, in_order=True)
    assert [r.getMessage() for r in caplog.records] == ["before any state", "with the keywords"]
    assert list(port_tqdm(range(3), disable=True)) == [0, 1, 2]
    bar = port_tqdm(range(2))
    assert not bar.disable
    bar.close()
    assert not PartialState._shared_state  # neither created a state


@pytest.mark.parametrize("index,local", [(0, 0), (1, 1), (2, 0), (3, 1)])
def test_tqdm_matches_the_reference(fresh, index, local):
    _place(index, 4, local=local)
    for main_only in (True, False):
        for local_flag in (False, True):
            bars = [impl(range(3), main_process_only=main_only, local=local_flag)
                    for impl in (port_tqdm, ref_tqdm)]
            assert bars[0].disable == bars[1].disable
            assert list(bars[0]) == list(bars[1]) == [0, 1, 2]
            for bar in bars:
                bar.close()


def test_tqdm_passes_through_without_tqdm(fresh, monkeypatch):
    monkeypatch.setitem(sys.modules, "tqdm.auto", None)  # import fails
    for impl in (port_tqdm, ref_tqdm):
        assert list(impl([4, 5])) == [4, 5]
        assert list(impl(iterable=[6])) == [6]
        assert list(impl()) == []


def _trace(path):
    with open(path) as f:
        return json.load(f)


def test_profile_writes_a_trace_with_the_annotation(tmp_path):
    ready = []
    handler = ProfileKwargs(activities=["cpu"], output_trace_dir=str(tmp_path / "traces"),
                            record_shapes=True, on_trace_ready=ready.append)
    acc = Accelerator(cpu=True, kwargs_handlers=[handler])
    x = torch.from_numpy(np.random.RandomState(0).standard_normal((32, 32)).astype(np.float32))
    with acc.profile() as prof:
        with annotate("train_step"):
            y = (x @ x).relu().sum()
    assert ready == [prof] and prof.trace_path == str(tmp_path / "traces" / "trace_0.json")
    events = _trace(prof.trace_path)["traceEvents"]
    names = [e.get("name") for e in events]
    assert "train_step" in names
    step = next(e for e in events if e.get("name") == "train_step")
    inside = [e for e in events if e.get("ts", -1) >= step["ts"]
              and e.get("ts", 0) + e.get("dur", 0) <= step["ts"] + step["dur"]]
    assert any(e.get("name") == "aten::mm" for e in inside)
    assert torch.isfinite(y)
    # the default directory is a fresh temporary one
    with Accelerator(cpu=True).profile(ProfileKwargs(activities=["cpu"])) as prof:
        torch.ones(3).sum()
    assert "trace_0.json" in prof.trace_path and _trace(prof.trace_path)["traceEvents"]
    shutil.rmtree(prof.trace_dir)


def test_profile_schedule_writes_a_trace_each_cycle(tmp_path):
    handler = ProfileKwargs(activities=["cpu"], output_trace_dir=str(tmp_path),
                            schedule_option={"wait": 1, "warmup": 1, "active": 2, "repeat": 2})
    with Accelerator(cpu=True).profile(handler) as prof:
        for i in range(10):
            with annotate(f"step_{i}"):
                torch.ones(8).cumsum(0)
            prof.step()
    written = sorted(p.name for p in tmp_path.glob("trace_0_*.json"))
    assert len(written) == 2 and prof.trace_path is None
    names = {e.get("name") for e in _trace(tmp_path / written[0])["traceEvents"]}
    assert "step_2" in names and "step_0" not in names
    with pytest.raises(ValueError, match="activities"):
        with Accelerator(cpu=True).profile(ProfileKwargs(activities=["tpu"])):
            pass
