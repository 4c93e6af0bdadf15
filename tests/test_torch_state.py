"""The port's ``PartialState`` and the ``Accelerator``'s process API
against the JAX package's, on the CPU.

- ``split_between_processes`` over a grid of (process index, number of
  processes) x lengths 0-11 x {list, dict, numpy array / tensor} x
  ``apply_padding``, the same topology set on both singletons: the same
  shares, exactly. Where the reference raises (padding an empty list
  share) the port raises the same error; where the reference would loop
  forever (padding an empty array share) the port raises it too and the
  reference is not called.
- The ``on_*process`` decorators, ``main_process_first`` /
  ``local_main_process_first`` order and ``print`` at each place in a
  4-process topology give the reference's answers.
- ``Accelerator(cpu=True)``'s process properties equal the reference
  ``Accelerator``'s on one process; ``profile()`` takes the
  ``ProfileKwargs`` handler; ``dataloader_config`` reaches the loader.
- ``PartialState`` is a singleton over one dict; ``AcceleratorState``
  stays per-accelerator (two precisions at once); the heartbeat is read
  through a fresh instance; ``current_topology`` reads
  ``torch.distributed`` and the environment before any state exists.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu_torch import (Accelerator, DataLoaderConfiguration, DistributedType,
                                  PartialState, ProfileKwargs)
from accelerate_tpu_torch.state import LOCAL_PROCESS_ID_ENV, current_topology


@pytest.fixture
def states():
    """Both singletons, fresh, on the CPU."""
    PartialState._reset_state()
    JaxAcceleratorState._reset_state(reset_partial_state=True)
    yield PartialState(cpu=True), JaxPartialState(cpu=True)
    PartialState._reset_state()
    JaxAcceleratorState._reset_state(reset_partial_state=True)


def _place(states, index, count, local=None):
    for s in states:
        s.process_index = index
        s.num_processes = count
        s.local_process_index = index if local is None else local


def _inputs(length, kind, seed):
    rng = np.random.RandomState(seed)
    arr = rng.standard_normal((length, 3)).astype(np.float32)
    if kind == "list":
        items = [int(x) for x in rng.randint(0, 100, length)]
        return items, items
    if kind == "dict":
        d = {"x": [int(v) for v in rng.randint(0, 100, length)], "y": arr}
        return d, {"x": list(d["x"]), "y": torch.from_numpy(arr.copy())}
    if kind == "array":
        return arr, arr.copy()
    return arr, torch.from_numpy(arr.copy())  # "tensor": the port's own kind


def _same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(got, torch.Tensor):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.float32
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
    else:
        assert list(got) == list(want)


def _empty_padded_array(kind, length, index, count, apply_padding):
    """A share the reference pads forever: an empty array share that
    apply_padding must lengthen (its last item does not exist)."""
    per, extras = divmod(length, count)
    start = index * per + min(index, extras)
    end = start + per + (1 if index < extras else 0)
    whole = per + (1 if extras else 0)
    return apply_padding and kind != "list" and end == start and whole > 0


@pytest.mark.parametrize("count", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["list", "dict", "array", "tensor"])
@pytest.mark.parametrize("apply_padding", [False, True])
def test_split_between_processes_matches_the_reference(states, count, kind, apply_padding):
    for index in range(count):
        _place(states, index, count)
        for length in range(12):
            ref_in, port_in = _inputs(length, kind, seed=length)
            what = f"process {index}/{count}, length {length}, {kind}, padding {apply_padding}"
            if _empty_padded_array(kind, length, index, count, apply_padding):
                with pytest.raises(IndexError):
                    with states[0].split_between_processes(port_in, apply_padding=True):
                        pass
                continue
            try:
                with states[1].split_between_processes(ref_in, apply_padding=apply_padding) as w:
                    want = w
            except IndexError:
                with pytest.raises(IndexError):
                    with states[0].split_between_processes(port_in,
                                                           apply_padding=apply_padding):
                        pass
                continue
            with states[0].split_between_processes(port_in, apply_padding=apply_padding) as g:
                got = g
            try:
                _same(got, want)
            except AssertionError as e:
                raise AssertionError(f"{what}: {e}") from e


def test_split_between_processes_rejects_ragged_dicts(states):
    _place(states, 0, 2)
    for s in states:
        with pytest.raises(ValueError, match="same length"):
            with s.split_between_processes({"a": [1, 2, 3], "b": [1, 2]}):
                pass


@pytest.mark.parametrize("index", [0, 1, 2, 3])
def test_decorators_order_and_print_match_the_reference(states, index):
    local = index % 2  # two processes a node
    _place(states, index, 4, local=local)
    runs = []
    for s, side in zip(states, ("port", "ref")):
        got = []
        got.append(s.on_main_process(lambda: "main")())
        got.append(s.on_local_main_process(lambda: "local main")())
        got.append(s.on_last_process(lambda: "last")())
        got.append(s.on_process(process_index=2)(lambda: "two")())
        got.append(s.on_process(lambda: "one", process_index=1)())
        got.append(s.on_local_process(local_process_index=1)(lambda: "local one")())
        got.append((s.is_main_process, s.is_local_main_process, s.is_last_process))
        # with the barrier stubbed: where each process waits around the body
        order = []
        s.wait_for_everyone = lambda order=order: order.append("wait")
        with s.main_process_first():
            order.append("body")
        with s.local_main_process_first():
            order.append("local body")
        del s.wait_for_everyone
        got.append(order)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            s.print("hello", index)
        got.append(out.getvalue())
        runs.append(got)
    assert runs[0] == runs[1]


def test_wait_for_everyone_on_one_process_is_a_no_op(states):
    assert states[0].wait_for_everyone() is None


def test_accelerator_process_api_matches_the_reference():
    PartialState._reset_state()
    JaxAcceleratorState._reset_state(reset_partial_state=True)
    try:
        ref = JaxAccelerator()
        acc = Accelerator(cpu=True)
        for name in ("num_processes", "process_index", "local_process_index",
                     "is_main_process", "is_local_main_process", "is_last_process"):
            assert getattr(acc, name) == getattr(ref, name), name
        # one process on the CPU: NO (the reference reads NO on one device
        # and CPU_SIM on the test harness's simulated 8, one process driving
        # several devices, which a process-per-card port never is)
        assert acc.distributed_type == DistributedType.NO
        assert str(ref.distributed_type) in ("NO", "CPU_SIM")
        assert acc.device == torch.device("cpu")
        assert Accelerator(device="cpu").device == acc.device
        for obj in (acc, ref):
            fired = []
            obj.on_main_process(lambda: fired.append("main"))()
            obj.on_local_main_process(lambda: fired.append("local"))()
            obj.on_last_process(lambda: fired.append("last"))()
            obj.on_process(lambda: fired.append("zero"), process_index=0)()
            obj.wait_for_everyone()
            with obj.main_process_first():
                fired.append("first")
            with obj.local_main_process_first():
                fired.append("local first")
            with obj.split_between_processes([1, 2, 3]) as share:
                fired.append(share)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                obj.print("x")
            fired.append(out.getvalue())
            obj.fired = fired
        assert acc.fired == ref.fired
        with pytest.raises(ValueError, match="disagree"):
            Accelerator(cpu=True, device="cuda")
    finally:
        PartialState._reset_state()
        JaxAcceleratorState._reset_state(reset_partial_state=True)


def test_accelerator_takes_profile_kwargs_and_dataloader_config(tmp_path):
    handler = ProfileKwargs(activities=["cpu"], output_trace_dir=str(tmp_path))
    acc = Accelerator(cpu=True, kwargs_handlers=[handler],
                      dataloader_config=DataLoaderConfiguration(prefetch_depth=3))
    assert acc.profile_handler is handler
    ctx = acc.profile()
    assert ctx.kwargs is handler and ctx.suffix == str(acc.process_index)
    loader = acc.prepare([{"x": np.arange(4)}] * 2)
    assert loader.prefetch_depth == 3
    assert Accelerator(cpu=True, split_batches=True).dataloader_config.split_batches
    with pytest.raises(TypeError, match="ProfileKwargs"):
        Accelerator(cpu=True, kwargs_handlers=[object()])


def test_partial_state_is_one_dict_and_accelerator_state_is_not():
    PartialState._reset_state()
    try:
        a = PartialState(cpu=True)
        b = PartialState()  # the singleton, whatever the arguments
        assert a.__dict__ is b.__dict__ and b.device == torch.device("cpu")
        a.publish_heartbeat(7)
        step, stamp = PartialState().heartbeat
        assert step == 7 and stamp > 0
        bf16 = Accelerator(mixed_precision="bf16", cpu=True)
        fp16 = Accelerator(mixed_precision="fp16", cpu=True)
        assert (bf16.mixed_precision, fp16.mixed_precision) == ("bf16", "fp16")
        assert bf16.state is not fp16.state
        assert bf16.state._partial.__dict__ is fp16.state._partial.__dict__
        assert "Num processes: 1" in repr(a)
    finally:
        PartialState._reset_state()


def test_partial_state_raises_without_cuda_unless_cpu(monkeypatch):
    PartialState._reset_state()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PartialState()
        assert not PartialState._shared_state  # a failed state leaves nothing
        assert PartialState(cpu=True).device == torch.device("cpu")
    finally:
        PartialState._reset_state()


def test_current_topology_needs_no_state(monkeypatch):
    PartialState._reset_state()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv(LOCAL_PROCESS_ID_ENV, "3")
    assert current_topology() == (0, 3, 1)
    assert not PartialState._shared_state  # nothing was created
    monkeypatch.delenv(LOCAL_PROCESS_ID_ENV)
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert current_topology() == (0, 2, 1)
    try:
        state = PartialState(cpu=True)
        assert state.local_process_index == 2
        state.process_index, state.num_processes = 1, 2
        assert current_topology() == (1, 2, 2)
    finally:
        PartialState._reset_state()
