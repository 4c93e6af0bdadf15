"""The multi-process operations, RNG sync and loader sharding, on the CPU.

- The six collectives (``gather``, ``gather_object``, ``reduce``,
  ``pad_across_processes``, ``broadcast``, ``broadcast_object_list``) on
  worlds of 2 and 3 gloo ranks (uneven shapes through
  ``pad_across_processes``), against the reference's documented results
  (``accelerate_tpu/utils/operations.py``: every process's rows
  concatenated in process order, the sum or mean times ``scale``, ...);
  its multi-process run needs ``jax.distributed`` across processes, which
  this host's test run does not start. On one process each is checked
  against the reference's own function. ``psum``, ``pmean`` and
  ``all_gather_axis`` over the mesh's data axis.
- ``BatchSamplerShard`` and ``IterableDatasetShard`` against the
  reference's classes built with each ``process_index`` (no processes
  needed), for every flag.
- The sharded and the dispatched loader on 2 and 3 ranks with an uneven
  last global batch: each rank's batches, and ``gather_for_metrics`` over
  the epoch giving every sample exactly once (the even-batches repeats
  dropped).
- ``synchronize_rng_states``: every rank draws the main process's numbers.
"""

import pickle

import numpy as np
import pytest
import torch

from accelerate_tpu import data as ref_data
from accelerate_tpu.utils import operations as ref_ops
from accelerate_tpu_torch import data as port_data
from accelerate_tpu_torch.launchers import debug_launcher
from accelerate_tpu_torch.utils import operations as ops
from torch_dist_workers import gathered, ops_worker

ROWS, BATCH_SIZE = 10, 2
WORLD_TIMEOUT = 180


@pytest.fixture(scope="module", params=[2, 3], ids=["world2", "world3"])
def world(request, tmp_path_factory):
    n = request.param
    d = tmp_path_factory.mktemp(f"ops{n}")
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump({"rows": ROWS, "batch_size": BATCH_SIZE}, f)
    debug_launcher(ops_worker, (str(d),), num_processes=n, timeout=WORLD_TIMEOUT)
    return n, gathered(str(d), "ops", n)


def _local(r):
    return np.arange(3 * (r + 1), dtype=np.float32).reshape(r + 1, 3) + 10 * r


def test_collectives(world):
    n, ranks = world
    longest = n
    padded = []
    for r in range(n):
        rows = _local(r)
        pad = np.full((longest - rows.shape[0], 3), -1, np.float32)
        padded.append(np.concatenate([rows, pad]))
        np.testing.assert_array_equal(ranks[r]["pad"], padded[-1])
        np.testing.assert_array_equal(ranks[r]["pad_first"], np.concatenate([pad, rows]))
    for r in range(n):
        res = ranks[r]
        np.testing.assert_array_equal(res["gather"], np.concatenate(padded))
        np.testing.assert_array_equal(res["gather_np"], np.repeat(np.arange(n), 2))
        assert res["gather_object"] == [{"rank": i} for i in range(n)]
        assert res["gather_object_list"] == [x for i in range(n) for x in (i, i * 10)]
        total = sum(1.0 + i for i in range(n))
        np.testing.assert_allclose(res["reduce_sum"], [total, 2.0 * n])
        np.testing.assert_allclose(res["reduce_mean"], [2 * total / n, 4.0])
        assert torch.equal(res["broadcast"], torch.full((2,), float(n - 1)))
        assert res["broadcast_object_list"] == ["from 1", 1]
        assert res["psum"] == n * (n + 1) / 2 and res["pmean"] == (n + 1) / 2
        assert res["all_gather_axis"] == [float(i + 1) for i in range(n)]
        assert tuple(res["global_batch"]) == (2, 3)


def test_collectives_on_one_process_are_the_reference():
    import jax.numpy as jnp

    t = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(ops.gather(torch.from_numpy(t)).numpy(),
                                  np.asarray(ref_ops.gather(jnp.asarray(t))))
    assert ops.gather_object({"a": 1}) == ref_ops.gather_object({"a": 1})
    assert ops.gather_object([1, 2]) == ref_ops.gather_object([1, 2])
    np.testing.assert_allclose(ops.reduce(torch.from_numpy(t), "mean", 3.0).numpy(),
                               np.asarray(ref_ops.reduce(jnp.asarray(t), "mean", 3.0)))
    np.testing.assert_array_equal(ops.pad_across_processes(torch.from_numpy(t), dim=1).numpy(),
                                  np.asarray(ref_ops.pad_across_processes(jnp.asarray(t), 1)))
    assert ops.broadcast_object_list([1, "x"]) == ref_ops.broadcast_object_list([1, "x"])


def test_rng_states_are_the_main_process(world):
    n, ranks = world
    assert len({res["rng"] for res in ranks}) == 1


@pytest.mark.parametrize("mode", ["shard", "dispatch"])
def test_loaders_and_gather_for_metrics(world, mode):
    """Each rank's batches are its share of every global batch of
    BATCH_SIZE x n; the last one (ROWS % (BATCH_SIZE x n) real rows) is
    squared up from the first samples; gather_for_metrics drops the
    repeats, so the epoch's gathered metrics are every row once."""
    n, ranks = world
    gbs = BATCH_SIZE * n
    assert all(res[mode]["remainder"] == ROWS % gbs for res in ranks)
    metrics = [x for batch in ranks[0][mode]["metrics"] for x in batch]
    assert metrics == list(range(ROWS))
    assert all(res[mode]["metrics"] == ranks[0][mode]["metrics"] for res in ranks)
    seen = [[x for b in res[mode]["seen"] for x in b] for res in ranks]
    steps = -(-ROWS // gbs)
    assert all(len(s) == steps * BATCH_SIZE for s in seen)
    if mode == "dispatch":  # rank r holds slice r of each global batch
        for i in range(steps - 1):
            for r in range(n):
                lo = i * gbs + r * BATCH_SIZE
                assert ranks[r][mode]["seen"][i] == list(range(lo, lo + BATCH_SIZE))
    else:  # whole batches round robin, as the reference's BatchSamplerShard
        for r in range(n):
            want = list(ref_data.BatchSamplerShard(
                ref_data.SimpleBatchSampler(range(ROWS), BATCH_SIZE), n, r))
            assert ranks[r][mode]["seen"] == want


def _samplers(rows, batch_size, drop_last):
    return (ref_data.SimpleBatchSampler(range(rows), batch_size, drop_last),
            port_data.SimpleBatchSampler(range(rows), batch_size, drop_last))


@pytest.mark.parametrize("rows", [0, 7, 16, 21, 24])
@pytest.mark.parametrize("split_batches", [False, True])
@pytest.mark.parametrize("even_batches", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_sampler_shard_matches_reference(rows, split_batches, even_batches, drop_last):
    for n in (1, 2, 3, 4):
        if split_batches and 4 % n:
            continue
        for r in range(n):
            ref_bs, port_bs = _samplers(rows, 4, drop_last)
            ref = ref_data.BatchSamplerShard(ref_bs, n, r, split_batches, even_batches)
            port = port_data.BatchSamplerShard(port_bs, n, r, split_batches, even_batches)
            assert list(port) == list(ref), (n, r)
            assert len(port) == len(ref), (n, r)


@pytest.mark.parametrize("rows", [0, 5, 16, 23])
@pytest.mark.parametrize("split_batches", [False, True])
@pytest.mark.parametrize("even_batches", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_iterable_dataset_shard_matches_reference(rows, split_batches, even_batches, drop_last):
    for n in (1, 2, 3, 4):
        if split_batches and 4 % n:
            continue
        for r in range(n):
            kw = dict(batch_size=4, drop_last=drop_last, num_processes=n, process_index=r,
                      split_batches=split_batches, even_batches=even_batches)
            assert list(port_data.IterableDatasetShard(range(rows), **kw)) == \
                list(ref_data.IterableDatasetShard(range(rows), **kw)), (n, r)


def test_split_batches_needs_a_divisible_batch():
    with pytest.raises(ValueError, match="round multiple"):
        port_data.BatchSamplerShard(port_data.SimpleBatchSampler(range(8), 3), 2, 0,
                                    split_batches=True)


def test_one_process_gathers_every_batch_whole():
    """One process pads no batch: gather_for_metrics keeps every row of the
    last batch, a short one or (drop_last) a full one."""
    from accelerate_tpu_torch import Accelerator, DataLoader

    acc = Accelerator(cpu=True)
    data = [{"x": np.array([i], np.int64)} for i in range(ROWS)]
    for drop_last in (False, True):
        loader = acc.prepare(DataLoader(data, batch_size=3, drop_last=drop_last))
        rows = [x for b in loader for x in acc.gather_for_metrics(b["x"][:, 0]).tolist()]
        assert rows == list(range(9 if drop_last else ROWS)), drop_last
