"""The port's one-process tree operations (``utils/operations.py``)
against the JAX package's, on the CPU, exactly.

Each helper runs on the same trees from a numpy seed (dicts with
unsorted keys, lists, tuples, a namedtuple, non-array leaves, None): the
reference on numpy arrays, the port on torch tensors and on the numpy
arrays themselves. Results are compared value for value and dtype for
dtype; the reference's jax arrays are read back through numpy, their
dtype JAX's canonical one (without x64 an int64 array is int32 there).
"""

from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.utils import operations as ref
from accelerate_tpu_torch.utils import operations as ops

Pair = namedtuple("Pair", ["first", "second"])


def _tree(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    b = 2 + seed % 4

    def arr(*shape):
        return rng.standard_normal(shape).astype(dtype)

    return {"z": arr(b + 1, 3), "a": [arr(b, 2), (arr(b), 7)], "m": Pair(arr(b, 1, 2), "tag"),
            "n": None, "ids": rng.randint(0, 50, (b, 4)).astype(np.int64)}


def _torch(tree):
    return ops.recursively_apply(lambda x: torch.from_numpy(x.copy()), tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _equal(got, want, what=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), what
        for k in want:
            _equal(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), (what, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{what}[{i}]")
    elif isinstance(want, (np.ndarray, jax.Array)):
        g, w = _np(got), np.asarray(want)
        # a jax array's dtype is JAX's canonical one (int64 -> int32 without x64)
        dtype = jax.dtypes.canonicalize_dtype(g.dtype) if isinstance(want, jax.Array) else g.dtype
        assert g.shape == w.shape and dtype == w.dtype, (what, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        assert got == want, (what, got, want)


SEEDS = range(6)


@pytest.mark.parametrize("seed", SEEDS)
def test_tree_queries_match_the_reference(seed):
    tree = _tree(seed)
    for port_tree in (tree, _torch(tree)):
        assert ops.find_batch_size(port_tree) == ref.find_batch_size(tree)
        _equal(ops.get_shape(port_tree), ref.get_shape(tree))
        _equal(ops.listify(port_tree), ref.listify(tree))
    assert ops.find_batch_size({"s": "x", "n": None}) is ref.find_batch_size({"s": "x", "n": None})
    assert ops.is_array_like(torch.zeros(1)) and ops.is_array_like(np.zeros(1))
    assert not ops.is_array_like([1.0]) and not ref.is_array_like([1.0])


@pytest.mark.parametrize("seed", SEEDS)
def test_structure_round_trip_matches_the_reference(seed):
    tree = _tree(seed)
    want = ref.initialize_tensors(ref.get_data_structure(tree))
    for port_tree in (tree, _torch(tree)):
        info = ops.get_data_structure(port_tree)
        leaves = [x for x in ops._leaves(info) if ops.is_tensor_information(x)]
        ref_leaves = [x for x in jax.tree_util.tree_leaves(ref.get_data_structure(tree))
                      if ref.is_tensor_information(x)]
        assert [tuple(x.shape) for x in leaves] == [tuple(x.shape) for x in ref_leaves]
        _equal(ops.initialize_tensors(info), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num_processes", [1, 2, 3, 4])
def test_padding_slicing_and_concat_match_the_reference(seed, num_processes):
    tree = _tree(seed)
    bs = ref.find_batch_size(tree)
    for port_tree in (tree, _torch(tree)):
        _equal(ops.pad_input_tensors(port_tree, bs, num_processes),
               ref.pad_input_tensors(tree, bs, num_processes))
        for cut in (slice(0, 1), slice(1, None), slice(None, None, 2), 0):
            _equal(ops.slice_tensors(port_tree, cut), ref.slice_tensors(tree, cut))
        _equal(ops.drop_padding(port_tree, num_processes), ref.drop_padding(tree, num_processes))
    base = {"x": (tree["a"][0], tree["z"]), "y": tree["ids"]}
    parts = [ops.recursively_apply(lambda x, i=i: x * (i + 1), base)
             for i in range(num_processes)]
    for dim in (0, 1):
        want = ref.concatenate(parts, dim=dim)
        _equal(ops.concatenate(parts, dim=dim), want)
        _equal(ops.concatenate([_torch(p) for p in parts], dim=dim), want)
    for impl in (ops, ref):
        with pytest.raises(TypeError, match="Can only concatenate"):
            impl.concatenate(["a", "b"])


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.int32])
def test_fp32_conversion_matches_the_reference(dtype):
    tree = _tree(3, dtype=dtype)
    want = ref.convert_to_fp32(tree)
    _equal(ops.convert_to_fp32(tree), want)
    _equal(ops.convert_to_fp32(_torch(tree)), want)
    # bf16: torch's own, against the reference's jax bf16
    bf = jnp.asarray(tree["z"], dtype=jnp.bfloat16)
    got = ops.convert_to_fp32({"w": torch.from_numpy(tree["z"]).to(torch.bfloat16)})
    _equal(got, ref.convert_to_fp32({"w": bf}))

    @ops.convert_outputs_to_fp32
    def half(x):
        return {"y": x.half(), "n": 3}

    out = half(torch.ones(2))
    assert out["y"].dtype == torch.float32 and out["n"] == 3


def test_send_to_device_matches_the_reference():
    tree = {**_tree(1), "nums": [1, 2, 3], "floats": [0.5, 1.5], "flags": [True, False],
            "words": ["a", "b"], "skip": np.ones(2)}
    want = ref.send_to_device(tree, jax.devices("cpu")[0])
    got = ops.send_to_device(tree, "cpu")
    _equal({k: v for k, v in got.items()}, want)
    assert isinstance(got["nums"], torch.Tensor) and got["words"] == ["a", "b"]
    got = ops.send_to_device(_torch(_tree(1)), torch.device("cpu"), non_blocking=True)
    _equal(got, ref.send_to_device(_tree(1), jax.devices("cpu")[0]))
    kept = ops.send_to_device(tree, "cpu", skip_keys=["skip", "z"])
    want = ref.send_to_device(tree, jax.devices("cpu")[0], skip_keys=["skip", "z"])
    assert kept["skip"] is tree["skip"] and kept["z"] is tree["z"]
    assert isinstance(want["skip"], np.ndarray)
    assert ops.send_to_device(tree, "cpu", skip_keys="skip")["skip"] is tree["skip"]


def test_find_device_and_one_process_collectives_match_the_reference():
    tree = _tree(2)
    assert ops.find_device(tree) is None and ref.find_device(tree) is None
    t = _torch(tree)
    assert ops.find_device(t) == torch.device("cpu")
    assert ops.find_device({"b": np.zeros(1), "a": [None, torch.zeros(1)]}).type == "cpu"
    objs = [1, {"x": 2}, "three"]
    assert ops.broadcast(t) is t and ref.broadcast(tree) is tree
    assert ops.broadcast_object_list(objs) is objs
    assert ref.broadcast_object_list(objs) is objs


def test_honor_type_matches_the_reference():
    for obj in (Pair(1, 2), (1, 2), [1, 2]):
        assert ops.honor_type(obj, iter([3, 4])) == ref.honor_type(obj, iter([3, 4]))
        assert type(ops.honor_type(obj, iter([3, 4]))) is type(obj)
