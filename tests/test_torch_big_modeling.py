"""The port's big-model dispatch (``accelerate_tpu_torch/big_modeling.py``,
``utils/modeling.py``, ``utils/serialization.py``, ``utils/offload.py``,
``generate_dispatched``) against the JAX package's, at
``DecoderConfig.tiny()`` (fp32, 2 layers, E 64) on the CPU.

- Checkpoints (safetensors single, sharded and streamed; fp32, bf16,
  int8; pickle) and offload folders written by either package are read
  by the other bit for bit; the port's safetensors files are also read by
  the ``safetensors`` library (in this test only: the port never imports
  it).
- Device maps, module sizes and abstract trees: equal to the reference's
  in all four modes, on the tiny tree and on random trees.
- Dispatched logits are within 1e-5 of the reference's fp32
  ``DispatchedModel`` (two layers of fp32 summed in another order by XLA
  and PyTorch: ~1e-7 here), for all-device, cpu, disk and mixed maps and
  for int8 / int4 / NF4 + double quantization; greedy
  ``generate_dispatched`` tokens are equal.
- On the CPU there is nothing to pin: ``_to_pinned_host`` pins only for a
  CUDA model, and here returns a plain copy in memory. The host-tier
  streaming (a device buffer per weight kind, refilled before each block)
  runs all the same, CPU to CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from accelerate_tpu import big_modeling as RB
from accelerate_tpu import generation as rgen
from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.utils import modeling as RM
from accelerate_tpu.utils import offload as ROff
from accelerate_tpu.utils import quantization as rquant
from accelerate_tpu.utils import serialization as RS
from accelerate_tpu.utils.quantization import QuantizationConfig as RQC
from accelerate_tpu_torch import big_modeling as PB
from accelerate_tpu_torch.generation import generate, generate_dispatched
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import export_reference_checkpoint, from_reference
from accelerate_tpu_torch.models.decoder import DecoderLM, StreamedWeight
from accelerate_tpu_torch.utils import modeling as PM
from accelerate_tpu_torch.utils import offload as POff
from accelerate_tpu_torch.utils import quantization as pquant
from accelerate_tpu_torch.utils import serialization as PS
from accelerate_tpu_torch.utils.quantization import QuantizationConfig, QuantizedLayer

ATOL = 1e-5
MAPS = {
    "all-device": "auto",
    "cpu": {"": "cpu"},
    "disk": {"": "disk"},
    "mixed": {"": "device", "layers": "cpu", "embedding": "disk"},
    "split-leaves": {"": "device", "layers/block/mlp": "cpu", "layers/block/attn/wq": "disk",
                     "lm_head": "disk"},
}
QUANT = {
    "int8": {"load_in_8bit": True, "group_size": 32},
    "int4": {"load_in_4bit": True, "group_size": 32},
    "nf4-dq": {"load_in_4bit": True, "group_size": 32, "quant_type": "nf4",
               "double_quant": True},
}
_STATE: dict = {}


def _reference(scan=True, tie=True):
    """(JAX model, its fp32 params as numpy, the port's config), once per
    layout."""
    key = (scan, tie)
    if key not in _STATE:
        jm = JaxLM(JaxConfig.tiny(scan_layers=scan, tie_embeddings=tie))
        params, _ = unbox_params(
            jm.init_variables(jax.random.PRNGKey(0), batch_size=1, seq_len=16)["params"])
        _STATE[key] = (jm, jax.tree_util.tree_map(np.asarray, params),
                       DecoderConfig.tiny(scan_layers=scan, tie_embeddings=tie))
    return _STATE[key]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The reference's params saved by the reference's ``save_pytree``."""
    jm, params, cfg = _reference()
    path = str(tmp_path_factory.mktemp("ckpt") / "model.safetensors")
    RS.save_pytree(params, path)
    return path


def _ids(s=16, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (1, s))


def _ref_logits(ids):
    jm, params, _ = _reference()
    return np.asarray(jm.apply({"params": params}, jnp.asarray(ids))["logits"])


# ---------------------------------------------------------------------------
# serialization and offload folders
# ---------------------------------------------------------------------------


def _mixed_tree():
    rng = np.random.RandomState(1)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    return {"a": {"w": w, "b": rng.standard_normal((7,)).astype(np.float32)},
            "bf": rng.standard_normal((3, 9)).astype(np.float32),  # stored bf16
            "q": rng.randint(-128, 128, (4, 3)).astype(np.int8),
            "s": np.float32(2.5).reshape(()),
            "big": rng.standard_normal((40, 30)).astype(np.float32)}


def _as_port(tree):
    out = {}
    for k, v in PS.flatten_pytree(tree).items():
        t = torch.from_numpy(np.array(v))
        out[k] = t.bfloat16() if k == "bf" else t
    return out


def _as_ref(flat_port):
    return {k: (v.float().numpy().astype(ml_dtypes.bfloat16) if v.dtype == torch.bfloat16
                else v.numpy()) for k, v in flat_port.items()}


def _same(port: dict, ref: dict):
    assert sorted(port) == sorted(ref)
    for k in ref:
        r = np.asarray(ref[k])
        p = port[k]
        if r.dtype == ml_dtypes.bfloat16:
            assert p.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(p.view(torch.int16).numpy(), r.view(np.int16), err_msg=k)
        else:
            assert str(p.dtype).removeprefix("torch.") == r.dtype.name, k
            np.testing.assert_array_equal(p.numpy(), r, err_msg=k)


@pytest.mark.parametrize("shard", [None, 500], ids=["single", "sharded"])
def test_port_safetensors_read_by_reference_and_library(tmp_path, shard):
    from safetensors.numpy import load_file

    flat = _as_port(_mixed_tree())
    path = str(tmp_path / "m.safetensors")
    files = PS.save_pytree(PS.unflatten_to_like(flat, _mixed_tree()), path, max_shard_size=shard)
    assert (len(files) > 1) == (shard is not None)
    _same(flat, RS.load_flat_dict(path))
    _same(PS.load_flat_dict(path), _as_ref(flat))
    lib = {}
    for f in files:
        lib.update(load_file(f))
    _same(flat, lib)
    if shard:
        with open(path + ".index.json") as f:
            index = json.load(f)
        assert set(index["weight_map"]) == set(flat)


@pytest.mark.parametrize("shard", [None, 500], ids=["single", "sharded"])
def test_reference_safetensors_read_by_port(tmp_path, shard):
    ref_flat = _as_ref(_as_port(_mixed_tree()))
    path = str(tmp_path / "r.safetensors")
    RS.save_pytree(RS.unflatten_to_like(ref_flat, _mixed_tree()), path, max_shard_size=shard)
    got = PS.load_flat_dict(path)
    _same(got, ref_flat)
    structs = PS.peek_flat_structs(path)
    ref_structs = RS.peek_flat_structs(path)
    assert {k: tuple(v.shape) for k, v in structs.items()} == \
        {k: tuple(v.shape) for k, v in ref_structs.items()}
    assert all(v.device.type == "meta" for v in structs.values())


def test_streamed_write_layer_by_layer(tmp_path):
    """A stacked leaf written slice by slice reads back whole, on both
    sides; a fetch that yields the wrong byte count raises."""
    from safetensors.numpy import load_file

    rows = [torch.randn(4, 6).bfloat16() for _ in range(5)]
    entries = [("stack", (5, 4, 6), torch.bfloat16, lambda: iter(rows)),
               ("one", (3,), torch.int8, lambda: torch.arange(3, dtype=torch.int8))]
    path = str(tmp_path / "s.safetensors")
    PS.write_safetensors_streaming(path, entries)
    want = torch.stack(rows)
    assert torch.equal(PS.load_flat_dict(path)["stack"], want)
    np.testing.assert_array_equal(RS.load_flat_dict(path)["stack"].view(np.int16),
                                  want.view(torch.int16).numpy())
    np.testing.assert_array_equal(load_file(path)["one"], np.arange(3, dtype=np.int8))
    bad = [("stack", (5, 4, 6), torch.bfloat16, lambda: iter(rows[:4]))]
    with pytest.raises(ValueError, match="produced"):
        PS.write_safetensors_streaming(str(tmp_path / "bad.safetensors"), bad)
    # the reference's streaming writer, read by the port
    ref_stack = want.float().numpy().astype(ml_dtypes.bfloat16)
    ref_entries = [("stack", (5, 4, 6), ml_dtypes.bfloat16, lambda: ref_stack),
                   ("w", (2, 3), np.float32, lambda: np.arange(6, dtype=np.float32).reshape(2, 3)),
                   ("q", (4,), np.int8, lambda: np.arange(4, dtype=np.int8))]
    rpath = str(tmp_path / "r.safetensors")
    RS.write_safetensors_streaming(rpath, ref_entries)
    _same(PS.load_flat_dict(rpath), RS.load_flat_dict(rpath))


def test_pickle_checkpoints_cross_load(tmp_path):
    tree = {"a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "q": np.arange(4, dtype=np.int8)}
    RS.save_pytree(tree, str(tmp_path / "r.bin"), safe_serialization=False)
    got = PS.load_flat_dict(str(tmp_path / "r.bin"))
    _same(got, RS.flatten_pytree(tree))
    PS.save_pytree(_torch(tree), str(tmp_path / "p.bin"), safe_serialization=False)
    _same(PS.load_flat_dict(str(tmp_path / "p.bin")), RS.load_flat_dict(str(tmp_path / "p.bin")))
    with pytest.raises(ValueError, match="bfloat16"):
        PS.save_pytree({"w": torch.ones(2).bfloat16()}, str(tmp_path / "b.bin"),
                       safe_serialization=False)


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _write_header(path, header, payload: bytes):
    blob = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        f.write(payload)


@pytest.mark.parametrize("header,payload,match", [
    ({"w": {"dtype": "F32", "shape": [4], "data_offsets": [0, 8]}}, b"\0" * 16, "spans"),
    ({"w": {"dtype": "F32", "shape": [8], "data_offsets": [0, 32]}}, b"\0" * 4, "outside"),
    ({"w": {"dtype": "F8_E4M3", "shape": [4], "data_offsets": [0, 4]}}, b"\0" * 4, "F8_E4M3"),
], ids=["span", "past-eof", "unknown-dtype"])
def test_corrupt_headers_raise(tmp_path, header, payload, match):
    path = str(tmp_path / "bad.safetensors")
    _write_header(path, header, payload)
    with pytest.raises(ValueError, match=match):
        PS.load_flat_dict(path)


def test_unaligned_tensor_is_read(tmp_path):
    """Another writer's layout with a tensor off its element alignment is
    read (into memory) rather than refused."""
    a = np.arange(3, dtype=np.int8)
    b = np.arange(4, dtype=np.float32)
    header = {"a": {"dtype": "I8", "shape": [3], "data_offsets": [0, 3]},
              "b": {"dtype": "F32", "shape": [4], "data_offsets": [3, 19]}}
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    path = tmp_path / "u.safetensors"
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob + a.tobytes() + b.tobytes())
    got = PS.load_flat_dict(str(path))
    np.testing.assert_array_equal(got["b"].numpy(), b)


def test_distributed_checkpoints_are_a_later_slice(tmp_path):
    """Per-rank checkpoints were a later slice; they are read now (since
    the multi-device slice): the reference's manifests, written here for
    two ranks by the reference's own writer, load whole, and one rank's
    missing manifest raises."""
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.ones(4, np.int32)}
    base = str(tmp_path / "m")
    for rank in range(2):
        RS.save_pytree_dist(tree, base, process_index=rank, num_processes=2)
    got = PS.load_flat_dict(base)
    assert set(got) == set(tree)
    for key, want in tree.items():
        np.testing.assert_array_equal(got[key].numpy(), want)
    (tmp_path / "m.rank1.manifest.json").unlink()
    with pytest.raises(ValueError, match="incomplete"):
        PS.load_flat_dict(base)


def test_flatten_matches_reference_order():
    tree = {"b": {"y": np.zeros(1), "x": [np.zeros(2), np.zeros(3)]}, "a": np.zeros(4),
            "layer_10": np.zeros(1), "layer_2": np.zeros(1)}
    assert list(PS.flatten_pytree(tree)) == list(RS.flatten_pytree(tree))
    order = list(PS.flatten_pytree(tree))
    back = PS.unflatten_to_like({k: i for i, k in enumerate(order)}, tree)
    assert back["b"]["x"] == [order.index("b/x/0"), order.index("b/x/1")]
    assert back["a"] == order.index("a") and list(back) == list(tree)
    with pytest.raises(KeyError, match="missing key"):
        PS.unflatten_to_like({}, tree)


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16", "int8"])
def test_offload_folders_cross_load(tmp_path, dtype):
    w32 = np.arange(12, dtype=np.float64).reshape(3, 4)
    ref_w = w32.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype))
    port_w = torch.from_numpy(w32).to(getattr(torch, dtype))
    r_dir, p_dir = str(tmp_path / "r"), str(tmp_path / "p")
    ROff.offload_state_dict(r_dir, {"w": ref_w, "s": np.float32(3.5)})
    POff.offload_state_dict(p_dir, {"w": port_w, "s": torch.tensor(3.5)})
    assert ROff.load_offload_index(r_dir) == POff.load_offload_index(p_dir)
    got = POff.OffloadedWeightsLoader(save_folder=r_dir)
    assert got["w"].dtype == port_w.dtype and torch.equal(got["w"], port_w)
    assert got["s"].shape == () and got["s"].item() == 3.5
    back = ROff.OffloadedWeightsLoader(save_folder=p_dir)
    np.testing.assert_array_equal(np.asarray(back["w"], np.float64), w32)
    assert float(back["s"]) == 3.5
    merged = POff.OffloadedWeightsLoader(state_dict={"m": torch.zeros(2)}, save_folder=p_dir)
    assert set(merged) == {"m", "w", "s"} and len(merged) == 3
    with open(os.path.join(r_dir, "w.dat"), "rb") as f, \
            open(os.path.join(p_dir, "w.dat"), "rb") as g:
        assert f.read() == g.read()


# ---------------------------------------------------------------------------
# device maps
# ---------------------------------------------------------------------------


def _abstracts(scan=True, tie=True):
    jm, _, cfg = _reference(scan, tie)
    rab = RB.init_empty_weights(jm, jnp.zeros((1, 8), jnp.int32))["params"]
    return rab, PB.init_empty_weights(cfg)


@pytest.mark.parametrize("scan,tie", [(True, True), (False, True), (True, False)],
                         ids=["stacked", "unrolled", "untied"])
def test_init_empty_weights_matches_reference(scan, tie):
    rab, pab = _abstracts(scan, tie)
    r = {k: (tuple(v.shape), np.dtype(v.dtype).name) for k, v in RS.flatten_pytree(rab).items()}
    p = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
         for k, v in PS.flatten_pytree(pab).items()}
    assert list(r.items()) == list(p.items())
    assert all(v.device.type == "meta" for v in PS.flatten_pytree(pab).values())
    assert RM.compute_module_sizes(rab) == PM.compute_module_sizes(pab)
    assert RM.compute_module_sizes(rab, dtype=jnp.bfloat16) == \
        PM.compute_module_sizes(pab, dtype=torch.bfloat16)


@pytest.mark.parametrize("mode", ["auto", "balanced", "balanced_low_0", "sequential"])
@pytest.mark.parametrize("frac", [(2, 3), (1, 5), (10, 10), (30, 1)],
                         ids=["half", "fifth", "all", "sliver"])
def test_device_map_matches_reference_on_tiny_tree(mode, frac):
    rab, pab = _abstracts()
    total = RM.compute_module_sizes(rab)[""]
    budget = {"device": total * frac[0] // 10, "cpu": total * frac[1] // 10, "disk": 1 << 62}
    try:
        want = RM.infer_auto_device_map(rab, max_memory=budget, mode=mode)
    except ValueError:
        with pytest.raises(ValueError, match="does not fit"):
            PM.infer_auto_device_map(pab, max_memory=budget, mode=mode, device="cpu")
        return
    assert PM.infer_auto_device_map(pab, max_memory=budget, mode=mode, device="cpu") == want
    # the quantized budget tree (packed sizes)
    qr = RM.infer_auto_device_map(rquant.quantize_abstract_tree(rab, RQC(load_in_8bit=True)),
                                  max_memory=budget, mode=mode)
    qp = PM.infer_auto_device_map(
        pquant.quantize_abstract_tree(pab, QuantizationConfig(load_in_8bit=True)),
        max_memory=budget, mode=mode, device="cpu")
    assert qp == qr


def test_device_map_matches_reference_on_random_trees():
    """The reference's property test's random trees and budgets: the same
    map (or the same refusal), and the map's invariants."""
    rng = np.random.RandomState(7)
    for trial in range(40):
        tree = {}
        for m in range(rng.randint(2, 6)):
            tree[f"m{m:02d}"] = {f"w{p}": np.zeros((int(rng.randint(1, 200)),), np.float32)
                                 for p in range(rng.randint(1, 5))}
        if trial % 3 == 0:  # a tied pair
            tree["tied"] = {"w": tree["m00"]["w0"]}
        total = RM.compute_module_sizes(tree)[""]
        budget = {"device": int(rng.randint(1, max(total, 2))),
                  "cpu": int(rng.randint(1, max(total, 2))), "disk": 1 << 62}
        ptree = jax.tree_util.tree_map(torch.from_numpy, tree)
        if trial % 3 == 0:
            ptree["tied"]["w"] = ptree["m00"]["w0"]
        mode = ("sequential", "auto", "balanced_low_0")[trial % 3]
        try:
            want = RM.infer_auto_device_map(tree, max_memory=budget, mode=mode)
        except ValueError:
            with pytest.raises(ValueError):
                PM.infer_auto_device_map(ptree, max_memory=budget, mode=mode, device="cpu")
            continue
        got = PM.infer_auto_device_map(ptree, max_memory=budget, mode=mode, device="cpu")
        assert got == want, (trial, got, want)
        PM.check_device_map(ptree, got)
        for path in PS.flatten_pytree(ptree):
            assert PM.placement_of(path, got) == RM.placement_of(path, want)


def test_modeling_helpers_match_reference():
    assert PM.dtype_byte_size(torch.float32) == RM.dtype_byte_size(jnp.float32) == 4
    assert PM.dtype_byte_size(torch.bfloat16) == RM.dtype_byte_size(jnp.bfloat16) == 2
    assert PM.dtype_byte_size(torch.int8) == 1 and PM.dtype_byte_size(torch.bool) == 1 / 8
    w = torch.ones(2, 2)
    assert PM.find_tied_parameters({"a": {"emb": w}, "b": {"head": w}, "c": torch.zeros(3)}) \
        == [["a/emb", "b/head"]]
    params = {"a": np.zeros((1000,), np.float32), "b": np.zeros((10,), np.float32)}
    raw = {"device": 100_000, "cpu": 100_000, "disk": 1 << 62}
    pparams = jax.tree_util.tree_map(torch.from_numpy, params)
    for low in (False, True):
        assert PM.get_balanced_memory(pparams, raw, low_zero=low) == \
            RM.get_balanced_memory(params, raw, low_zero=low)
    dm = {"": "device", "layers": "cpu", "layers/block/attn": "disk"}
    for p in ("embedding", "layers/block/mlp/w_up", "layers/block/attn/wq"):
        assert PM.placement_of(p, dm) == RM.placement_of(p, dm)
    with pytest.raises(ValueError, match="does not cover"):
        PM.check_device_map({"a": torch.zeros(1), "b": torch.zeros(1)}, {"a": "device"})
    with pytest.raises(ValueError, match="unknown device-map mode"):
        PM.infer_auto_device_map(pparams, max_memory=raw, mode="bogus")
    mm = PM.get_max_memory(device="cpu")
    assert mm["device"] == int(PM.CPU_DEVICE_BYTES * 0.9) and 0 < mm["cpu"] < mm["disk"]
    assert PM.get_max_memory({"device": 5}) == {"device": 5}


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(MAPS))
def test_dispatched_logits_match_reference(ckpt, tmp_path, name):
    """The same checkpoint and map through both packages' dispatch."""
    jm, _, _ = _reference()
    ids = _ids()
    ref = RB.load_checkpoint_and_dispatch(jm, ckpt, jnp.zeros((1, 8), jnp.int32),
                                          device_map=MAPS[name],
                                          offload_folder=str(tmp_path / "r"))
    want = np.asarray(ref(jnp.asarray(ids))["logits"])
    np.testing.assert_allclose(want, _ref_logits(ids), atol=ATOL, rtol=ATOL)
    m = PB.load_checkpoint_and_dispatch(DecoderConfig.tiny(), ckpt, device_map=MAPS[name],
                                        offload_folder=str(tmp_path / "off"), device="cpu")
    assert m.device_map == ref.device_map
    got = m(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)
    off_card = name not in ("all-device",)
    streamed = [w for blk in m.model.layers for w in blk.streamed] + list(m.model.streamed)
    assert bool(streamed) == off_card
    # one device buffer per weight kind, shared by every layer
    assert len({id(w.buffer) for w in streamed}) == len(m._buffers)
    assert set(m.phase_seconds) >= {"ckpt_read", "transfer_submit", "weight_stream_total"}


def test_cpu_and_disk_offload_and_dispatch_model_match_reference(tmp_path):
    jm, params, cfg = _reference()
    ids = _ids(seed=1)
    want = _ref_logits(ids)
    for m in (PB.cpu_offload(cfg, params, device="cpu"),
              PB.disk_offload(cfg, params, str(tmp_path / "d"), device="cpu"),
              PB.dispatch_model(cfg, params, MAPS["split-leaves"],
                                offload_folder=str(tmp_path / "s"), device="cpu")):
        np.testing.assert_allclose(m(torch.from_numpy(ids)).numpy(), want, atol=ATOL, rtol=ATOL)
    assert os.path.exists(tmp_path / "d" / "index.json")
    ref = RB.disk_offload(jm, params, str(tmp_path / "rd"))
    np.testing.assert_allclose(np.asarray(ref(jnp.asarray(ids))["logits"]), want, atol=ATOL)
    with pytest.raises(ValueError, match="offload_folder"):
        PB.dispatch_model(cfg, params, {"": "disk"}, device="cpu")


def test_disk_weights_load_only_during_a_call(tmp_path):
    _, params, cfg = _reference()
    m = PB.disk_offload(cfg, params, str(tmp_path), device="cpu")
    assert all(w.host is None for w in m.model.layers[0].streamed)
    with pytest.raises(RuntimeError, match="during a call"):
        m.model(torch.from_numpy(_ids()))
    m(torch.from_numpy(_ids()))
    assert all(w.host is None for w in m.model.layers[0].streamed)


def test_skipped_layer_copy_changes_the_output():
    """The streaming control of the chip run: a streamer that skips one
    layer's copies leaves the previous layer's weights in the buffer."""
    _, params, cfg = _reference()
    m = PB.cpu_offload(cfg, params, device="cpu")
    ids = torch.from_numpy(_ids())
    good = m(ids)
    real = StreamedWeight.stage

    def skipping(w):
        if any(w is s for s in m.model.layers[1].streamed):
            return
        real(w)

    StreamedWeight.stage = skipping
    try:
        bad = m(ids)
    finally:
        StreamedWeight.stage = real
    assert (bad - good).abs().max() > 1e-3
    torch.testing.assert_close(m(ids), good, atol=0, rtol=0)


def test_materialize_offload_and_hooks(tmp_path):
    jm, params, cfg = _reference()
    ids = torch.from_numpy(_ids())
    want = _ref_logits(_ids())
    m = PB.disk_offload(cfg, params, str(tmp_path), device="cpu").materialize()
    assert m.device_map == {"": "device"}
    assert not m._buffers and not [w for blk in m.model.layers for w in blk.streamed]
    assert all(isinstance(v, torch.Tensor) for v in PS.flatten_pytree(m.params).values())
    np.testing.assert_allclose(m(ids).numpy(), want, atol=ATOL, rtol=ATOL)
    m.offload()
    assert m.device_map == {"": "cpu"} and all(blk.streamed for blk in m.model.layers)
    np.testing.assert_allclose(m(ids).numpy(), want, atol=ATOL, rtol=ATOL)
    m1, hook1 = PB.cpu_offload_with_hook(cfg, params, device="cpu")
    m2, hook2 = PB.cpu_offload_with_hook(cfg, params, prev_module_hook=hook1, device="cpu")
    np.testing.assert_allclose(m1(ids).numpy(), want, atol=ATOL, rtol=ATOL)
    assert m1.device_map == {"": "device"}
    np.testing.assert_allclose(m2(ids).numpy(), want, atol=ATOL, rtol=ATOL)
    assert m1.device_map == {"": "cpu"} and m2.device_map == {"": "device"}
    hook2.offload()
    assert m2.device_map == {"": "cpu"}


@pytest.mark.parametrize("quant", list(QUANT))
def test_quantized_dispatch_matches_reference(ckpt, quant):
    """Eligible device-tier leaves quantize on load as the reference's do:
    the same packed leaves, bit for bit, and logits within 1e-5 of the
    reference's quantized dispatch."""
    jm, _, cfg = _reference()
    ids = _ids(s=32, seed=2)
    ref = RB.load_checkpoint_and_dispatch(jm, ckpt, jnp.zeros((1, 32), jnp.int32),
                                          device_map="auto", quantization_config=RQC(**QUANT[quant]))
    want = np.asarray(ref(jnp.asarray(ids))["logits"])
    m = PB.load_checkpoint_and_dispatch(cfg, ckpt, device_map="auto",
                                        quantization_config=QuantizationConfig(**QUANT[quant]),
                                        device="cpu")
    np.testing.assert_allclose(m(torch.from_numpy(ids)).numpy(), want, atol=ATOL, rtol=ATOL)
    rflat = RS.flatten_pytree(jax.tree_util.tree_map(np.asarray, ref.params))
    pflat = PS.flatten_pytree(m.params)
    assert list(rflat) == list(pflat)
    for k in rflat:
        np.testing.assert_array_equal(np.asarray(rflat[k]), pflat[k].numpy(), err_msg=k)
    assert m.phase_seconds["host_quantize"] > 0
    assert isinstance(m.model.layers[1].mlp.w_up, QuantizedLayer)
    assert isinstance(m.model.layers[1].ln_attn, QuantizedLayer)  # stacked norms quantize


@pytest.mark.parametrize("quant", list(QUANT))
def test_quantized_dispatch_equals_dequantized_plain_model(ckpt, quant):
    """Dequantizing at use computes what a DecoderLM loaded with
    ``dequantize_params`` of the same leaves computes: equal logits."""
    from accelerate_tpu_torch.utils.quantization import dequantize_params

    cfg = DecoderConfig.tiny()
    m = PB.load_checkpoint_and_dispatch(cfg, ckpt, quantization_config=QuantizationConfig(
        **QUANT[quant]), device="cpu")
    plain = DecoderLM(cfg, device="cpu").load_params(
        from_reference(dequantize_params(m.params), cfg))
    ids = torch.from_numpy(_ids())
    with torch.no_grad():
        torch.testing.assert_close(m(ids), plain(ids), atol=0, rtol=0)


def test_quantized_tiers_and_load_and_quantize_model(ckpt, tmp_path):
    """load_and_quantize_model (a path or a tree) with packed leaves on
    the cpu and disk tiers, moved and loaded at use."""
    jm, params, cfg = _reference()
    ids = _ids(s=32, seed=3)
    qc = QUANT["int8"]
    ref = RB.load_and_quantize_model(jm, params, RQC(**qc))
    want = np.asarray(ref(jnp.asarray(ids))["logits"])
    for dm in ({"": "device"}, {"": "cpu"}, {"": "device", "layers/block/mlp": "disk"}):
        m = PB.load_and_quantize_model(cfg, ckpt, QuantizationConfig(**qc), device_map=dm,
                                       offload_folder=str(tmp_path / str(len(dm))), device="cpu")
        np.testing.assert_allclose(m(torch.from_numpy(ids)).numpy(), want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("name", ["all-device", "mixed"])
def test_generate_dispatched_matches_reference(ckpt, tmp_path, name):
    jm, _, cfg = _reference()
    ids = _ids(s=12, seed=4)
    ref = RB.load_checkpoint_and_dispatch(jm, ckpt, jnp.zeros((1, 8), jnp.int32),
                                          device_map=MAPS[name],
                                          offload_folder=str(tmp_path / "r"))
    want = np.asarray(rgen.generate_dispatched(ref, jnp.asarray(ids), max_new_tokens=8))
    m = PB.load_checkpoint_and_dispatch(cfg, ckpt, device_map=MAPS[name],
                                        offload_folder=str(tmp_path / "p"), device="cpu")
    got = generate_dispatched(m, torch.from_numpy(ids), max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_port_checkpoint_loads_in_reference(tmp_path):
    """The reverse: the port's weights exported as the reference's stacked
    checkpoint load in the reference's dispatch; an unrolled export loads
    in the port's."""
    jm, params, cfg = _reference()
    weights = from_reference(params, cfg, dtype=torch.float32)
    path = str(tmp_path / "p.safetensors")
    files = export_reference_checkpoint(weights, cfg, path, dtype=torch.float32,
                                        max_shard_size=20_000)
    assert len(files) > 1 and os.path.exists(path + ".index.json")
    ids = _ids(seed=5)
    ref = RB.load_checkpoint_and_dispatch(jm, path, jnp.zeros((1, 8), jnp.int32))
    np.testing.assert_allclose(np.asarray(ref(jnp.asarray(ids))["logits"]), _ref_logits(ids),
                               atol=ATOL, rtol=ATOL)
    jm_u, params_u, cfg_u = _reference(scan=False)
    upath = str(tmp_path / "u.safetensors")
    export_reference_checkpoint(from_reference(params_u, cfg_u, dtype=torch.float32), cfg_u,
                                upath, dtype=torch.float32)
    assert set(RS.load_flat_dict(upath)) == set(RS.flatten_pytree(params_u))
    m = PB.load_checkpoint_and_dispatch(cfg_u, upath, device_map={"": "device", "layer_1": "cpu"},
                                        device="cpu")
    want = np.asarray(jm_u.apply({"params": params_u}, jnp.asarray(ids))["logits"])
    np.testing.assert_allclose(m(torch.from_numpy(ids)).numpy(), want, atol=ATOL, rtol=ATOL)


def test_from_reference_gives_views_of_a_mapped_checkpoint(ckpt):
    cfg = DecoderConfig.tiny()
    flat = PS.load_flat_dict(ckpt)
    weights = from_reference(flat, cfg)
    stacked = flat["layers/block/mlp/w_up"]
    assert weights["layers.1.mlp.w_up"].data_ptr() == stacked[1].data_ptr()
    model = DecoderLM(cfg, device="cpu").load_params(weights)
    ids = _ids()
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(ids)).numpy(), _ref_logits(ids),
                                   atol=ATOL, rtol=ATOL)
    with pytest.raises(ValueError, match="stacks"):
        from_reference(flat, DecoderConfig.tiny(num_layers=3))


def test_load_errors(ckpt, tmp_path):
    cfg = DecoderConfig.tiny()
    abstract = PB.init_empty_weights(cfg)
    PS.save_pytree({"embedding": torch.zeros(4, 4)}, str(tmp_path / "partial.safetensors"))
    with pytest.raises(ValueError, match="missing"):
        PM.load_checkpoint_in_model(abstract, str(tmp_path / "partial.safetensors"),
                                    device="cpu")
    with pytest.raises(ValueError, match="offload_folder"):
        PB.load_checkpoint_and_dispatch(cfg, ckpt, device_map={"": "disk"}, device="cpu")


def test_pipeline_errors_reach_the_caller(ckpt, monkeypatch):
    """A quantize worker that raises stops the pipeline and its error is
    raised on the caller's thread; no pipeline thread stays behind."""
    import threading

    from accelerate_tpu_torch.utils import quantization

    def boom(*a, **k):
        raise RuntimeError("quantizer failed")

    monkeypatch.setattr(quantization, "quantize_array_host", boom)
    with pytest.raises(RuntimeError, match="quantizer failed"):
        PB.load_checkpoint_and_dispatch(DecoderConfig.tiny(), ckpt, device="cpu",
                                        quantization_config=QuantizationConfig(load_in_8bit=True))
    assert not [t for t in threading.enumerate() if t.name.startswith("dispatch-")]


def test_streaming_follows_the_binding_not_a_flag():
    """Dispatch streams whatever it places off the card; the reference's
    ``stream_layer_weights`` switch is accepted only as False."""
    with pytest.raises(ValueError, match="no flag to set"):
        DecoderConfig.tiny(stream_layer_weights=True)
    assert not DecoderConfig.tiny().stream_layer_weights


def test_pipeline_is_deterministic_under_thread_stress(ckpt):
    """Loads under a short switch interval (more pipeline threads than
    cores contend) give the same packed leaves every time."""
    import sys

    cfg = DecoderConfig.tiny()
    qc = QuantizationConfig(load_in_4bit=True, quant_type="nf4", double_quant=True,
                            group_size=16)
    first = PS.flatten_pytree(PB.load_checkpoint_and_dispatch(
        cfg, ckpt, quantization_config=qc, device="cpu").params)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            again = PS.flatten_pytree(PB.load_checkpoint_and_dispatch(
                cfg, ckpt, quantization_config=qc, device="cpu").params)
            assert list(again) == list(first)
            assert all(torch.equal(again[k], first[k]) for k in first)
    finally:
        sys.setswitchinterval(old)


def test_byte_gate_bounds_outstanding_bytes():
    import threading

    gate = PM._ByteGate(100)
    gate.acquire(500)  # an empty pipeline never blocks
    got = []
    t = threading.Thread(target=lambda: (gate.acquire(50), got.append(1)))
    t.start()
    t.join(timeout=0.2)
    assert t.is_alive() and not got
    gate.release(500)
    t.join(timeout=10)
    assert not t.is_alive() and got == [1] and gate.outstanding == 50


def test_to_pinned_host_on_cpu_is_a_plain_copy():
    """Nothing to pin without CUDA: a copy in ordinary host memory."""
    src = torch.arange(6.0)
    out = PM._to_pinned_host(src, torch.device("cpu"))
    assert torch.equal(out, src) and out.data_ptr() != src.data_ptr()
    assert not out.is_pinned()


def test_in_memory_generate_equals_dispatched_generate(ckpt, tmp_path):
    """The chip run's cases (a) and (b) at tiny width: generate() on the
    in-memory model and generate_dispatched on the checkpoint, its leaves
    split over the three tiers, give the same tokens."""
    jm, params, cfg = _reference()
    model = DecoderLM(cfg, device="cpu").load_params(from_reference(params, cfg))
    ids = torch.from_numpy(_ids(seed=6))
    m = PB.load_checkpoint_and_dispatch(cfg, ckpt, device_map=MAPS["split-leaves"],
                                        offload_folder=str(tmp_path), device="cpu")
    assert torch.equal(generate(model, ids, max_new_tokens=6),
                       generate_dispatched(m, ids, max_new_tokens=6))
