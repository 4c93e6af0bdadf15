"""Package-level contracts of the PyTorch/CUDA port.

- ``accelerate_tpu_torch`` (and ``chip_smoke.py``) import no ``jax``,
  ``flax``, ``optax``, ``accelerate_tpu``, ``safetensors`` or
  ``ml_dtypes`` module (the card's machine has none of them; the port
  reads and writes safetensors itself and takes bfloat16 from torch): an
  AST scan of every source, plus a fresh interpreter that imports the
  package and finds none of them in ``sys.modules``.
- Entry points (the model, the weight init, the engine, the Accelerator,
  big-model dispatch) mean CUDA when given no device and raise without
  it, unless ``device="cpu"`` is given.
- The load path's native helper is built with g++, and a failed build
  raises: nothing falls back to the plain version behind it.
- The kernel wrappers take CPU tensors to the plain version without
  counting a launch, refuse any other non-CUDA device, and build with an
  nvcc command for ``sm_90a``; later-slice options raise.
"""

import ast
import json
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import random_params
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.ops import attention, kernels
from accelerate_tpu_torch.serving.engine import ServingEngine
from accelerate_tpu_torch.serving.replica_server import ReplicaServer
from accelerate_tpu_torch.utils.quantization import quantize_kv

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "accelerate_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "accelerate_tpu", "safetensors", "ml_dtypes")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, accelerate_tpu_torch, accelerate_tpu_torch.serving.engine, "
            "accelerate_tpu_torch.serving.arena, accelerate_tpu_torch.serving.drift, "
            "accelerate_tpu_torch.generation, "
            "accelerate_tpu_torch.utils.quantization, "
            "accelerate_tpu_torch.accelerator, accelerate_tpu_torch.data, "
            "accelerate_tpu_torch.ops.losses, accelerate_tpu_torch.optimizer, "
            "accelerate_tpu_torch.scheduler, accelerate_tpu_torch.state, "
            "accelerate_tpu_torch.utils.dataclasses, "
            "accelerate_tpu_torch.serving.replica_server, "
            "accelerate_tpu_torch.telemetry.exporter, "
            "accelerate_tpu_torch.telemetry.fleet, "
            "accelerate_tpu_torch.telemetry.recorder, accelerate_tpu_torch.telemetry.usage, "
            "accelerate_tpu_torch.telemetry.requests, accelerate_tpu_torch.utils.phases, "
            "accelerate_tpu_torch.commands.serve, accelerate_tpu_torch.big_modeling, "
            "accelerate_tpu_torch.utils.modeling, accelerate_tpu_torch.utils.serialization, "
            "accelerate_tpu_torch.utils.offload, accelerate_tpu_torch.runtime.native, "
            "accelerate_tpu_torch.checkpointing, accelerate_tpu_torch.utils.random, "
            "accelerate_tpu_torch.utils.other, accelerate_tpu_torch.utils.constants, "
            "accelerate_tpu_torch.logging, accelerate_tpu_torch.utils.memory, "
            "accelerate_tpu_torch.utils.profiler, accelerate_tpu_torch.utils.tqdm, "
            "accelerate_tpu_torch.runtime.prefetch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    cfg = DecoderConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecoderLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        random_params(cfg)
    model = DecoderLM(cfg, device="cpu").load_params(random_params(cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(model, max_cache_len=64, page_size=8)
    eng = ServingEngine(model, max_cache_len=64, page_size=8, device="cpu")
    out = eng.generate_batched([np.arange(3, 9)], max_new_tokens=2)
    assert out[0].shape == (8,)


def test_dispatch_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from accelerate_tpu_torch import (QuantizationConfig, cpu_offload, cpu_offload_with_hook,
                                      disk_offload, dispatch_model, generate_dispatched,
                                      init_empty_weights, load_and_quantize_model,
                                      load_checkpoint_and_dispatch)
    from accelerate_tpu_torch.big_modeling import DispatchedModel
    from accelerate_tpu_torch.utils.modeling import get_max_memory
    from accelerate_tpu_torch.utils.serialization import flatten_pytree, save_pytree

    cfg = DecoderConfig.tiny()
    abstract = init_empty_weights(cfg)  # meta tensors: no device to ask for
    params = {k: torch.zeros(v.shape) for k, v in flatten_pytree(abstract).items()}
    ckpt = str(tmp_path / "m.safetensors")
    save_pytree(params, ckpt)
    qc = QuantizationConfig(load_in_8bit=True)
    for call in (lambda: load_checkpoint_and_dispatch(cfg, ckpt),
                 lambda: load_checkpoint_and_dispatch(cfg, ckpt, quantization_config=qc),
                 lambda: dispatch_model(cfg, params, {"": "device"}),
                 lambda: DispatchedModel(cfg, params),
                 lambda: cpu_offload(cfg, params),
                 lambda: disk_offload(cfg, params, str(tmp_path / "off")),
                 lambda: cpu_offload_with_hook(cfg, params),
                 lambda: load_and_quantize_model(cfg, ckpt, qc),
                 lambda: get_max_memory()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    model = load_checkpoint_and_dispatch(cfg, ckpt, device="cpu")
    out = generate_dispatched(model, torch.arange(3, 9)[None], max_new_tokens=2)
    assert out.shape == (1, 8) and out.device.type == "cpu"


def test_failed_host_helper_build_raises(monkeypatch, tmp_path):
    """A g++ that fails raises with its output; the quantizer does not
    fall back to the plain version behind it."""
    from accelerate_tpu_torch.runtime import native
    from accelerate_tpu_torch.utils.quantization import quantize_array_host

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "COMPILER", "false")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed"):
        native.build()
    with pytest.raises(RuntimeError, match="failed"):
        quantize_array_host(torch.ones(8, 4), bits=8, group_size=4)
    assert not list((tmp_path / "build").glob("*.so"))


def test_training_entry_points_raise_without_cuda(no_cuda):
    cfg = DecoderConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Accelerator()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Accelerator(mixed_precision="bf16")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecoderLM(cfg, param_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        random_params(cfg, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Accelerator(project_dir="checkpoints-not-made")
    acc = Accelerator(device="cpu")
    assert acc.device == torch.device("cpu") and acc.mixed_precision == "no"
    # the process singleton: CUDA unless the caller asks for the CPU
    from accelerate_tpu_torch import PartialState

    PartialState._reset_state()
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PartialState()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Accelerator()  # also once a CPU state exists below
        assert PartialState(cpu=True).device == torch.device("cpu")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Accelerator()
        assert Accelerator(cpu=True).device == torch.device("cpu")
    finally:
        PartialState._reset_state()


def test_engine_rejects_model_on_other_device():
    cfg = DecoderConfig.tiny()
    model = DecoderLM(cfg, device="meta")
    with pytest.raises(ValueError, match="model lives on"):
        ServingEngine(model, max_cache_len=64, page_size=8, device="cpu")


def test_wrappers_route_cpu_tensors_to_plain():
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.standard_normal((2, 4, 1, 16)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((5, 2, 8, 16)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((5, 2, 8, 16)).astype(np.float32))
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([[9], [4]], dtype=torch.int32)
    before = dict(kernels.launch_counts)
    out = kernels.paged_decode(q, kp, vp, table, pos, 0.25)
    ref = attention.paged_decode_reference(q, kp, vp, table, pos, 0.25)
    torch.testing.assert_close(out, ref, atol=0.0, rtol=0.0)
    # the quantized entries: int8 payload and fp32 scale pages
    kq, ks = quantize_kv(kp, 8)
    vq, vs = quantize_kv(vp, 8)
    out = kernels.paged_decode_quant(q, kq, vq, ks, vs, table, pos, 0.25, 8)
    ref = attention.paged_decode_reference(q, kq, vq, table, pos, 0.25, k_scale=ks,
                                           v_scale=vs, kv_quant_bits=8)
    torch.testing.assert_close(out, ref, atol=0.0, rtol=0.0)
    qp = q[:1, :, :, :].expand(1, 4, 8, 16).contiguous()
    kn = kp[:1, :, :, :].contiguous()
    rows = torch.tensor([0] * 8, dtype=torch.int32)
    row_pos = torch.arange(3, 11, dtype=torch.int32)
    hist = torch.tensor([3, 0], dtype=torch.int32)
    got = kernels.ragged_prefill_quant(qp, kn, kn, kq, vq, ks, vs, table, rows, row_pos,
                                       hist, 0.25, 8, 8)
    want = attention.ragged_prefill_reference(qp, kn, kn, kq, vq, table, rows, row_pos,
                                              hist, 0.25, k_scale=ks, v_scale=vs,
                                              kv_quant_bits=8)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0.0, rtol=0.0)
    assert kernels.launch_counts == before


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA device is refused, not run through the plain version."""
    meta = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty((2, 4, 1, 16), **meta)
    kp = torch.empty((5, 2, 8, 16), **meta)
    table = torch.empty((2, 2), device="meta", dtype=torch.int32)
    with pytest.raises(RuntimeError, match="neither CPU"):
        kernels.paged_decode(q, kp, kp, table, table[:, :1], 0.25)
    with pytest.raises(RuntimeError, match="neither CPU"):
        kernels.ragged_prefill(q[:1], kp[:1], kp[:1], kp, kp, table, table[0],
                               table[0], table[0], 0.25, 8)
    q = torch.empty((1, 4, 128, 64), **meta)
    k = torch.empty((1, 2, 128, 64), **meta)
    stats = torch.empty((1, 4, 128), device="meta", dtype=torch.float32)
    masks = (None, None, None)
    with pytest.raises(RuntimeError, match="neither CPU"):
        kernels.flash_fwd(q, k, k, masks, True, 0.125)
    with pytest.raises(RuntimeError, match="neither CPU"):
        kernels.flash_bwd_dq(q, k, k, q, stats, stats, masks, True, 0.125)
    with pytest.raises(RuntimeError, match="neither CPU"):
        kernels.flash_bwd_dkv(q, k, k, q, stats, stats, masks, True, 0.125)
    q = torch.empty((2, 4, 1, 128), **meta)
    k = torch.empty((2, 2, 64, 128), **meta)
    pay = torch.empty((2, 2, 64, 128), device="meta", dtype=torch.int8)
    scale = torch.empty((2, 2, 64, 1), device="meta", dtype=torch.float32)
    pos = torch.empty((2, 1), device="meta", dtype=torch.int32)
    with pytest.raises(RuntimeError, match="neither CPU"):
        kernels.dense_decode(q, k, k, pos, 0.125)
    with pytest.raises(RuntimeError, match="neither CPU"):
        kernels.dense_decode_quant(q, pay, pay, scale, scale, pos, 0.125, 8)
    pages = torch.empty((5, 2, 8, 128), device="meta", dtype=torch.int8)
    page_scale = torch.empty((5, 2, 8, 1), device="meta", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="neither CPU"):
        kernels.paged_decode_quant(q, pages, pages, page_scale, page_scale, table, pos,
                                   0.125, 8)
    with pytest.raises(RuntimeError, match="neither CPU"):
        kernels.ragged_prefill_quant(q[:1], k[:1, :, :8], k[:1, :, :8], pages, pages,
                                     page_scale, page_scale, table, table[0], table[0],
                                     table[0], 0.125, 8, 8)


@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_nvcc_command_targets_sm90a(name, tmp_path):
    cmd = kernels.nvcc_command(name, tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert str(kernels.CSRC / kernels.KERNELS[name][0]) in cmd
    assert {"-shared", "-O3"} <= set(cmd)
    assert (kernels.CSRC / kernels.KERNELS[name][0]).exists()
    assert kernels.library_path(name).parent == kernels.BUILD_DIR


def test_later_slices_raise():
    # MoE blocks are this port's now (tests/test_torch_moe.py): the config builds
    cfg = DecoderConfig(moe_num_experts=8, moe_top_k=2)
    assert (cfg.moe_num_experts, cfg.moe_top_k) == (8, 2)
    with pytest.raises(NotImplementedError, match="later slice"):
        DecoderConfig.tiny(pipeline_stages=2)
    # fp8 is this port's now (tests/test_torch_fp8.py, tests/test_torch_fp8_models.py):
    # the config builds and runs, and the Accelerator takes mixed_precision="fp8"
    cfg = DecoderConfig.tiny(use_fp8=True, fp8_recipe="delayed")
    model = DecoderLM(cfg, device="cpu").load_params(random_params(cfg, device="cpu"))
    assert len(model.fp8_histories()) == 7 * cfg.num_layers
    with torch.no_grad():
        assert torch.isfinite(model(torch.arange(8)[None])).all()
    with pytest.raises(ValueError, match="fp8_recipe"):
        DecoderConfig.tiny(use_fp8=True, fp8_recipe="hybrid")
    assert Accelerator(mixed_precision="fp8", device="cpu").state.precision.compute_dtype \
        == torch.bfloat16
    # dropout, save_dots and fp16 training are this port's now
    # (tests/test_torch_fp16_training.py, tests/test_torch_remat_dropout.py)
    cfg = DecoderConfig.tiny(dropout_rate=0.1, remat_policy="save_dots", dtype=torch.float16)
    assert (cfg.dropout_rate, cfg.remat_policy, cfg.dtype) == (0.1, "save_dots", torch.float16)
    assert Accelerator(mixed_precision="fp16", device="cpu").state.precision.needs_loss_scaling
    cfg = DecoderConfig.tiny()
    model = DecoderLM(cfg, device="cpu").load_params(random_params(cfg, device="cpu"))
    for kw, what in (({"param_placer": object()}, "dispatched"),
                     ({"donate": True}, "buffer donation")):
        with pytest.raises(NotImplementedError, match=what):
            ServingEngine(model, max_cache_len=64, device="cpu", **kw)
    # KV tiers are this port's now (tests/test_torch_kv_tiers.py): on the
    # paged arena they build the store; the flat arena has no prefix cache
    from accelerate_tpu_torch.serving.tiers import TierConfig, TieredStore

    eng = ServingEngine(model, max_cache_len=64, device="cpu", page_size=8,
                        kv_tiers=TierConfig(host_entries=4))
    assert isinstance(eng._tiers, TieredStore) and eng._prefix.on_evict is not None
    with pytest.raises(ValueError, match="paged arena"):
        ServingEngine(model, max_cache_len=64, device="cpu", kv_tiers=TierConfig())
    # the multi-tenant scheduler and fault injection are this port's now
    # (tests/test_torch_scheduled_serving.py), on both arenas
    from accelerate_tpu_torch.serving import FaultInjector, SchedulerConfig

    for page_size in (8, None):
        eng = ServingEngine(model, max_cache_len=64, device="cpu", page_size=page_size,
                            scheduler=SchedulerConfig(itl_slo_ms=50.0),
                            faults=FaultInjector())
        assert eng._sched is not None and eng._controller is not None
    with pytest.raises(ValueError, match="SLO"):
        ServingEngine(model, max_cache_len=64, device="cpu",
                      scheduler=SchedulerConfig(itl_slo_ms=0.0))
    # and so is the telemetry session (tests/test_torch_serving_telemetry.py)
    from accelerate_tpu_torch.telemetry import TelemetryConfig, TelemetrySession

    session = TelemetrySession(TelemetryConfig(flight_hooks=False))
    try:
        eng = ServingEngine(model, max_cache_len=64, device="cpu", telemetry=session)
        assert eng.telemetry is session and eng._tracer() is session.requests
    finally:
        session.close()
    # the quantized paged arena and speculative verify are this port's now
    ServingEngine(model, max_cache_len=64, device="cpu", kv_cache_dtype="int8",
                  page_size=8, spec_draft_len=2)
    # and so is the replica identity, with the server and its fault injection
    eng = ServingEngine(model, max_cache_len=64, device="cpu", replica="r0",
                        steps_per_call=1)
    assert eng.replica == "r0" and eng.telemetry is None
    assert eng.submit(np.arange(3, 9), max_new_tokens=2).replica == "r0"
    server = ReplicaServer(eng, faults=FaultInjector().wrong_token(count=1)).start()
    try:
        body = json.dumps({"prompt": [5, 6, 7], "max_new_tokens": 2, "stream": True})
        with urllib.request.urlopen(urllib.request.Request(
                f"{server.url}/v1/submit", data=body.encode()), timeout=60) as resp:
            events = [json.loads(line) for line in resp.read().splitlines()]
        assert events[-1]["outcome"] == "finished"
        assert events[0]["token"] == events[-1]["tokens"][0] ^ 1  # the drill's one flip
    finally:
        server.close()
    # decode bursts are this port's now (tests/test_torch_bursts.py), and
    # so is build_train_step(steps_per_call=K) (tests/test_torch_training.py)
    assert ServingEngine(model, max_cache_len=64, device="cpu",
                         steps_per_call=4).steps_per_call == 4


def test_engine_defaults_to_the_flat_arena_as_the_reference():
    """``page_size`` defaults to None (the reference's default: the flat
    arena), and speculative verify without a page size raises, as the
    reference does."""
    import inspect

    assert inspect.signature(ServingEngine).parameters["page_size"].default is None
    cfg = DecoderConfig.tiny()
    model = DecoderLM(cfg, device="cpu").load_params(random_params(cfg, device="cpu"))
    eng = ServingEngine(model, max_cache_len=64, device="cpu")
    assert eng.page_size is None
    with pytest.raises(ValueError, match="requires the paged arena"):
        ServingEngine(model, device="cpu", spec_draft_len=2)


def test_flash_impl_runs_the_plain_flash_path_on_cpu():
    """attention_impl="flash" (a later slice in the serving-only port) is
    the flash path now: on the CPU, the kernels' plain versions."""
    cfg = DecoderConfig.tiny(attention_impl="flash", max_seq_len=128)
    params = random_params(cfg, device="cpu")
    flash = DecoderLM(cfg, device="cpu").load_params(params)
    plain = DecoderLM(DecoderConfig.tiny(attention_impl="xla", max_seq_len=128),
                      device="cpu").load_params(params)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 128)))
    with torch.no_grad():
        torch.testing.assert_close(flash(ids), plain(ids), atol=1e-4, rtol=1e-4)
