"""PyTorch/CUDA port of ``accelerate_tpu``: serving (paged and flat
arenas, and one engine behind HTTP as a replica), KV-cache generation
(decoder-only and encoder-decoder),
big-model dispatch (device / pinned-host / disk tiers, weight
quantization on load) and the training step with its checkpoints.

The JAX package (``accelerate_tpu``) stays the reference; this package is
its counterpart for an NVIDIA H100. Module paths mirror the reference:

- ``models/configs.py``, ``models/decoder.py``, ``models/moe.py`` (MoE
  blocks), ``models/seq2seq.py`` (T5 family), ``models/encoder.py`` (BERT
  family), ``models/vision.py`` (ResNet), ``models/convert.py``
- ``ops/layers.py``, ``ops/losses.py``, ``ops/attention.py`` (plain
  versions + kernel dispatch), ``ops/kernels.py`` (nvcc build, ctypes
  binding, checked wrappers with launch counters), ``csrc/*.cu`` (the
  hand-written Hopper kernels)
- ``serving/pages.py`` (paged arena, prefix cache, n-gram drafter),
  ``serving/arena.py``, ``serving/engine.py`` (paged or flat, bf16 or
  int8/int4 KV, speculative verify, decode bursts, cancel / timeout /
  drain, ``generate_batched``),
  ``serving/replica_server.py`` (``ReplicaServer``: the engine over
  stdlib HTTP), ``serving/drift.py`` (``kv_quant_drift``),
  ``generation.py`` (``generate``, ``generate_dispatched``,
  ``generate_seq2seq``, ``generate_seq2seq_dispatched``),
  ``utils/quantization.py`` (int8/int4/NF4 weights on load, int8/int4
  KV storage)
- ``big_modeling.py`` (``load_checkpoint_and_dispatch``,
  ``dispatch_model``, ``init_empty_weights``, ``cpu_offload``,
  ``disk_offload``, ``cpu_offload_with_hook``,
  ``load_and_quantize_model``), ``utils/modeling.py`` (device maps, the
  checkpoint load pipeline), ``utils/serialization.py`` (safetensors and
  pickle checkpoints), ``utils/offload.py`` (the disk tier),
  ``runtime/native.py`` + ``csrc/host_runtime.cpp`` (the load path's
  native helpers, built with g++)
- ``utils/cuda_graphs.py`` (the decode and verify steps as CUDA graphs)
- ``serving/tiers.py`` (host / disk / peer KV tiers under the prefix
  cache), ``serving/router.py`` (``Router``, ``RouterServer``: placement,
  affinity, failover and re-queue over replicas; no torch)
- ``telemetry/`` (the serving session: histograms, request records,
  spans, goodput, usage, the flight recorder, ``timeline.py``,
  ``alerts.py``; ``exporter.py``'s ``prometheus_text``; ``fleet.py``'s
  ``load_score`` and ``FleetCollector``), ``commands/serve.py``
  (``python -m accelerate_tpu_torch.commands.serve replica`` and
  ``router``)
- ``accelerator.py``, ``optimizer.py``, ``scheduler.py``, ``state.py``,
  ``data.py``, ``utils/dataclasses.py`` (the training contract: bf16,
  fp16 with the dynamic loss scale, fp8 with ``ops/fp8.py``'s current and
  delayed scaling, remat, residual dropout),
  ``utils/operations.py`` (the tree helpers; gather / reduce / pad /
  broadcast on one process), ``state.py``'s ``PartialState`` (the
  process singleton), ``logging.py`` (``get_logger``),
  ``utils/memory.py`` (``find_executable_batch_size``),
  ``utils/profiler.py`` (``Accelerator.profile``), ``utils/tqdm.py``,
  ``runtime/prefetch.py`` (the loader's host prefetch ring, on
  ``csrc/host_runtime.cpp``),
  ``tracking.py`` (trackers: JSONL, tensorboard, wandb, mlflow, ...);
  ``checkpointing.py``, ``utils/random.py``, ``utils/other.py``,
  ``utils/constants.py`` (``save_state`` / ``load_state`` /
  ``save_model`` in the reference's checkpoint format)

Entry points take ``device=None``, which means CUDA; without CUDA they
raise unless the caller passes ``device="cpu"`` (the plain PyTorch
versions of the kernels then run). Nothing here imports JAX.
"""

# every name resolves at first use (PEP 562): importing a torch-free
# module of the package (the router, the KV tiers, the fleet collector)
# must not import torch
_EXPORTS = {
    "Accelerator": "accelerator",
    "load_accelerator_state": "checkpointing", "load_custom_state": "checkpointing",
    "save_accelerator_state": "checkpointing", "save_custom_state": "checkpointing",
    "save_model_weights": "checkpointing",
    "DataLoader": "data", "skip_first_batches": "data",
    "cpu_offload": "big_modeling", "cpu_offload_with_hook": "big_modeling",
    "disk_offload": "big_modeling", "dispatch_model": "big_modeling",
    "init_empty_weights": "big_modeling", "load_and_quantize_model": "big_modeling",
    "load_checkpoint_and_dispatch": "big_modeling",
    "generate": "generation", "generate_dispatched": "generation",
    "generate_seq2seq": "generation", "generate_seq2seq_dispatched": "generation",
    "DecoderConfig": "models.configs", "DecoderLM": "models.decoder",
    "EncoderConfig": "models.configs", "EncoderClassifier": "models.encoder",
    "Seq2SeqConfig": "models.seq2seq", "Seq2SeqLM": "models.seq2seq",
    "ResNet": "models.vision", "VisionConfig": "models.configs",
    "AcceleratedOptimizer": "optimizer",
    "AcceleratedScheduler": "scheduler", "warmup_cosine_decay_schedule": "scheduler",
    "ServingEngine": "serving.engine", "generate_batched": "serving.engine",
    "AcceleratorState": "state", "GradientState": "state", "PartialState": "state",
    "get_logger": "logging", "find_executable_batch_size": "utils.memory",
    "DataLoaderConfiguration": "utils.dataclasses", "DistributedType": "utils.dataclasses",
    "ProfileKwargs": "utils.dataclasses",
    "LossScale": "accelerator",
    "AutocastKwargs": "utils.dataclasses", "GradScalerKwargs": "utils.dataclasses",
    "GradientAccumulationPlugin": "utils.dataclasses",
    "MixedPrecisionConfig": "utils.dataclasses", "ProjectConfiguration": "utils.dataclasses",
    "QuantizationConfig": "utils.quantization", "set_seed": "utils.random",
    # for custom loops that bypass the Accelerator's updates: the delayed
    # fp8 window only advances when this runs once per optimizer step
    "roll_amax_histories": "ops.fp8",
}


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value
    return value


__all__ = [
    "AcceleratedOptimizer", "AcceleratedScheduler", "Accelerator", "AcceleratorState",
    "AutocastKwargs", "DataLoader", "DataLoaderConfiguration", "DecoderConfig", "DecoderLM",
    "DistributedType", "PartialState", "ProfileKwargs", "find_executable_batch_size",
    "get_logger",
    "EncoderClassifier", "EncoderConfig", "GradScalerKwargs", "GradientAccumulationPlugin", "GradientState", "LossScale",
    "MixedPrecisionConfig", "ProjectConfiguration", "QuantizationConfig", "ResNet",
    "Seq2SeqConfig", "Seq2SeqLM", "ServingEngine", "cpu_offload", "cpu_offload_with_hook", "disk_offload",
    "dispatch_model", "generate", "generate_batched", "generate_dispatched",
    "generate_seq2seq", "generate_seq2seq_dispatched",
    "init_empty_weights", "load_accelerator_state", "load_and_quantize_model",
    "load_checkpoint_and_dispatch", "load_custom_state", "roll_amax_histories",
    "save_accelerator_state",
    "save_custom_state", "save_model_weights", "set_seed", "skip_first_batches",
    "VisionConfig", "warmup_cosine_decay_schedule",
]
