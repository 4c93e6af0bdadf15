"""Big-model inference: load a model larger than the card and run it.

Counterpart of ``accelerate_tpu/big_modeling.py``. A checkpoint in the
reference's format (its flat names: ``layers/block/attn/wq`` stacked
along the layer axis, or ``layer_{i}/...``) goes through
:func:`load_checkpoint_and_dispatch`: an abstract init on the meta
device (:func:`init_empty_weights`), a device map over three tiers
(``utils/modeling.infer_auto_device_map``), then each leaf read straight
to its tier, quantized on the host first when a ``QuantizationConfig``
asks for it (device-tier leaves only, as in the reference). The result
is a :class:`DispatchedModel`, whose ``__call__`` runs the model's
forward and which :func:`generation.generate_dispatched` (a
``DecoderLM``) or :func:`generation.generate_seq2seq_dispatched` (a
``Seq2SeqLM``, the reference's ``encoder/layers/block/...`` and
``decoder/layers/block/...`` stacks) decodes.

How the tiers run (``models/decoder.py``): the dispatched model is the
config's model (``models/convert.model_class``) built on the meta device
whose weights are bound to what the tiers hold, layer by layer:

- "device": rows of the stacked device tensors (views, no copy);
- "cpu": pinned host tensors, copied before each block runs into one
  device buffer per weight kind shared by all layers
  (``StreamedWeight``): the card holds one layer of them at a time, the
  reference's per-layer streaming. The binding is the switch: whatever
  the map places off the card streams (the reference turns its
  ``stream_layer_weights`` on for the same maps);
- "disk": the offload folder's memmaps, made pinned host tensors once
  per call (:meth:`DispatchedModel._concrete`), then streamed as "cpu";
- quantized leaves: ``QuantizedWeight`` layer views, dequantized at use
  and fed to the same matmuls.

The copies and the dequantization are plain torch: the reference has no
Pallas kernel for either (XLA fuses its dequantization into the
consumer). Not carried: the reference's ``aot_compile`` and its AOT
hit counter (the port compiles no program per shape); in their place,
:func:`load_checkpoint_and_dispatch` on CUDA builds the port's CUDA
kernels on a thread while the weights stream.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Mapping, Optional

import numpy as np
import torch

from .models.convert import (CONFIGS, block_of, locate, model_class, port_names,
                             reference_layout, reference_leaves)
from .models.decoder import StreamedWeight, resolve_device
from .utils.modeling import (
    PhaseSeconds,
    _DiskWeight,
    _to_pinned_host,
    check_device_map,
    infer_auto_device_map,
    load_checkpoint_in_model,
    placement_of,
)
from .utils.quantization import NF4_CODE, QuantizedLayer, QuantizedScale, QuantizedWeight
from .utils.serialization import flatten_pytree, load_flat_dict, unflatten_to_like

DEVICE_MAP_MODES = ("auto", "balanced", "balanced_low_0", "sequential")


def _config_of(definition):
    """A config (``DecoderConfig``, ``Seq2SeqConfig`` or
    ``EncoderConfig``), or the config of a model that carries one."""
    return definition if isinstance(definition, CONFIGS) else definition.config


def init_empty_weights(definition, param_dtype: torch.dtype = torch.float32) -> dict:
    """The reference's parameter tree of ``definition`` (a config, or a
    model carrying one) as meta tensors: shapes and dtypes, no memory.
    Nested dicts whose flattened names are the reference's (a decoder's
    ``embedding``, ``layers/block/attn/wq`` stacked [L, E, H, D] under
    ``scan_layers``, else ``layer_{i}/attn/wq``; a seq2seq model's
    ``encoder/layers/block/...`` and ``decoder/layers/block/...``, ...);
    every leaf in ``param_dtype``, fp32 as the reference initializes."""
    cfg = _config_of(definition)
    params = dict(model_class(cfg)(cfg, device="meta", param_dtype=param_dtype)
                  .named_parameters())
    return unflatten_to_like({
        ref: torch.empty(shape, dtype=params[names[0]].dtype, device="meta")
        for ref, (names, shape) in reference_layout(cfg, params).items()})


def _map_tensors(leaf, fn):
    """``fn`` over the tensors of a leaf: a tensor, a disk handle (loaded),
    or a QuantizedWeight / QuantizedScale (each child)."""
    if isinstance(leaf, (QuantizedWeight, QuantizedScale)):
        return leaf.tree_rebuild([_map_tensors(c, fn) for c in leaf.tree_children()])
    if isinstance(leaf, _DiskWeight):
        return fn(leaf.load())
    return fn(leaf)


def _pin_disk(leaf, device: torch.device):
    """A leaf with its disk handles loaded into pinned host memory."""
    if isinstance(leaf, (QuantizedWeight, QuantizedScale)):
        return leaf.tree_rebuild([_pin_disk(c, device) for c in leaf.tree_children()])
    if isinstance(leaf, _DiskWeight):
        return _to_pinned_host(leaf.load(), device)
    return leaf


def _holds_disk(leaf) -> bool:
    if isinstance(leaf, (QuantizedWeight, QuantizedScale)):
        return any(_holds_disk(c) for c in leaf.tree_children())
    return isinstance(leaf, _DiskWeight)


class DispatchedModel:
    """A model whose weights sit on the tiers of ``device_map``; calling it
    runs the forward (a ``DecoderLM``'s logits, a ``Seq2SeqLM``'s
    ``{"logits"}``). ``params`` is the reference's tree (nested, its flat
    names) of device tensors, pinned host tensors, disk handles and
    QuantizedWeights. ``model`` is the port's model bound to them (see the
    module docstring); ``phase_seconds`` holds the load's phases when
    :func:`load_checkpoint_and_dispatch` made it."""

    def __init__(self, definition, params, device_map: Optional[Mapping[str, str]] = None,
                 device=None):
        self.device = resolve_device(device)
        self.device_map = dict(device_map or {})
        self.config = _config_of(definition)
        self.params = params
        self.phase_seconds: dict = {}
        self._buffers: dict = {}
        self._code = None
        self.model = self._bind(params)

    def _buffer(self, kind: str, shape, dtype) -> torch.Tensor:
        """The device buffer every layer of one host-tier weight kind
        shares, made once."""
        key = (kind, tuple(shape), dtype)
        if key not in self._buffers:
            self._buffers[key] = torch.empty(shape, dtype=dtype, device=self.device)
        return self._buffers[key]

    def _bind(self, params):
        """The config's model on the meta device whose weights are the
        tiers' per-layer views of ``params``."""
        cfg = self.config
        model = model_class(cfg)(cfg, device="meta")
        model.device = self.device
        leaves = reference_leaves(params)
        streamed: dict = {}
        for name in port_names(cfg):
            ref, i, _ = locate(name, cfg)
            leaf = leaves[ref]
            if isinstance(leaf, QuantizedWeight):
                if leaf.qtype == "nf4" and self._code is None:
                    self._code = torch.from_numpy(NF4_CODE).to(self.device)
                value = QuantizedLayer(leaf, i, self.device, self._code)
            elif placement_of(ref, self.device_map) == "device":
                value = leaf if i is None else leaf[i]
            else:
                host = None if isinstance(leaf, _DiskWeight) else leaf
                if host is not None and i is not None:
                    host = host[i]
                shape = leaf.shape[1:] if i is not None else leaf.shape
                owner, kind = block_of(name, cfg)
                value = StreamedWeight(host, self._buffer(kind, shape, leaf.dtype))
                streamed.setdefault(owner, []).append(value)
            module_name, _, attr = name.rpartition(".")
            module = model.get_submodule(module_name)
            module._parameters.pop(attr, None)
            setattr(module, attr, value)
        for owner, weights in streamed.items():
            model.get_submodule(owner).streamed = tuple(weights)
        return model

    @contextlib.contextmanager
    def _concrete(self):
        """For the length of a call: disk-tier weights loaded into pinned
        host memory (host memory on a CPU device) and bound, so they
        stream as "cpu" weights do; unbound again after."""
        leaves = reference_leaves(self.params)
        if not any(_holds_disk(leaf) for leaf in leaves.values()):
            yield
            return
        self.model = self._bind(unflatten_to_like(
            {k: _pin_disk(v, self.device) for k, v in leaves.items()}))
        try:
            yield
        finally:
            self.model = self._bind(self.params)

    @torch.no_grad()
    def __call__(self, input_ids, *args, **kwargs):
        """The model's forward over ``input_ids``: a ``DecoderLM``'s logits
        [B, S, V] (fp32), a ``Seq2SeqLM``'s ``{"logits"}`` (with
        ``decoder_input_ids`` / ``labels``, ``attention_mask``). Arrays and
        tensors among the arguments move to the model's device."""
        def on_device(v):
            if isinstance(v, (torch.Tensor, np.ndarray)):
                return torch.as_tensor(v, device=self.device)
            return v

        with self._concrete():
            return self.model(torch.as_tensor(input_ids, device=self.device),
                              *map(on_device, args),
                              **{k: on_device(v) for k, v in kwargs.items()})

    def materialize(self):
        """Every weight on the card (drops the offload tiers)."""
        if self.device_map == {"": "device"}:
            return self
        self.params = unflatten_to_like({k: _map_tensors(v, lambda t: t.to(self.device))
                                         for k, v in reference_leaves(self.params).items()})
        self.device_map = {"": "device"}
        self._buffers = {}  # nothing streams now: free the host tiers' buffers
        self.model = self._bind(self.params)
        return self

    def offload(self):
        """Every weight back in pinned host memory (the inverse of
        :meth:`materialize`)."""
        if self.device_map == {"": "cpu"}:
            return self
        self.params = unflatten_to_like(
            {k: _map_tensors(v, lambda t: _to_pinned_host(t.cpu(), self.device))
             for k, v in reference_leaves(self.params).items()})
        self.device_map = {"": "cpu"}
        self.model = self._bind(self.params)
        return self


def dispatch_model(definition, params, device_map: Mapping[str, str],
                   offload_folder: Optional[str] = None, device=None) -> DispatchedModel:
    """Place a tree of weights (the reference's names; tensors, numpy
    arrays or QuantizedWeights) per ``device_map`` and return a runnable.
    ``device`` None means CUDA and raises without it."""
    from .utils.offload import offload_state_dict

    dev = resolve_device(device)
    check_device_map(params, device_map)
    disk_dict = {}
    out = {}
    for path, leaf in flatten_pytree(params).items():
        if isinstance(leaf, _DiskWeight):
            out[path] = leaf  # already offloaded
            continue
        t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))
        tier = placement_of(path, device_map)
        if tier == "device":
            out[path] = t.to(dev)
        elif tier == "cpu":
            out[path] = _to_pinned_host(t.cpu(), dev)
        else:
            name = path.replace("/", ".")
            disk_dict[name] = t
            out[path] = _DiskWeight(name, offload_folder, tuple(t.shape), t.dtype)
    if disk_dict:
        if offload_folder is None:
            raise ValueError("device_map places weights on disk but no offload_folder given")
        offload_state_dict(offload_folder, disk_dict)
    return DispatchedModel(definition, unflatten_to_like(out, params), device_map=device_map,
                           device=dev)


def cpu_offload(definition, params, device=None) -> DispatchedModel:
    """Every weight in pinned host memory, streamed per layer."""
    return dispatch_model(definition, params, {"": "cpu"}, device=device)


def disk_offload(definition, params, offload_folder: str, device=None) -> DispatchedModel:
    """Every weight on disk, loaded per call."""
    return dispatch_model(definition, params, {"": "disk"}, offload_folder=offload_folder,
                          device=device)


class CpuOffloadHook:
    """Lets a pipeline of models share the card: running one demotes the
    previous one (the reference's UserCpuOffloadHook)."""

    def __init__(self, model: DispatchedModel, prev_hook: Optional["CpuOffloadHook"] = None):
        self.model = model
        self.prev_hook = prev_hook

    def pre_forward(self):
        if self.prev_hook is not None:
            self.prev_hook.offload()
        self.model.materialize()

    def offload(self):
        self.model.offload()


class _HookedModel:
    """A DispatchedModel whose every call first promotes its weights (and
    demotes the previous stage's)."""

    def __init__(self, model: DispatchedModel, hook: CpuOffloadHook):
        self._model = model
        self.hook = hook

    def __call__(self, *args, **kwargs):
        self.hook.pre_forward()
        return self._model(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._model, name)


def cpu_offload_with_hook(definition, params, prev_module_hook: Optional[CpuOffloadHook] = None,
                          device=None):
    """The model in pinned host memory, promoted to the card when called,
    with a hook to demote it again. Returns ``(model, hook)``."""
    dispatched = cpu_offload(definition, params, device=device)
    hook = CpuOffloadHook(dispatched, prev_hook=prev_module_hook)
    return _HookedModel(dispatched, hook), hook


def load_and_quantize_model(definition, weights, quantization_config,
                            device_map: Optional[Mapping[str, str]] = None,
                            offload_folder: Optional[str] = None,
                            device=None) -> DispatchedModel:
    """Quantize a model's weights (a tree under the reference's names, or
    a checkpoint path) and dispatch them: the packed tensors live on
    their tier and dequantize at use."""
    from .utils.quantization import quantize_params

    if isinstance(weights, str) or hasattr(weights, "__fspath__"):
        weights = unflatten_to_like(load_flat_dict(str(weights)))
    qparams = quantize_params(weights, quantization_config)
    return dispatch_model(definition, qparams, dict(device_map or {"": "device"}),
                          offload_folder=offload_folder, device=device)


def load_checkpoint_and_dispatch(definition, checkpoint: str, device_map: Any = "auto",
                                 max_memory: Optional[dict] = None,
                                 offload_folder: Optional[str] = None,
                                 dtype: Optional[torch.dtype] = None,
                                 quantization_config=None, device=None) -> DispatchedModel:
    """Abstract init -> device map -> each checkpoint leaf read straight to
    its tier. ``device_map`` is one of "auto", "balanced",
    "balanced_low_0", "sequential" (inferred under ``max_memory``), a
    tier name for everything, or a dict of path prefixes to tiers.
    ``dtype`` casts floating leaves. With ``quantization_config``,
    eligible device-tier leaves quantize on the host as they stream, and
    the map budgets their packed sizes. On CUDA the port's kernels build
    on a thread while the weights stream (the reference's ``precompile``,
    always on). ``device`` None means CUDA and raises without it. The returned model's ``phase_seconds`` holds ``ckpt_read``,
    ``host_quantize``, ``transfer_submit`` (each summed over the threads
    running it) and ``weight_stream_total`` (the load's wall)."""
    dev = resolve_device(device)
    abstract = init_empty_weights(definition)
    if isinstance(device_map, str):
        if device_map in DEVICE_MAP_MODES:
            budget_tree = abstract
            if quantization_config is not None:
                from .utils.quantization import quantize_abstract_tree

                budget_tree = quantize_abstract_tree(abstract, quantization_config)
            device_map = infer_auto_device_map(
                budget_tree, max_memory=max_memory,
                # a global dtype would mis-size the packed leaves
                dtype=None if quantization_config is not None else dtype,
                mode=device_map, device=dev)
        else:
            device_map = {"": device_map}
    kernel_build, build_errors = None, []
    if dev.type == "cuda":
        from .ops import kernels

        def build():
            try:
                kernels.build()
            except Exception as e:  # re-raised after the load
                build_errors.append(e)

        kernel_build = threading.Thread(target=build, name="dispatch-kernel-build", daemon=True)
        kernel_build.start()
    phases = PhaseSeconds()
    with phases("weight_stream_total"):
        params = load_checkpoint_in_model(abstract, checkpoint, device_map=device_map,
                                          offload_folder=offload_folder, dtype=dtype,
                                          quantization_config=quantization_config, device=dev,
                                          phases=phases)
    if kernel_build is not None:
        kernel_build.join()
        if build_errors:
            raise build_errors[0]
    model = DispatchedModel(definition, params, device_map=device_map, device=dev)
    model.phase_seconds = dict(phases)
    return model
