"""ResNet-family image classifier.

Counterpart of ``accelerate_tpu/models/vision.py`` (the model of the
reference's ``examples/cv_example.py``). Images come in NHWC, as in the
reference; ``permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is
already a channels_last NCHW tensor, with no copy, which is the layout
cuDNN's tensor-core convolutions read. Convolutions and pooling are
cuDNN's (``F.conv2d``, ``F.max_pool2d``): the reference's are XLA
convolutions, not Pallas kernels.

The reference's conventions, kept here:

- SAME padding is XLA's: ``total = max((ceil(n / s) - 1) * s + k - n,
  0)`` split ``total // 2`` low and the rest high, so a 3x3/2 conv on an
  even input pads (0, 1), the 7x7/2 stem on 224 pads (2, 3) and the
  3x3/2 max pool pads (0, 1) with -inf. Torch's ``padding=`` is
  symmetric, so an asymmetric split pads with ``F.pad`` first.
- BatchNorm is flax's: statistics in fp32 over (N, H, W), the biased
  variance, the running averages kept as ``momentum * running + (1 -
  momentum) * batch`` with flax's ``momentum`` (0.9; torch's 0.1), the
  output rounded once to the compute dtype. (flax computes the variance
  as ``E[x^2] - E[x]^2``; the fused op here in a stabler order: the same
  value up to fp32 rounding.) The running averages are module buffers ``mean`` /
  ``var`` (the reference's ``batch_stats`` collection), updated by a
  forward with ``train=True`` and never cast; the scale and bias are
  parameters, rounded by the mixed-precision cast like every other.
- Each block's last BatchNorm scale starts at zero
  (``models/convert.random_params``), so residual branches start as the
  identity.

Module and weight names are the reference's (``stem_conv.kernel``,
``stage{s}_block{b}.Conv_0.kernel``, ``...BatchNorm_0.scale`` /
``.bias`` / ``.mean`` / ``.var``, ``proj`` / ``proj_bn``,
``classifier.kernel`` / ``.bias``); conv kernels are OIHW here, HWIO in
the reference (``models/convert.py`` transposes).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.losses import softmax_cross_entropy
from .configs import VisionConfig
from .decoder import _Model, _Module, resolve_device


def same_padding(size: int, kernel: int, stride: int) -> tuple:
    """XLA's SAME padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(_Module):
    """A bias-free square convolution with SAME padding, kernel OIHW."""

    def __init__(self, cin: int, cout: int, size: int, stride: int, config, device, dtype):
        super().__init__()
        self.config, self.size, self.stride = config, size, stride
        self.kernel = self._param((cout, cin, size, size), device, dtype)

    def forward(self, x):
        if x.device.type == "cpu":
            # torch's CPU backward of a channels_last 1x1 / stride-2 conv
            # corrupts the heap (torch 2.13): the CPU convolves NCHW
            x = x.contiguous()
        (ht, hb), (wl, wr) = (same_padding(n, self.size, self.stride) for n in x.shape[2:])
        pad = ht
        if not ht == hb == wl == wr:
            x = F.pad(x, (wl, wr, ht, hb))
            pad = 0
        return F.conv2d(x, self._use(self.kernel, self.config.dtype), stride=self.stride,
                        padding=pad)


class BatchNorm(_Module):
    """flax's ``nn.BatchNorm`` over the channel axis of NCHW: statistics
    and the affine map in fp32 (one fused op, cuDNN's on CUDA), the
    output in ``x``'s dtype; in training the batch's biased variance,
    which the running average takes too (``F.batch_norm`` would take the
    unbiased one), so the running update is written here."""

    def __init__(self, channels: int, config, device, dtype):
        super().__init__()
        self.config = config
        self.scale = self._param((channels,), device, dtype)
        self.bias = self._param((channels,), device, dtype)
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def forward(self, x, train: bool):
        cfg = self.config
        scale = self._use(self.scale, torch.float32)
        bias = self._use(self.bias, torch.float32)
        if not train:
            return F.batch_norm(x, self.mean, self.var, scale, bias, False, 0.0, cfg.bn_eps)
        y, mean, invstd = torch.ops.aten.native_batch_norm(x, scale, bias, None, None, True,
                                                           0.0, cfg.bn_eps)
        with torch.no_grad():
            m = cfg.bn_momentum
            self.mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.var.mul_(m).add_(invstd.pow(-2) - cfg.bn_eps, alpha=1.0 - m)
        return y


class _Block(_Module):
    """One residual block: ``convs`` ([(cin, cout, size, stride)]), each
    followed by its BatchNorm and a relu but the last, then the projection
    (1x1 conv + BatchNorm) of the residual where the shape changes."""

    def __init__(self, convs, cin: int, cout: int, stride: int, config, device, conv_dt,
                 norm_dt):
        super().__init__()
        self.config = config
        self.cout = cout
        for i, (ci, co, size, s) in enumerate(convs):
            self.add_module(f"Conv_{i}", Conv(ci, co, size, s, config, device, conv_dt))
            self.add_module(f"BatchNorm_{i}", BatchNorm(co, config, device, norm_dt))
        self.depth = len(convs)
        self.proj = self.proj_bn = None
        if stride != 1 or cin != cout:
            self.proj = Conv(cin, cout, 1, stride, config, device, conv_dt)
            self.proj_bn = BatchNorm(cout, config, device, norm_dt)

    def forward(self, x, train: bool):
        y = x
        for i in range(self.depth):
            y = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(y), train)
            if i + 1 < self.depth:
                y = F.relu(y)
        residual = x
        if self.proj is not None:
            residual = self.proj_bn(self.proj(x), train)
        return F.relu(residual + y)


def basic_block(cin: int, filters: int, stride: int, *args) -> _Block:
    """Two 3x3 convs (ResNet-18/34)."""
    return _Block([(cin, filters, 3, stride), (filters, filters, 3, 1)], cin, filters, stride,
                  *args)


def bottleneck_block(cin: int, filters: int, stride: int, *args) -> _Block:
    """1x1 reduce, 3x3, 1x1 expand (ResNet-50/101/152), v1.5: the stride
    on the 3x3."""
    return _Block([(cin, filters, 1, 1), (filters, filters, 3, stride),
                   (filters, 4 * filters, 1, 1)], cin, 4 * filters, stride, *args)


class Dense(_Module):
    """The classifier: ``x @ kernel + bias`` in fp32 (the reference's
    ``nn.Dense(dtype=float32)``; its parameters take the cast first)."""

    def __init__(self, cin: int, cout: int, device, dtype):
        super().__init__()
        self.kernel = self._param((cin, cout), device, dtype)
        self.bias = self._param((cout,), device, dtype)

    def forward(self, x):
        return x @ self._use(self.kernel, torch.float32) + self._use(self.bias, torch.float32)


class ResNet(_Model):
    """``forward(images [B, H, W, 3], labels=None, train=False) ->
    {"logits"[, "loss"]}``: logits fp32, the loss the mean softmax cross
    entropy. ``train=True`` normalizes with the batch's statistics and
    updates the running ones. ``device=None`` means CUDA and raises
    without it; ``param_dtype`` None stores conv kernels in the compute
    dtype and BatchNorm and classifier parameters in fp32, frozen
    (inference); a dtype stores every parameter in it, trainable (fp32
    master weights for training). Parameters are created uninitialized:
    load them with ``models/convert.py``."""

    def __init__(self, config: VisionConfig, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        dev = self.device
        conv_dt = param_dtype or config.dtype
        norm_dt = param_dtype or torch.float32
        f = config.num_filters
        size = 7 if config.stem == "imagenet" else 3
        self.stem_conv = Conv(3, f, size, 2 if config.stem == "imagenet" else 1, config, dev,
                              conv_dt)
        self.stem_bn = BatchNorm(f, config, dev, norm_dt)
        make = bottleneck_block if config.block == "bottleneck" else basic_block
        cin = f
        self.blocks = []
        for stage, num_blocks in enumerate(config.stage_sizes):
            for b in range(num_blocks):
                name = f"stage{stage}_block{b}"
                block = make(cin, f * 2 ** stage, 2 if (stage > 0 and b == 0) else 1,
                             config, dev, conv_dt, norm_dt)
                self.add_module(name, block)
                self.blocks.append(name)
                cin = block.cout
        self.classifier = Dense(cin, config.num_classes, dev, norm_dt)
        if param_dtype is None:
            self.requires_grad_(False)

    @staticmethod
    def max_pool(x):
        """The stem's 3x3/2 max pool, SAME padded with -inf."""
        (ht, hb), (wl, wr) = (same_padding(n, 3, 2) for n in x.shape[2:])
        return F.max_pool2d(F.pad(x, (wl, wr, ht, hb), value=-math.inf), 3, 2)

    def forward(self, images: torch.Tensor, labels: Optional[torch.Tensor] = None,
                train: bool = False):
        cfg = self.config
        self._arm_casts()
        x = images.to(cfg.dtype).permute(0, 3, 1, 2)  # channels_last NCHW, no copy
        x = F.relu(self.stem_bn(self.stem_conv(x), train))
        if cfg.stem == "imagenet":
            x = self.max_pool(x)
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        pooled = x.float().mean((2, 3)).to(cfg.dtype)  # global average pool
        logits = self.classifier(pooled.float())
        out = {"logits": logits}
        if labels is not None:
            out["loss"] = softmax_cross_entropy(logits, torch.as_tensor(labels,
                                                                        device=logits.device))
        return out
