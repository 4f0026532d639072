"""ResNet256_6_2_1 image encoder (mimm_tpu/models/resnet.py counterpart).

conv1 (1->8) + six strided BasicBlock layers (8, 16, 32, 64, 128, 192
channels, each halving the spatial size) + 2x2 average pooling + fc1.
Module names give the reference state-dict keys (``layer1.0.conv1.weight``,
``layer1.0.downsample.1.running_mean``, ``fc1.weight``, ...), so reference
``.bin`` files load with ``strict=True``.  Only the canonical stem is
ported; the JAX package's ``s2d_stem`` and ``pallas_stem`` are TPU
schedules of the same function, and sync-BN (``bn_axis_name``) comes with
the parallel slice.  BatchNorm follows flax in eval and train mode.

The public input is NHWC ``(B, 256, 256, 1)`` as in JAX; the tower runs
NCHW inside.  Parameters stay float32 and are cast to the compute dtype at
use, as flax does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


# flax nn.BatchNorm(momentum=0.9): running = 0.9 · running + (1 − 0.9) · batch
_MOMENTUM = 0.9


def _norm(bn: nn.BatchNorm2d, x: torch.Tensor, train: bool) -> torch.Tensor:
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=...)`` on an
    NCHW map.  The arithmetic runs in at least float32 and the result is
    cast to the compute dtype, as flax's ``_normalize`` does (its float32
    mean and variance promote the input).

    ``train``: normalize with the batch statistics, taken in float32 as
    E[x²] − E[x]² clamped at 0, and update the running statistics in place
    with flax's rule, whose running variance is the BIASED batch variance
    (``F.batch_norm(training=True)`` would store the unbiased one)."""
    dt = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(dt)
    if train:
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                          min=0.0)
        with torch.no_grad():
            bn.running_mean.copy_(_MOMENTUM * bn.running_mean
                                  + (1 - _MOMENTUM) * mean)
            bn.running_var.copy_(_MOMENTUM * bn.running_var
                                 + (1 - _MOMENTUM) * var)
    else:
        mean, var = bn.running_mean.to(dt), bn.running_var.to(dt)
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(var + bn.eps) * bn.weight.to(dt)
    y = (xf - mean.view(shape)) * mul.view(shape) + bn.bias.to(dt).view(shape)
    return y.to(x.dtype)


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride,
                    conv.padding)


class BasicBlock(nn.Module):
    """Two 3x3 convs with BatchNorm + identity/1x1-projection shortcut."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 use_projection: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=1e-5, momentum=0.1)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5, momentum=0.1)
        self.downsample = nn.Sequential(
            nn.Conv2d(in_planes, planes, 1, stride, bias=False),
            nn.BatchNorm2d(planes, eps=1e-5, momentum=0.1)) \
            if use_projection else None

    def forward(self, x, train: bool = False):
        out = F.relu(_norm(self.bn1, _conv(self.conv1, x), train))
        out = _norm(self.bn2, _conv(self.conv2, out), train)
        identity = x if self.downsample is None else \
            _norm(self.downsample[1], _conv(self.downsample[0], x), train)
        return F.relu(out + identity)


class ResNet256_6_2_1(nn.Module):
    """The 6-layer strided residual encoder (reference model.py:272-369)."""

    def __init__(self, output_channels: int = 1,
                 blocks_per_layer: Sequence[int] = (2, 2, 2, 2, 2, 2),
                 planes: Sequence[int] = (8, 16, 32, 64, 128, 192),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(1, 8, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(8, eps=1e-5, momentum=0.1)
        inplanes = 8
        for li, (p, blocks) in enumerate(zip(planes, blocks_per_layer)):
            layer = []
            for bi in range(blocks):
                stride = 2 if bi == 0 else 1
                proj = bi == 0 and (stride != 1 or inplanes != p)
                layer.append(BasicBlock(inplanes, p, stride, proj))
                inplanes = p
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))
        self.num_layers = len(planes)
        self.fc1 = nn.Linear(planes[-1] * 4, output_channels)

    def forward(self, x: torch.Tensor,
                train: bool = False) -> Tuple[torch.Tensor, ...]:
        """x: (B, H, W, 1) NHWC.  Returns (y, z, y_sigmoid, z_local,
        y_logits): ``z`` is the pooled map flattened in NHWC order (the JAX
        embedding, elementwise), ``z_local`` the layer-5 map in NHWC.
        ``train``: BatchNorm on batch statistics, running statistics
        updated in place (JAX's ``train=True`` with mutable batch_stats)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(_norm(self.bn1, _conv(self.conv1, x), train))
        z_local = None
        for li in range(self.num_layers):
            for block in getattr(self, f"layer{li + 1}"):
                x = block(x, train)
            if li == 4:  # layer5 feature map == reference z_local
                z_local = x.permute(0, 2, 3, 1)
        x = F.avg_pool2d(x, 2, 2)
        out_dtype = torch.promote_types(x.dtype, torch.float32)
        # fc1's reference weight reads the NCHW flatten; the returned
        # embedding is the NHWC flatten the JAX package returns
        z = x.permute(0, 2, 3, 1).flatten(1).to(out_dtype)
        y_logits = F.linear(x.flatten(1).to(out_dtype),
                            self.fc1.weight.to(out_dtype),
                            self.fc1.bias.to(out_dtype))
        y = torch.softmax(y_logits, dim=1)
        return y, z, torch.sigmoid(y_logits), z_local, y_logits


def build_resnet_model(model_name: str = "resnet256_6_2_1",
                       output_channels: int = 1,
                       dtype: torch.dtype = torch.float32) -> ResNet256_6_2_1:
    if model_name != "resnet256_6_2_1":
        raise ValueError(f"unknown image model: {model_name}")
    return ResNet256_6_2_1(output_channels=output_channels, dtype=dtype)
