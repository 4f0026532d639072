"""ResNetAE, the unimodal autoencoder baseline (mimm_tpu/models/
autoencoder.py counterpart, :27-238).

A symmetric encoder/decoder with per-level residual stacks and optional
multi-resolution skip convolutions summed at the bottleneck, and a linear
bottleneck ``fc1`` / ``fc2``.  The reference configuration (``build_ae_model``
in train/ae.py): input (256, 256, 1), 2 residual blocks per level, 6
levels, z_dim 192, bottleneck 768, skips on — a 4x4x192 latent and a
768-d ``encode()`` embedding.

NCHW throughout: ``forward`` / ``encode`` take ``(B, C, H, W)`` as the
reference module does.  Module names give the reference state-dict keys
(``encoder.input_conv.0.weight``, ``encoder.res_blk_list.0.1.residual_block.3.weight``,
``decoder.multi_res_skip_list.5.1.running_var``, ``fc1.weight``, ...) with
torch's layouts (Conv2d (O, I, k, k), ConvTranspose2d (I, O, k, k), fc1
reading the NCHW flatten), so reference ``.bin`` files load with
``strict=True``; ``checkpoint.ae_state_dict_from_flax`` re-wires a JAX
tree to them.  BatchNorm follows flax (momentum 0.9, the biased running
variance, at least float32 arithmetic; ``resnet._norm``).  Parameters stay
float32 and are cast to the compute dtype at use, as flax does; the
bottleneck runs in ``promote(dtype, float32)`` and the sigmoid in float32.

The kernel = stride convolutions (``PatchConv`` / ``PatchConvTranspose``)
are a reshape and one matmul, as in JAX: on the card that is 2-6 times
faster forward + backward than cuDNN's ``conv2d`` / ``conv_transpose2d``
at these shapes (tools/patch_conv_timing.py).  Cross-replica BatchNorm (``bn_axis_name``)
comes with the parallel slice and raises.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mimm_tpu_torch.models.resnet import _norm

_LEAKY_SLOPE = 0.2
_PARALLEL = ("comes with the parallel slice (ROADMAP.md queue A, "
             "\"parallel/mesh.py and parallel/pipeline.py\")")


def _act(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, _LEAKY_SLOPE)


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` in ``x``'s dtype (weights cast at use)."""
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    conv.stride, conv.padding)


def patch_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               k: int) -> torch.Tensor:
    """Conv2d with stride = kernel = ``k`` on NCHW ``x`` and torch's
    (O, I, k, k) ``weight``, as JAX computes it: the (B·h·w, I·k·k) patch
    matrix times the weight's, then the bias."""
    n, c, hh, ww = x.shape
    h, v = hh // k, ww // k
    rows = x.reshape(n, c, h, k, v, k).permute(0, 2, 4, 1, 3, 5) \
        .reshape(n * h * v, c * k * k)
    y = rows @ weight.reshape(weight.shape[0], -1).t() + bias
    return y.reshape(n, h, v, -1).permute(0, 3, 1, 2)


def patch_conv_transpose(z: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, k: int) -> torch.Tensor:
    """ConvTranspose2d with stride = kernel = ``k`` and torch's (I, O, k, k)
    ``weight``: each input pixel times the weight matrix, shuffled into
    its k x k patch, then the bias."""
    n, c, h, v = z.shape
    o = weight.shape[1]
    y = z.permute(0, 2, 3, 1).reshape(n * h * v, c) @ weight.reshape(c, -1)
    y = y.reshape(n, h, v, o, k, k).permute(0, 3, 1, 4, 2, 5) \
        .reshape(n, o, h * k, v * k)
    return y + bias.view(1, -1, 1, 1)


class PatchConv(nn.Conv2d):
    """Conv2d with kernel = stride = ``k`` (JAX's ``PatchConv``), run as
    ``patch_conv``."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__(cin, cout, k, k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return patch_conv(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                          self.stride[0])


class PatchConvTranspose(nn.ConvTranspose2d):
    """ConvTranspose2d with kernel = stride = ``k`` (JAX's
    ``PatchConvTranspose``; its spatial flip lives in the weight
    converter), run as ``patch_conv_transpose``."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__(cin, cout, k, k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return patch_conv_transpose(x, self.weight.to(x.dtype),
                                    self.bias.to(x.dtype), self.stride[0])


def _conv_bn(conv: nn.Module, cout: int) -> nn.Sequential:
    """The reference's ``Sequential(conv, BatchNorm2d, LeakyReLU)``: keys
    ``.0`` and ``.1`` (the activation has none)."""
    return nn.Sequential(conv, nn.BatchNorm2d(cout, eps=1e-5))


def _conv_bn_act(block: nn.Sequential, x: torch.Tensor,
                 train: bool) -> torch.Tensor:
    conv = block[0]
    y = conv(x) if isinstance(conv, (PatchConv, PatchConvTranspose)) \
        else _conv(conv, x)
    return _act(_norm(block[1], y, train))


class AEResidualBlock(nn.Module):
    """conv-BN-LeakyReLU twice with an identity shortcut (reference
    autoencoder_model.py:16-33); keys ``residual_block.{0,1,3,4}``."""

    def __init__(self, channels: int):
        super().__init__()
        self.residual_block = nn.Sequential(
            nn.Conv2d(channels, channels, 3, 1, 1),
            nn.BatchNorm2d(channels, eps=1e-5), nn.LeakyReLU(_LEAKY_SLOPE),
            nn.Conv2d(channels, channels, 3, 1, 1),
            nn.BatchNorm2d(channels, eps=1e-5), nn.LeakyReLU(_LEAKY_SLOPE))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        rb = self.residual_block
        h = _act(_norm(rb[1], _conv(rb[0], x), train))
        h = _act(_norm(rb[4], _conv(rb[3], h), train))
        return x + h


class ResNetEncoder(nn.Module):
    """Strided conv pyramid with residual stacks and multi-resolution skips
    (reference autoencoder_model.py:35-108)."""

    def __init__(self, n_residual_blocks: int = 2, n_levels: int = 6,
                 z_dim: int = 192, use_multi_res_skips: bool = True,
                 input_channels: int = 1):
        super().__init__()
        self.n_levels = n_levels
        self.use_multi_res_skips = use_multi_res_skips
        max_filters = 2 ** (n_levels + 3)
        self.input_conv = _conv_bn(nn.Conv2d(input_channels, 8, 3, 1, 1), 8)
        self.res_blk_list = nn.ModuleList()
        self.conv_list = nn.ModuleList()
        self.multi_res_skip_list = nn.ModuleList()
        for i in range(n_levels):
            n1, n2 = 2 ** (i + 3), 2 ** (i + 4)
            ks = 2 ** (n_levels - i)
            self.res_blk_list.append(nn.Sequential(
                *(AEResidualBlock(n1) for _ in range(n_residual_blocks))))
            self.conv_list.append(_conv_bn(PatchConv(n1, n2, 2), n2))
            if use_multi_res_skips:
                self.multi_res_skip_list.append(
                    _conv_bn(PatchConv(n1, max_filters, ks), max_filters))
        self.output_conv = nn.Conv2d(max_filters, z_dim, 3, 1, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = _conv_bn_act(self.input_conv, x, train)
        skips = []
        for i in range(self.n_levels):
            for block in self.res_blk_list[i]:
                x = block(x, train)
            if self.use_multi_res_skips:
                skips.append(_conv_bn_act(self.multi_res_skip_list[i], x,
                                          train))
            x = _conv_bn_act(self.conv_list[i], x, train)
        if self.use_multi_res_skips:
            # JAX's sum([x] + skips): 0 + x + skip0 + skip1 + ...
            x = sum([x] + skips)
        return _conv(self.output_conv, x)


class ResNetDecoder(nn.Module):
    """Transposed-conv pyramid mirroring the encoder (reference
    autoencoder_model.py:110-179)."""

    def __init__(self, n_residual_blocks: int = 2, n_levels: int = 6,
                 z_dim: int = 192, output_channels: int = 1,
                 use_multi_res_skips: bool = True):
        super().__init__()
        self.n_levels = n_levels
        self.use_multi_res_skips = use_multi_res_skips
        max_filters = 2 ** (n_levels + 3)
        self.input_conv = _conv_bn(nn.Conv2d(z_dim, max_filters, 3, 1, 1),
                                   max_filters)
        self.res_blk_list = nn.ModuleList()
        self.conv_list = nn.ModuleList()
        self.multi_res_skip_list = nn.ModuleList()
        n1 = max_filters
        for i in range(n_levels):
            n0, n1 = 2 ** (n_levels - i + 3), 2 ** (n_levels - i + 2)
            ks = 2 ** (i + 1)
            self.conv_list.append(_conv_bn(PatchConvTranspose(n0, n1, 2), n1))
            self.res_blk_list.append(nn.Sequential(
                *(AEResidualBlock(n1) for _ in range(n_residual_blocks))))
            if use_multi_res_skips:
                self.multi_res_skip_list.append(
                    _conv_bn(PatchConvTranspose(max_filters, n1, ks), n1))
        self.output_conv = nn.Conv2d(n1, output_channels, 3, 1, 1)

    def forward(self, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        z = z_top = _conv_bn_act(self.input_conv, z, train)
        for i in range(self.n_levels):
            z = _conv_bn_act(self.conv_list[i], z, train)
            for block in self.res_blk_list[i]:
                z = block(z, train)
            if self.use_multi_res_skips:
                z = z + _conv_bn_act(self.multi_res_skip_list[i], z_top, train)
        return _conv(self.output_conv, z)


class ResNetAE(nn.Module):
    """Encoder, linear bottleneck and decoder (reference
    autoencoder_model.py:183-215).  ``encode`` returns the bottleneck
    embedding the downstream classifiers read.  ``train``: BatchNorm on
    batch statistics, the running statistics updated in place (JAX's
    ``train=True`` with mutable batch_stats)."""

    def __init__(self, input_shape: Tuple[int, int, int] = (256, 256, 1),
                 n_residual_blocks: int = 2, n_levels: int = 6,
                 z_dim: int = 192, bottleneck_dim: int = 768,
                 use_multi_res_skips: bool = True,
                 dtype: torch.dtype = torch.float32,
                 bn_axis_name=None):
        super().__init__()
        if bn_axis_name is not None:
            raise NotImplementedError(f"cross-replica BatchNorm "
                                      f"(bn_axis_name) {_PARALLEL}")
        if input_shape[0] != input_shape[1]:
            raise ValueError(f"ResNetAE needs a square input, got "
                             f"{input_shape}")
        self.input_shape = tuple(input_shape)
        self.z_dim = z_dim
        self.dtype = dtype
        self.img_latent_dim = input_shape[0] // (2 ** n_levels)
        self.encoder = ResNetEncoder(n_residual_blocks, n_levels, z_dim,
                                     use_multi_res_skips, input_shape[2])
        self.decoder = ResNetDecoder(n_residual_blocks, n_levels, z_dim,
                                     input_shape[2], use_multi_res_skips)
        flat = z_dim * self.img_latent_dim ** 2
        self.fc1 = nn.Linear(flat, bottleneck_dim)
        self.fc2 = nn.Linear(bottleneck_dim, flat)

    def _out_dtype(self) -> torch.dtype:
        return torch.promote_types(self.dtype, torch.float32)

    def encode(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, C, H, W) -> (B, bottleneck_dim) in ``promote(dtype, f32)``."""
        h = self.encoder(x.to(self.dtype), train)
        dt = self._out_dtype()
        return F.linear(h.flatten(1).to(dt), self.fc1.weight.to(dt),
                        self.fc1.bias.to(dt))

    def decode(self, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, bottleneck_dim) -> (B, C, H, W), sigmoid taken in
        ``promote(dtype, f32)``."""
        dt = torch.promote_types(z.dtype, self.fc2.weight.dtype)
        lat = self.img_latent_dim
        h = F.linear(z.to(dt), self.fc2.weight.to(dt), self.fc2.bias.to(dt))
        h = self.decoder(h.reshape(-1, self.z_dim, lat, lat).to(self.dtype),
                         train)
        return torch.sigmoid(h.to(self._out_dtype()))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.decode(self.encode(x, train), train)
