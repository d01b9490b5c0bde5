"""BMGAN, the bidirectional-mapping GAN baseline (port of cips_tpu/models/bmgan.py).

  * `DenseUNetGenerator`: T1 concatenated with a spatially broadcast 8-dim
    latent (9 channels) through a dense-block UNet: a stem (two k3 convs, a
    stride-2 conv), dense blocks with stride-2 convs down, a middle dense
    block, dense blocks with the skip concatenated and a transposed k4 s2 conv
    up, a head (two k3 convs, a k3 conv to 1 channel) and Tanh;
  * `ResNetEncoder`: PET -> a stem, 6 stride-2 residual units (2 subunits,
    PReLU), two linear heads (mu, log_var): the bidirectional mapping E;
  * `BMGANDiscriminator`: PatchDiscriminator(3, 32, 1, num_layers_d=4),
    returning the patch-logit map only.

A dense step is MONAI's ConvDenseBlock with one residual unit (k3 conv,
InstanceNorm, LeakyReLU 0.2, a k1 conv on the residual path when the width
changes), its input concatenated with its output, fused by a k3 conv,
InstanceNorm and LeakyReLU 0.2.

The unpacked math. The JAX model's space-to-depth stem and head, its packed
strided residual units, its kernel-sliced concat convs (`_CatConv`), its
sub-pixel transposed conv (``CIPS_BMGAN_TCONV``) are TPU layout devices that
compute the same function; here the concats are `torch.cat` and the up convs
`ConvTranspose3d(k4, s2, p1)`. The generator's ``remat`` recomputes each dense
block in the backward, as the JAX model's does (``torch.utils.checkpoint``;
``remat_policy`` takes JAX's names and the whole block is recomputed); off by
default.

Parameter names are the reference's torch ``state_dict`` names that
`cips_tpu/data/torch_import.py:import_bmgan_generator` and
`import_bmgan_encoder` read (``input_layer.0.weight``,
``down_layers.I.0.layers0.conv.unit0.conv.weight``, ``up_layers.I.8.weight``,
``resblocks.I.conv.unit1.adn.A.weight``, ``linear1.weight``, ...). The
reference's instance norms have no affine; the JAX model's are trained, so the
port keeps their scale and bias at the norms' own places in the reference's
layout (``input_layer.1.weight``, ``...unit0.adn.N.weight``), names the
reference does not have. The discriminator is the port's PatchDiscriminator
under ``patch_d``. Modules take and return channels-last tensors, as the JAX
models do.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from cips_tpu_torch.models.blocks import Linear, check_remat_policy
from cips_tpu_torch.models.discriminator import InstanceNorm, PatchDiscriminator

LATENT_DIM = 8
VOLUME_SHAPE = (96, 128, 96)


class Conv3d(nn.Conv3d):
    """'same'-padded 3-D conv, padding (k-1)//2, with fp32 parameters applied in the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3, stride: int = 1):
        super().__init__(in_channels, out_channels, kernel, stride=stride, padding=(kernel - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv3d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride, self.padding)


class ConvTranspose3d(nn.ConvTranspose3d):
    """ConvTranspose3d(k4, s2, p1): exact x2 upsampling, fp32 parameters applied in the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose3d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride, self.padding)


class LeakyReLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(x, 0.2)


class PReLU(nn.PReLU):
    """torch's PReLU (one shared slope, 0.25 at init), the slope applied in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight.to(x.dtype))


class _Layers(nn.Sequential):
    """nn.Sequential whose InstanceNorm slot followed by a LeakyReLU slot runs as
    one call, the norm's with ``act="leaky_relu"`` (the fused kernels on the
    card); the slots, and so the parameter names, are nn.Sequential's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = list(self)
        i = 0
        while i < len(layers):
            if (isinstance(layers[i], InstanceNorm) and i + 1 < len(layers)
                    and isinstance(layers[i + 1], LeakyReLU)):
                x, i = layers[i](x, act="leaky_relu"), i + 2
            else:
                x, i = layers[i](x), i + 1
        return x


def _conv_block(cin: int, cout: int, stride: int = 1) -> List[nn.Module]:
    """k3 conv, InstanceNorm, LeakyReLU(0.2): three Sequential slots."""
    return [Conv3d(cin, cout, 3, stride), InstanceNorm(cout), LeakyReLU()]


class _ADN(nn.Module):
    """MONAI's ADN in NDA order without dropout: ``N`` (norm) then ``A`` (act)."""

    def __init__(self, channels: int, act: nn.Module):
        super().__init__()
        self.N = InstanceNorm(channels)
        self.A = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.A, LeakyReLU):
            return self.N(x, act="leaky_relu")
        return self.A(self.N(x))


class _Convolution(nn.Module):
    """MONAI's Convolution: ``conv`` then ``adn``."""

    def __init__(self, cin: int, cout: int, stride: int, act: nn.Module):
        super().__init__()
        self.conv = Conv3d(cin, cout, 3, stride)
        self.adn = _ADN(cout, act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.adn(self.conv(x))


class ResidualUnit(nn.Module):
    """MONAI's ResidualUnit: ``subunits`` x (k3 conv, InstanceNorm, act) under
    ``conv.unit{i}``, the stride on the first, plus the residual path:
    identity when the shape is kept, else ``residual``, a conv of kernel 1
    (stride 1) or 3 (strided)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, subunits: int = 1, act: str = "leakyrelu"):
        super().__init__()
        self.conv = nn.Sequential()
        ch, st = cin, stride
        for i in range(max(1, subunits)):
            self.conv.add_module(f"unit{i}", _Convolution(ch, cout, st, PReLU() if act == "prelu" else LeakyReLU()))
            ch, st = cout, 1
        self.residual = (Conv3d(cin, cout, 1 if stride == 1 else 3, stride) if stride != 1 or cin != cout
                         else nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.residual(x) + self.conv(x)


class _ConvDenseBlock(nn.Module):
    """MONAI's ConvDenseBlock with one residual unit (``layers0``): cat([x, unit(x)])."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.layers0 = ResidualUnit(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, self.layers0(x)], dim=1)


def dense_block(cin: int, cout: int) -> List[nn.Module]:
    """Two dense steps, eight Sequential slots: [dense unit, k3 fuse conv, InstanceNorm, LeakyReLU] x 2."""
    return [_ConvDenseBlock(cin, cout), *_conv_block(cin + cout, cout),
            _ConvDenseBlock(cout, cout), *_conv_block(2 * cout, cout)]


class DenseUNetGenerator(nn.Module):
    def __init__(
        self,
        latent_dim: int = LATENT_DIM,
        input_conv_channel: int = 64,
        output_conv_channel: int = 64,
        down_channels: Sequence[int] = (128, 256, 256, 512),
        middle_channels: int = 512,
        up_channels: Sequence[int] = (512, 256, 256, 256, 128),
        remat: bool = False,
        remat_policy: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        check_remat_policy(remat_policy)
        self.remat = remat
        if len(up_channels) != len(down_channels) + 1:
            raise ValueError("up_channels needs one level more than down_channels (the stem's skip)")
        self.dtype = dtype
        ic = input_conv_channel
        self.input_layer = _Layers(*_conv_block(1 + latent_dim, ic), *_conv_block(ic, ic),
                                   *_conv_block(ic, ic, stride=2))
        skips, ch = [ic], ic
        self.down_layers = nn.ModuleList()
        for c in down_channels:
            self.down_layers.append(_Layers(*dense_block(ch, c), *_conv_block(c, c, stride=2)))
            skips.append(c)
            ch = c
        self.middle_layers = _Layers(*dense_block(ch, middle_channels))
        ch = middle_channels
        self.up_layers = nn.ModuleList()
        for i, c in enumerate(up_channels):
            self.up_layers.append(_Layers(*dense_block(ch + skips[-1 - i], c), ConvTranspose3d(c, c),
                                          InstanceNorm(c), LeakyReLU()))
            ch = c
        oc = output_conv_channel
        self.output_layer = _Layers(*_conv_block(ch, oc), *_conv_block(oc, oc), Conv3d(oc, 1, 3))

    def forward(self, x: torch.Tensor, latent: torch.Tensor) -> torch.Tensor:
        """(N, D, H, W, 1) T1 and (N, latent_dim) latent -> (N, D, H, W, 1) synthesized PET in [-1, 1].
        Each of D, H, W must be a multiple of 2^(levels + 1): every stride-2 conv halves it
        (rounding up) and every transposed conv doubles it back."""
        cell = 2 ** (len(self.down_layers) + 1)
        if any(n % cell for n in x.shape[1:-1]):
            raise ValueError(f"volume {tuple(x.shape[1:-1])}: each axis must be a multiple of {cell}")
        h = x.movedim(-1, 1).to(self.dtype)
        lat = latent.to(self.dtype)[:, :, None, None, None].expand(-1, -1, *h.shape[2:])
        h = self.input_layer(torch.cat([h, lat], dim=1))
        skips = [h]
        for layer in self.down_layers:
            h = self._dense_then_rest(layer, h)
            skips.append(h)
        h = self._dense_then_rest(self.middle_layers, h)
        for i, layer in enumerate(self.up_layers):
            h = self._dense_then_rest(layer, torch.cat([h, skips[-1 - i]], dim=1))
        return torch.tanh(self.output_layer(h)).movedim(1, -1)

    def _dense_then_rest(self, layer: nn.Sequential, h: torch.Tensor) -> torch.Tensor:
        """A level's Sequential: its dense block (the first eight slots), recomputed
        in the backward with ``remat``, then the rest (the resampling conv and its norm)."""
        if not (self.remat and torch.is_grad_enabled()):
            return layer(h)
        return layer[8:](torch.utils.checkpoint.checkpoint(layer[:8], h, use_reentrant=False))


class ResNetEncoder(nn.Module):
    """PET -> the latent Gaussian's (mu, log_var), each ``latent_dim`` wide. The
    linear heads are sized from ``input_shape``, the input's (D, H, W): each
    stride-2 unit takes every axis to ceil(n / 2)."""

    def __init__(
        self,
        input_layer_channel: int = 32,
        channels: Sequence[int] = (64, 128, 128, 128, 128, 128),
        latent_dim: int = LATENT_DIM,
        input_shape: Sequence[int] = VOLUME_SHAPE,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.input_layer = nn.Sequential(Conv3d(1, input_layer_channel, 3), InstanceNorm(input_layer_channel),
                                         nn.ReLU())
        self.resblocks = nn.Sequential()
        ch = input_layer_channel
        for c in channels:
            self.resblocks.append(ResidualUnit(ch, c, stride=2, subunits=2, act="prelu"))
            ch = c
        spatial = list(input_shape)
        for _ in channels:
            spatial = [-(-s // 2) for s in spatial]
        features = ch * math.prod(spatial)
        self.linear1 = Linear(features, latent_dim)
        self.linear2 = Linear(features, latent_dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, D, H, W, 1) -> (mu, log_var), each (N, latent_dim)."""
        h = self.resblocks(self.input_layer(x.movedim(-1, 1).to(self.dtype))).flatten(1)
        return self.linear1(h), self.linear2(h)


class BMGANDiscriminator(nn.Module):
    """PatchDiscriminator(3, 32, 1, num_layers_d=4) under ``patch_d``; returns the
    channels-last patch-logit map only. At num_layers_d 4 it needs at least 48
    voxels an axis (the port's PatchDiscriminator raises for an empty map)."""

    def __init__(self, num_channels: int = 32, num_layers_d: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_d = PatchDiscriminator(spatial_dims=3, num_channels=num_channels, in_channels=1,
                                          num_layers_d=num_layers_d, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.patch_d(x)[-1]


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """LeCun-normal conv, transposed-conv and dense kernels (fan-in: the input
    channels times the kernel volume), zero biases, unit norm scales, PReLU
    slopes 0.25, drawn from ``generator`` in module order."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv3d, nn.ConvTranspose3d, nn.Linear)):
                w = mod.weight
                fan_in = w.shape[0] * w[0, 0].numel() if isinstance(mod, nn.ConvTranspose3d) else w[0].numel()
                w.copy_(torch.randn(w.shape, generator=generator) * fan_in**-0.5)
                mod.bias.zero_()
            elif isinstance(mod, nn.GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.PReLU):
                mod.weight.fill_(0.25)
