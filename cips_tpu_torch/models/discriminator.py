"""PatchDiscriminator — pix2pix-style 3-D PatchGAN (port of cips_tpu/models/discriminator.py).

``num_layers_d`` stride-2 k4 convs with doubling channels (up to 512),
InstanceNorm + LeakyReLU(0.2) after all but the first, then a stride-1 conv
with norm and a 1-channel patch-logit head. ``forward`` takes channels-last
(N, *S, C) volumes like the JAX model and returns the list of feature maps,
channels-last, with the logits last.

InstanceNorm is one group per channel of the port's GroupNorm: fp32
statistics, var = E[x^2] - E[x]^2 clamped at 0, and the per-(sample, channel)
scale and offset applied as one ``x * w + off`` in the activation dtype, with
the LeakyReLU(0.2) that follows it in the same call (`ops.group_norm`: fused
kernels on the card). The JAX package's hand-written VJP of it is an XLA
fusion device; the port's kernels' backward computes the same function.

Over a ``space`` group (`parallel.spatial.sharded`) the volume comes as
depth slabs and every map stays one: the convs exchange halo planes, the
stride-1 ones' outputs parting unevenly (12 -> 11 -> 10 planes at the full
volume's depth 96; a rank may hold none), the norms reduce over the group, and
the empty-map check judges the global depth, which ``forward`` carries.

The ``state_dict`` holds conv_0, then the conv_i / norm_i pairs, then the
penultimate conv and norm, then conv_out, every conv with a bias: the order
`cips_tpu/data/torch_import.py:import_patch_discriminator` maps by.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cips_tpu_torch.models.blocks import Conv, GroupNorm
from cips_tpu_torch.parallel.spatial import SpaceGroup, conv_output_size


class InstanceNorm(GroupNorm):
    """Per-(sample, channel) normalisation with an affine (C,) scale and bias."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(channels, channels, eps)


class PatchDiscriminator(nn.Module):
    space: Optional[SpaceGroup] = None

    def __init__(
        self,
        spatial_dims: int = 3,
        num_channels: int = 64,
        in_channels: int = 1,
        out_channels: int = 1,
        num_layers_d: int = 3,
        kernel_size: int = 4,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.num_layers_d = num_layers_d
        self.kernel_size = kernel_size
        k = kernel_size
        self.conv_0 = Conv(spatial_dims, in_channels, num_channels, k, stride=2)
        ch = num_channels
        for i in range(1, num_layers_d):
            prev, ch = ch, min(ch * 2, 512)
            setattr(self, f"conv_{i}", Conv(spatial_dims, prev, ch, k, stride=2))
            setattr(self, f"norm_{i}", InstanceNorm(ch))
        prev, ch = ch, min(ch * 2, 512)
        self.conv_penultimate = Conv(spatial_dims, prev, ch, k, stride=1)
        self.norm_penultimate = InstanceNorm(ch)
        self.conv_out = Conv(spatial_dims, ch, out_channels, k, stride=1)

    def _conv(self, name: str, h: torch.Tensor, depth: int) -> Tuple[torch.Tensor, int]:
        """The conv ``name`` of ``h`` (global depth ``depth``) and its output's global depth."""
        conv = getattr(self, name)
        if any(n + 2 * p < self.kernel_size for n, p in zip((depth, *h.shape[3:]), conv.conv.padding)):
            # an empty patch map would flow into a mean() and surface as a NaN
            # loss; the JAX model computes it and raises at the logits, torch's
            # conv would refuse it with a less telling error
            raise ValueError(
                f"empty patch-logit map: input too small for num_layers_d={self.num_layers_d} "
                f"(k={self.kernel_size}), {(depth, *h.shape[3:])} before {name}"
            )
        c = conv.conv
        out = conv(h, depth) if self.space is not None else conv(h)
        return out, conv_output_size(depth, self.kernel_size, c.stride[0], c.padding[0])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(N, *S, C_in) -> [feature maps..., logits], each channels-last."""
        h = x.movedim(-1, 1).to(self.dtype)
        h, depth = self._conv("conv_0", h, h.shape[2] * (1 if self.space is None else self.space.size))
        h = F.leaky_relu(h, 0.2)
        features = [h]
        for i in range(1, self.num_layers_d):
            h, depth = self._conv(f"conv_{i}", h, depth)
            h = getattr(self, f"norm_{i}")(h, act="leaky_relu")
            features.append(h)
        h, depth = self._conv("conv_penultimate", h, depth)
        h = self.norm_penultimate(h, act="leaky_relu")
        features.append(h)
        features.append(self._conv("conv_out", h, depth)[0])
        return [f.movedim(1, -1) for f in features]
