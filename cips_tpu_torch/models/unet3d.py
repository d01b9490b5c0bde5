"""UnetGenerator3d, the legacy pix2pix-style recursive 3-D UNet (port of
cips_tpu/models/unet3d.py).

Nested skip-connection blocks: down = [LeakyReLU(0.2)] + Conv(k4, s2, p1)
[+ InstanceNorm]; up = ReLU, nearest x2 upsampling, Conv(k3) [+ InstanceNorm];
skip = channel concat; Tanh output. Instance norm stands for the reference's
BatchNorm, as in the JAX package. No CLI trains it (the reference keeps it as
the simple generator of its ``unet_def`` config). Parameter names are the flax
tree's, joined by dots (``model.submodule.downconv.weight``, ``...upnorm.weight``);
`unet3d_from_jax_params` carries a flax tree across. Channels-last in and out.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cips_tpu_torch.models.blocks import nearest_upsample_2x
from cips_tpu_torch.models.bmgan import Conv3d
from cips_tpu_torch.models.discriminator import InstanceNorm


class _SkipBlock(nn.Module):
    def __init__(self, outer_nc: int, inner_nc: int, depth: int, inner_channels: Sequence[int], in_nc: int,
                 outermost: bool = False):
        super().__init__()
        self.outermost, self.innermost = outermost, depth == 0
        self.downconv = Conv3d(in_nc, inner_nc, 4, stride=2)
        self.downconv.padding = (1, 1, 1)
        if not outermost and not self.innermost:
            self.downnorm = InstanceNorm(inner_nc)
        up_in = inner_nc
        if not self.innermost:
            self.submodule = _SkipBlock(inner_nc, inner_channels[0], depth - 1, inner_channels[1:], inner_nc)
            up_in = 2 * inner_nc  # the submodule's output concatenated with its input
        self.upconv = Conv3d(up_in, outer_nc, 3)
        if not outermost:
            self.upnorm = InstanceNorm(outer_nc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x if self.outermost else F.leaky_relu(x, 0.2)
        h = self.downconv(h)
        if hasattr(self, "downnorm"):
            h = self.downnorm(h)
        if not self.innermost:
            h = self.submodule(h)
        h = self.upconv(nearest_upsample_2x(F.relu(h)))
        if self.outermost:
            return torch.tanh(h)
        return torch.cat([self.upnorm(h), x], dim=1)


class UnetGenerator3d(nn.Module):
    def __init__(self, input_nc: int = 1, output_nc: int = 1, num_downs: int = 4, ngf: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        # the channel ladder, innermost at ngf * 8, widening toward the outside
        if num_downs >= 5:
            ladder = [ngf, ngf * 2, ngf * 4, ngf * 8] + [ngf * 8] * (num_downs - 5) + [ngf * 8]
        else:
            ladder = [ngf * 2, ngf * 4, ngf * 8][: num_downs - 1] + [ngf * 8]
        self.model = _SkipBlock(output_nc, ladder[0], num_downs - 1, ladder[1:], input_nc, outermost=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, D, H, W, input_nc) -> (N, D, H, W, output_nc) in [-1, 1]."""
        return self.model(x.movedim(-1, 1).to(self.dtype)).movedim(1, -1)
