"""AttenUNet — the T1->PET conditional generator (port of cips_tpu/models/atten_unet.py).

The unpacked model: a 3-D UNet whose attention levels cross-attend from the
flattened voxel tokens to the covariate row. Constructor keywords follow the
reference's JSON config schema (``configs/training.json:atten_unet_def``);
``upcast_attention`` is accepted for that schema and changes nothing, because
attention scores are always fp32 here (see ``ops/attention.py``).
``forward`` takes and returns channels-last (N, D, H, W, C) volumes, like
the JAX model; inside, the layout is NCDHW.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from cips_tpu_torch.models.blocks import (
    Conv,
    DownBlock,
    GroupNorm,
    LayerNorm,
    Linear,
    MidBlock,
    UpBlock,
    attention_mode,
)


def _tuplify(v, n: int) -> Tuple:
    if isinstance(v, (int, float, bool)):
        return (v,) * n
    return tuple(v)


class AttenUNet(nn.Module):
    def __init__(
        self,
        spatial_dims: int = 3,
        in_channels: int = 1,
        out_channels: int = 1,
        num_res_blocks: Union[Sequence[int], int] = (2, 2, 2, 2),
        num_channels: Sequence[int] = (32, 64, 64, 64),
        attention_levels: Sequence[bool] = (False, False, True, True),
        norm_num_groups: int = 32,
        norm_eps: float = 1e-6,
        resblock_updown: bool = False,
        num_head_channels: Union[Sequence[int], int] = 8,
        with_conditioning: bool = False,
        transformer_num_layers: int = 1,
        cross_attention_dim: Optional[int] = None,
        upcast_attention: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        n = len(num_channels)
        if with_conditioning and cross_attention_dim is None:
            raise ValueError("with_conditioning=True requires cross_attention_dim")
        if cross_attention_dim is not None and not with_conditioning:
            raise ValueError("cross_attention_dim requires with_conditioning=True")
        if any(c % norm_num_groups for c in num_channels):
            raise ValueError("all num_channels must be multiples of norm_num_groups")
        if len(attention_levels) != n:
            raise ValueError("attention_levels must match num_channels length")
        self.dtype = dtype
        self.with_conditioning = with_conditioning
        res_blocks = _tuplify(num_res_blocks, n)
        head_channels = _tuplify(num_head_channels, n)
        self._up_takes = [res_blocks[n - 1 - i] + 1 for i in range(n)]
        common = dict(
            norm_num_groups=norm_num_groups, norm_eps=norm_eps,
            transformer_num_layers=transformer_num_layers, cross_attention_dim=cross_attention_dim,
        )

        self.conv_in = Conv(spatial_dims, in_channels, num_channels[0], 3)
        # channel counts of the skip residuals, in the order forward() collects them
        skips = [num_channels[0]]
        prev = num_channels[0]
        self.down_blocks = nn.ModuleList()
        for i in range(n):
            is_final = i == n - 1
            self.down_blocks.append(DownBlock(
                spatial_dims, prev, num_channels[i], num_res_blocks=res_blocks[i],
                add_downsample=not is_final, resblock_updown=resblock_updown,
                attention_mode=attention_mode(attention_levels[i], with_conditioning),
                num_head_channels=head_channels[i], **common,
            ))
            skips += [num_channels[i]] * (res_blocks[i] + (0 if is_final else 1))
            prev = num_channels[i]

        self.middle_block = MidBlock(
            spatial_dims, num_channels[-1], with_conditioning=with_conditioning,
            num_head_channels=head_channels[-1], **common,
        )

        self.up_blocks = nn.ModuleList()
        for i in range(n):
            level = n - 1 - i
            take = self._up_takes[i]
            popped = skips[-take:][::-1]
            skips = skips[:-take]
            self.up_blocks.append(UpBlock(
                spatial_dims, prev, popped, num_channels[level],
                add_upsample=i != n - 1, resblock_updown=resblock_updown,
                attention_mode=attention_mode(attention_levels[level], with_conditioning),
                num_head_channels=head_channels[level], **common,
            ))
            prev = num_channels[level]

        self.out = nn.Sequential(
            GroupNorm(norm_num_groups, num_channels[0], norm_eps),
            nn.SiLU(),
            Conv(spatial_dims, num_channels[0], out_channels, 3, zero_init=True),
        )

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(N, *S, C_in) channels-last volume and (B, 1, K) context -> (N, *S, C_out)."""
        if context is not None and not self.with_conditioning:
            raise ValueError("context requires with_conditioning=True")
        h = x.movedim(-1, 1).to(self.dtype)
        if context is not None:
            context = context.to(self.dtype)
        h = self.conv_in(h)
        residuals = [h]
        for block in self.down_blocks:
            h, outs = block(h, context)
            residuals.extend(outs)
        h = self.middle_block(h, context)
        for block, take in zip(self.up_blocks, self._up_takes):
            skips, residuals = residuals[-take:], residuals[:-take]
            h = block(h, skips, context)
        return self.out(h).movedim(1, -1)


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter from ``generator``, as the JAX model initialises:
    LeCun-normal conv and dense kernels, zero biases, zero output convs
    (``Conv.zero_init``), unit norm scales."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Conv):
                w, b = mod.conv.weight, mod.conv.bias
                fan_in = w[0].numel()
            elif isinstance(mod, Linear):
                w, b = mod.weight, mod.bias
                fan_in = w.shape[1]
            elif isinstance(mod, (GroupNorm, LayerNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                continue
            else:
                continue
            if getattr(mod, "zero_init", False):
                w.zero_()
            else:
                std = fan_in**-0.5
                w.copy_(torch.randn(w.shape, generator=generator) * std)
            if b is not None:
                b.zero_()
