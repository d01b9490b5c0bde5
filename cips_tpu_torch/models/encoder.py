"""DiffusionModelEncoder — the attention encoder of the causal generator and the
MCI classifier (port of cips_tpu/models/encoder.py).

Two heads:

  * ``head="spatial"``: the causal generator's T1 encoder. The last level
    does not downsample, then GN, SiLU and ``conv_out`` emit a 2z-channel map
    that the caller splits into (z_mu, z_sigma); a 3-level encoder gives a
    1/4-resolution latent that composes with the 3-level decoders.
  * ``head="mlp"``: the classifier. Every level downsamples, then the
    features are flattened and go through Linear, ReLU, Dropout, Linear. The
    flatten is sized from ``input_shape``, the spatial shape of the input.

The unpacked model; the reference's dead timestep path is not ported. Without
a context, a cross-attention level's ``attn2`` attends to its own tokens, as
in the JAX package; build it with ``cross_attention_dim=None`` then, so that
its keys and values are projected from the tokens' width (the shapes flax
infers when the encoder is initialised without a context). ``forward`` takes
and returns channels-last volumes, as the JAX model does. Over a ``space``
group (`parallel.spatial.sharded`, the spatial head only) it takes an equal
depth slab and returns this rank's slab of the latent, whose global depth is
`output_depth`'s; every self-attention, both of a level's transformer
attentions here, gathers K and V.

Parameter names are the reference's torch ``state_dict`` names that
`import_diffusion_encoder` reads (``conv_in``, ``down_blocks.I.*``, the mlp
head's ``out.0`` and ``out.3``); the spatial head, which that importer does
not read, is ``out_norm`` and ``conv_out``.

``remat`` recomputes the resnets and downsamplers in the backward, as the JAX
model's does; its attentions stay outside remat, so no flash forward runs
twice (`blocks.set_remat`; ``remat_policy`` takes JAX's names). Off by default.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
from torch import nn

from cips_tpu_torch.models.blocks import (
    Conv,
    Downsample,
    DownBlock,
    GroupNorm,
    Linear,
    ResnetBlock,
    attention_mode,
    output_depth,
    set_remat,
)
from cips_tpu_torch.parallel.spatial import SpaceGroup


def tuplify(v, n: int) -> tuple:
    """A scalar repeated ``n`` times, or the sequence as a tuple."""
    if isinstance(v, (int, float, bool)):
        return (v,) * n
    return tuple(v)


class DiffusionModelEncoder(nn.Module):
    space: Optional[SpaceGroup] = None

    def __init__(
        self,
        spatial_dims: int = 3,
        in_channels: int = 1,
        out_channels: int = 2,
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
        head: str = "mlp",
        head_hidden: int = 512,
        head_dropout: float = 0.1,
        input_shape: Optional[Sequence[int]] = None,
        remat: bool = False,
        remat_policy: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if head not in ("mlp", "spatial"):
            raise ValueError(f"head must be 'mlp' or 'spatial', got {head!r}")
        n = len(num_channels)
        self.dtype = dtype
        self.head = head
        self.with_conditioning = with_conditioning
        res_blocks = tuplify(num_res_blocks, n)
        head_channels = tuplify(num_head_channels, n)
        self.conv_in = Conv(spatial_dims, in_channels, num_channels[0], 3)
        self.down_blocks = nn.ModuleList()
        prev = num_channels[0]
        for i in range(n):
            self.down_blocks.append(DownBlock(
                spatial_dims, prev, num_channels[i], num_res_blocks=res_blocks[i],
                norm_num_groups=norm_num_groups, norm_eps=norm_eps,
                add_downsample=head == "mlp" or i != n - 1, resblock_updown=resblock_updown,
                attention_mode=attention_mode(attention_levels[i], with_conditioning),
                num_head_channels=head_channels[i], transformer_num_layers=transformer_num_layers,
                cross_attention_dim=cross_attention_dim,
            ))
            prev = num_channels[i]
        if remat:
            set_remat(self, (ResnetBlock, Downsample), remat_policy)
        if head == "spatial":
            self.out_norm = GroupNorm(norm_num_groups, prev, norm_eps)
            self.conv_out = Conv(spatial_dims, prev, out_channels, 3)
            return
        if input_shape is None:
            raise ValueError("head='mlp' needs input_shape, the spatial shape of the input, to size its flatten")
        # each level halves every axis: avg-pool resnets floor, stride-2 convs (padding 1) round up
        spatial = list(input_shape)
        for _ in range(n):
            spatial = [s // 2 if resblock_updown else (s + 1) // 2 for s in spatial]
        self.out = nn.Sequential(
            Linear(prev * math.prod(spatial), head_hidden), nn.ReLU(), nn.Dropout(head_dropout),
            Linear(head_hidden, out_channels),
        )

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(N, *S, C_in) channels-last volume [and (N, 1, K) context] -> the
        (N, *S', out_channels) latent map (spatial head) or (N, out_channels)
        logits (mlp head; dropout follows ``self.training``)."""
        if context is not None and not self.with_conditioning:
            raise ValueError("context requires with_conditioning=True")
        h = x.movedim(-1, 1).to(self.dtype)
        depth = None if self.space is None else h.shape[2] * self.space.size
        if context is not None:
            context = context.to(self.dtype)
        h = self.conv_in(h, depth)
        for block in self.down_blocks:
            h, _ = block(h, context, depth)
            depth = output_depth(block, depth)
        if self.head == "spatial":
            return self.conv_out(self.out_norm(h, act="silu"), depth).movedim(1, -1)
        return self.out(h.flatten(1))

    def output_depth(self, depth: int) -> int:
        """The latent's depth for an input of depth ``depth``."""
        for block in self.down_blocks:
            depth = output_depth(block, depth)
        return depth
