"""DiffusionModelDecoder — the covariate-conditioned latent-to-PET decoder of the
causal generator (port of cips_tpu/models/decoder.py).

conv_in, then the conditioned mid block (resnet, cross-attention transformer,
resnet), then per level, coarse to fine, resnets each followed by a spatial
transformer where the level attends (and the model is conditioned), with an
upsampler between levels, then GN, SiLU and the zero-initialised
``conv_out``. ``len(num_channels) - 1`` upsamplings: a 3-level decoder scales
x4, composing with the 3-level spatial encoder. The unpacked model;
``forward`` takes and returns channels-last volumes.

Parameter names are the AttenUNet family's, which `import_diffusion_decoder`
reads: ``conv_in``, ``middle_block.*``, ``up_blocks.I.{resnets,attentions,upsampler}``,
``out.0`` (GroupNorm) and ``out.2`` (conv).

Over a ``space`` group (`parallel.spatial.sharded`) it takes a depth slab of
a latent of global depth ``depth`` (by default equal slabs) and returns this
rank's slab of the output: the self-attentions gather K and V, and the
cross-attention to the covariate row, which every rank holds whole, stays local.

``remat`` recomputes the resnets (the mid block's two included) in the
backward, as the JAX model's does; the transformers stay outside remat
(`blocks.set_remat`; ``remat_policy`` takes JAX's names). Off by default.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from cips_tpu_torch.models.blocks import (
    Conv,
    GroupNorm,
    MidBlock,
    ResnetBlock,
    SpatialTransformer,
    Upsample,
    heads_for,
    output_depth,
    set_remat,
)
from cips_tpu_torch.models.encoder import tuplify
from cips_tpu_torch.parallel import spatial


class DecoderLevel(nn.Module):
    """One level: resnets, each followed by its transformer where the level has one, then the upsampler."""

    def __init__(self, resnets: Sequence[nn.Module], attentions: Sequence[nn.Module], upsampler: Optional[nn.Module]):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        self.upsampler = upsampler

    def output_depth(self, depth: int) -> int:
        return depth if self.upsampler is None else output_depth(self.upsampler, depth)

    def forward(self, h: torch.Tensor, context: Optional[torch.Tensor], depth: Optional[int] = None) -> torch.Tensor:
        for i, resnet in enumerate(self.resnets):
            h = resnet(h, depth)
            if self.attentions:
                h = self.attentions[i](h, context=context, depth=depth)
        return h if self.upsampler is None else self.upsampler(h, depth)


class DiffusionModelDecoder(nn.Module):
    space: Optional[spatial.SpaceGroup] = None

    def __init__(
        self,
        spatial_dims: int = 3,
        in_channels: int = 3,
        out_channels: int = 1,
        num_res_blocks: Union[Sequence[int], int] = 2,
        num_channels: Sequence[int] = (64, 64, 32),
        attention_levels: Sequence[bool] = (True, False, False),
        norm_num_groups: int = 32,
        norm_eps: float = 1e-6,
        resblock_updown: bool = False,
        num_head_channels: Union[Sequence[int], int] = 32,
        with_conditioning: bool = True,
        transformer_num_layers: int = 1,
        cross_attention_dim: Optional[int] = None,
        upcast_attention: bool = False,
        remat: bool = False,
        remat_policy: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
    ):
        """``upcast_attention`` is taken for the config's schema: attention scores
        are always fp32 here (``ops/attention.py``)."""
        super().__init__()
        n = len(num_channels)
        self.dtype = dtype
        self.with_conditioning = with_conditioning
        res_blocks = tuplify(num_res_blocks, n)
        head_channels = tuplify(num_head_channels, n)
        norm = dict(norm_num_groups=norm_num_groups, norm_eps=norm_eps)
        self.conv_in = Conv(spatial_dims, in_channels, num_channels[0], 3)
        self.middle_block = MidBlock(
            spatial_dims, num_channels[0], with_conditioning=with_conditioning, num_head_channels=head_channels[0],
            transformer_num_layers=transformer_num_layers, cross_attention_dim=cross_attention_dim, **norm,
        )
        self.up_blocks = nn.ModuleList()
        prev = num_channels[0]
        for i in range(n):
            c = num_channels[i]
            resnets = [ResnetBlock(spatial_dims, prev if j == 0 else c, c, **norm) for j in range(res_blocks[i])]
            attentions = []
            if attention_levels[i] and with_conditioning:
                n_heads, head_dim = heads_for(c, head_channels[i])
                attentions = [
                    SpatialTransformer(spatial_dims, c, n_heads, head_dim, num_layers=transformer_num_layers,
                                       cross_attention_dim=cross_attention_dim, **norm)
                    for _ in range(res_blocks[i])
                ]
            upsampler = None
            if i != n - 1:
                upsampler = (ResnetBlock(spatial_dims, c, c, up=True, **norm) if resblock_updown
                             else Upsample(spatial_dims, c, use_conv=True, out_channels=c))
            self.up_blocks.append(DecoderLevel(resnets, attentions, upsampler))
            prev = c
        self.out = nn.Sequential(
            GroupNorm(norm_num_groups, prev, norm_eps), nn.SiLU(),
            Conv(spatial_dims, prev, out_channels, 3, zero_init=True),
        )
        if remat:
            set_remat(self, (ResnetBlock,), remat_policy)

    def forward(self, z: torch.Tensor, context: Optional[torch.Tensor] = None,
                depth: Optional[int] = None) -> torch.Tensor:
        """(N, *S, C_latent) channels-last latent and (N, 1, K) context -> (N, *S', out_channels)."""
        if context is not None and not self.with_conditioning:
            raise ValueError("context requires with_conditioning=True")
        h = z.movedim(-1, 1).to(self.dtype)
        depth = None if self.space is None else spatial.depth_of(h, self.space, depth)
        if context is not None:
            context = context.to(self.dtype)
        h = self.middle_block(self.conv_in(h, depth), context, depth)
        for level in self.up_blocks:
            h = level(h, context, depth)
            depth = output_depth(level, depth)
        norm, _, conv_out = self.out  # the SiLU slot (out.1) runs inside the norm's call
        return conv_out(norm(h, act="silu"), depth).movedim(1, -1)
