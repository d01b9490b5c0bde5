"""The KL-VAE's standalone Decoder, the causal generator's T1 decoder (port of
cips_tpu/models/autoencoder_kl.py:Decoder).

A latent stem, an optional non-local block (resnet, self-attention, resnet),
then per level, coarse to fine (``num_channels`` reversed), resnets and a
nearest x2 upsampling with a conv between levels, then GN, SiLU and
``conv_out``. The unpacked model. ``forward`` takes and returns channels-last
volumes.

Parameter names are MONAI-generative's flat ``blocks`` list, the names that
`import_vae_decoder` reads: ``blocks.{k}`` in construction order (conv_in,
[mid resnet, attention, resnet], each level's resnets and its upsampler, the
final GroupNorm, conv_out); resnets keep their skip conv as ``nin_shortcut``.
The VAE's ``Encoder`` and ``AutoencoderKL`` are not ported: no CLI reaches them.

Over a ``space`` group (`parallel.spatial.sharded`) it takes a depth slab of a
latent of global depth ``depth`` (by default equal slabs) and returns this
rank's slab of the output; the non-local block's self-attention gathers K and V.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from cips_tpu_torch.models.blocks import AttentionBlock, Conv, GroupNorm, ResnetBlock, Upsample, output_depth
from cips_tpu_torch.models.encoder import tuplify
from cips_tpu_torch.parallel import spatial


class Decoder(nn.Module):
    space: Optional[spatial.SpaceGroup] = None

    def __init__(
        self,
        spatial_dims: int = 3,
        in_channels: int = 3,
        out_channels: int = 1,
        num_channels: Sequence[int] = (32, 64, 64),
        num_res_blocks: Union[Sequence[int], int] = 2,
        norm_num_groups: int = 32,
        norm_eps: float = 1e-6,
        attention_levels: Optional[Sequence[bool]] = None,
        with_encoder_nonlocal_attn: bool = False,
        with_decoder_nonlocal_attn: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        """``attention_levels`` and ``with_encoder_nonlocal_attn`` are taken for
        the reference config's schema and change nothing here, as in the JAX model."""
        super().__init__()
        n = len(num_channels)
        self.dtype = dtype
        channels = list(reversed(num_channels))
        res_blocks = list(reversed(tuplify(num_res_blocks, n)))
        norm = dict(norm_num_groups=norm_num_groups, norm_eps=norm_eps, skip_name="nin_shortcut")
        blocks = [Conv(spatial_dims, in_channels, channels[0], 3)]
        if with_decoder_nonlocal_attn:
            blocks += [
                ResnetBlock(spatial_dims, channels[0], **norm),
                AttentionBlock(spatial_dims, channels[0], norm_num_groups=norm_num_groups, norm_eps=norm_eps),
                ResnetBlock(spatial_dims, channels[0], **norm),
            ]
        prev = channels[0]
        for i in range(n):
            for _ in range(res_blocks[i]):
                blocks.append(ResnetBlock(spatial_dims, prev, channels[i], **norm))
                prev = channels[i]
            if i != n - 1:
                blocks.append(Upsample(spatial_dims, prev, use_conv=True, out_channels=channels[i]))
        blocks += [GroupNorm(norm_num_groups, prev, norm_eps), Conv(spatial_dims, prev, out_channels, 3)]
        self.blocks = nn.ModuleList(blocks)

    def forward(self, z: torch.Tensor, depth: Optional[int] = None) -> torch.Tensor:
        """(N, *S, C_latent) channels-last latent -> (N, *S * 2^(levels-1), out_channels)."""
        h = z.movedim(-1, 1).to(self.dtype)
        depth = None if self.space is None else spatial.depth_of(h, self.space, depth)
        *body, norm, conv_out = self.blocks
        for block in body:
            h = block(h, depth)
            depth = output_depth(block, depth)
        return conv_out(F.silu(norm(h)), depth).movedim(1, -1)
