"""The KL-VAE: its standalone Decoder, the causal generator's T1 decoder, its
Encoder, and the whole AutoencoderKL (port of cips_tpu/models/autoencoder_kl.py).

Decoder: a latent stem, an optional non-local block (resnet, self-attention,
resnet), then per level, coarse to fine (``num_channels`` reversed), resnets
and a nearest x2 upsampling with a conv between levels, then GN, SiLU and
``conv_out``. Encoder: a stem, per level resnets and, between levels, a
stride-2 3x3 conv, an optional non-local block, then GN, SiLU and two 3x3
heads, ``conv_mu`` and ``conv_log_var``. AutoencoderKL: ``encode`` gives (mu,
sigma = exp(log_var / 2)), ``decode`` the volume, ``forward`` (reconstruction,
mu, sigma), decoding mu + sigma * eps with eps drawn from the caller's
``torch.Generator``, or mu itself without one. The unpacked models; ``forward``
takes and returns channels-last volumes.

Parameter names are MONAI-generative's flat ``blocks`` lists, the names that
`import_vae_decoder` reads: ``blocks.{k}`` in construction order (the
Decoder: conv_in, [mid resnet, attention, resnet], each level's resnets and
its upsampler, the final GroupNorm, conv_out; the Encoder: conv_in, each
level's resnets and its downsampler, [mid resnet, attention, resnet], the final
GroupNorm); resnets keep their skip conv as ``nin_shortcut``, resamplers their
conv as ``conv``. The Encoder's two heads have no MONAI counterpart of their
shape (MONAI's encoder ends in one conv and its AutoencoderKL adds 1x1
``quant_conv_mu`` / ``quant_conv_log_sigma``): they keep the JAX model's names,
``conv_mu`` and ``conv_log_var``. AutoencoderKL holds ``encoder.*`` and ``decoder.*``.

``remat`` recomputes the resnets in the backward, as the JAX Decoder's does
(`blocks.set_remat`; off by default).

Over a ``space`` group (`parallel.spatial.sharded`) the Decoder takes a depth
slab of a latent of global depth ``depth`` (by default equal slabs) and returns
this rank's slab of the output; the non-local block's self-attention gathers K and V.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from cips_tpu_torch.models.blocks import (
    AttentionBlock,
    Conv,
    GroupNorm,
    ResnetBlock,
    Upsample,
    output_depth,
    set_remat,
)
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
        remat: bool = False,
        remat_policy: Optional[str] = None,
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
            blocks += _nonlocal_block(spatial_dims, channels[0], norm_num_groups, norm_eps)
        prev = channels[0]
        for i in range(n):
            for _ in range(res_blocks[i]):
                blocks.append(ResnetBlock(spatial_dims, prev, channels[i], **norm))
                prev = channels[i]
            if i != n - 1:
                blocks.append(Upsample(spatial_dims, prev, use_conv=True, out_channels=channels[i]))
        blocks += [GroupNorm(norm_num_groups, prev, norm_eps), Conv(spatial_dims, prev, out_channels, 3)]
        self.blocks = nn.ModuleList(blocks)
        if remat:
            set_remat(self, (ResnetBlock,), remat_policy)

    def forward(self, z: torch.Tensor, depth: Optional[int] = None) -> torch.Tensor:
        """(N, *S, C_latent) channels-last latent -> (N, *S * 2^(levels-1), out_channels)."""
        h = z.movedim(-1, 1).to(self.dtype)
        depth = None if self.space is None else spatial.depth_of(h, self.space, depth)
        *body, norm, conv_out = self.blocks
        for block in body:
            h = block(h, depth)
            depth = output_depth(block, depth)
        return conv_out(norm(h, act="silu"), depth).movedim(1, -1)


def _nonlocal_block(spatial_dims: int, channels: int, norm_num_groups: int, norm_eps: float) -> list:
    """MONAI-generative's non-local block: resnet, self-attention, resnet."""
    norm = dict(norm_num_groups=norm_num_groups, norm_eps=norm_eps, skip_name="nin_shortcut")
    return [ResnetBlock(spatial_dims, channels, **norm),
            AttentionBlock(spatial_dims, channels, norm_num_groups=norm_num_groups, norm_eps=norm_eps),
            ResnetBlock(spatial_dims, channels, **norm)]


class _Downsample(nn.Module):
    """A stride-2 3x3 conv (padding 1), MONAI's ``Downsample`` naming (``conv.conv.*``)."""

    def __init__(self, spatial_dims: int, channels: int):
        super().__init__()
        self.conv = Conv(spatial_dims, channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Encoder(nn.Module):
    """VAE encoder: stem -> per-level resnets + stride-2 downsample -> (mu, log_var)."""

    def __init__(
        self,
        spatial_dims: int = 3,
        in_channels: int = 1,
        latent_channels: int = 3,
        num_channels: Sequence[int] = (32, 64, 64),
        num_res_blocks: Union[Sequence[int], int] = 2,
        norm_num_groups: int = 32,
        norm_eps: float = 1e-6,
        with_nonlocal_attn: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        n = len(num_channels)
        self.dtype = dtype
        res_blocks = tuplify(num_res_blocks, n)
        norm = dict(norm_num_groups=norm_num_groups, norm_eps=norm_eps, skip_name="nin_shortcut")
        blocks = [Conv(spatial_dims, in_channels, num_channels[0], 3)]
        prev = num_channels[0]
        for i in range(n):
            for _ in range(res_blocks[i]):
                blocks.append(ResnetBlock(spatial_dims, prev, num_channels[i], **norm))
                prev = num_channels[i]
            if i != n - 1:
                blocks.append(_Downsample(spatial_dims, prev))
        if with_nonlocal_attn:
            blocks += _nonlocal_block(spatial_dims, prev, norm_num_groups, norm_eps)
        blocks.append(GroupNorm(norm_num_groups, prev, norm_eps))
        self.blocks = nn.ModuleList(blocks)
        self.conv_mu = Conv(spatial_dims, prev, latent_channels, 3)
        self.conv_log_var = Conv(spatial_dims, prev, latent_channels, 3)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, *S, C_in) channels-last -> (mu, log_var), each (N, *S / 2^(levels-1), latent_channels)."""
        h = x.movedim(-1, 1).to(self.dtype)
        *body, norm = self.blocks
        for block in body:
            h = block(h)
        h = norm(h, act="silu")
        return self.conv_mu(h).movedim(1, -1), self.conv_log_var(h).movedim(1, -1)


class AutoencoderKL(nn.Module):
    """The whole KL-VAE; ``forward`` returns (reconstruction, z_mu, z_sigma)."""

    def __init__(
        self,
        spatial_dims: int = 3,
        in_channels: int = 1,
        out_channels: int = 1,
        latent_channels: int = 3,
        num_channels: Sequence[int] = (32, 64, 64),
        num_res_blocks: Union[Sequence[int], int] = 2,
        norm_num_groups: int = 32,
        norm_eps: float = 1e-6,
        attention_levels: Optional[Sequence[bool]] = None,
        with_encoder_nonlocal_attn: bool = False,
        with_decoder_nonlocal_attn: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        common = dict(spatial_dims=spatial_dims, num_channels=num_channels, num_res_blocks=num_res_blocks,
                      norm_num_groups=norm_num_groups, norm_eps=norm_eps, dtype=dtype)
        self.encoder = Encoder(in_channels=in_channels, latent_channels=latent_channels,
                               with_nonlocal_attn=with_encoder_nonlocal_attn, **common)
        self.decoder = Decoder(in_channels=latent_channels, out_channels=out_channels,
                               with_decoder_nonlocal_attn=with_decoder_nonlocal_attn, **common)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu, sigma) of the latent of ``x``."""
        mu, log_var = self.encoder(x)
        return mu, torch.exp(0.5 * log_var)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(reconstruction, mu, sigma): the decode of mu + sigma * eps, eps a
        standard normal draw from ``generator`` (on the latent's device), or of
        mu without one."""
        mu, sigma = self.encode(x)
        z = mu
        if generator is not None:
            eps = torch.randn(sigma.shape, generator=generator, device=sigma.device, dtype=torch.float32)
            z = mu + sigma * eps.to(sigma.dtype)
        return self.decode(z), mu, sigma
