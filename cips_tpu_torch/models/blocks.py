"""Building blocks of the AttenUNet family (port of cips_tpu/models/blocks.py).

The unpacked math only: the space-to-depth packing of the JAX package is a TPU
layout device whose results equal the plain function (docs/DESIGN.md §4), and
is not ported. Remat is: a `Remat` module whose ``remat`` is set (`set_remat`)
runs its forward under ``torch.utils.checkpoint`` and recomputes it, whole, in
the backward. JAX's save-policy names (``conv``, ``conv12``, ``conv2``,
``conv_all``; its `blocks.conv_save_policy`) are accepted and change nothing
here: PyTorch's checkpoint saves the block's inputs only. It trades one more
forward of each block for its activations and does not change the result.

Activations are NCDHW inside the model. Parameters are stored in fp32 and
cast to the activation's dtype where they are used, as flax's
``dtype=bf16, param_dtype=f32`` does; the model casts its inputs to the
compute dtype once. Parameter names are the reference's torch ``state_dict``
names (``conv1.conv.weight``, ``transformer_blocks.0.attn1.to_q.weight``, ...;
see cips_tpu/data/torch_import.py).

Depth-sharded training (the mesh's ``space`` axis): `Conv`, `GroupNorm`, the
resamplers, the resnets and the attentions carry a ``space`` group, None unless
a train step shards the volume (`parallel.spatial.sharded`). Then a conv
exchanges halo planes (`spatial.halo_conv`), a norm all-reduces its statistics,
a self-attention gathers K and V over the group, each rank's queries attending
to the whole volume's keys, and a 2x resampling gathers the planes its output
slab needs where they lie on a neighbour. Each block's ``depth`` is the global
depth of its input slab (by default that of equal slabs); a block's
`output_depth` is its output's, which the models carry from level to level.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from cips_tpu_torch.ops.attention import merge_heads, multi_head_attention, split_heads
from cips_tpu_torch.ops.group_norm import group_norm
from cips_tpu_torch.parallel import spatial

_CONV_FN = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_CLS = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}


REMAT_POLICIES = ("conv", "conv12", "conv2", "conv_all")  # the JAX package's save-policy names


class Remat:
    """Mixin for an ``nn.Module``: with ``remat`` set, a call under autograd runs
    the forward through ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``,
    which keeps the inputs and recomputes the forward in the backward. The
    recomputation repeats what the forward did in the same order on every rank,
    its collectives (halo and K/V exchanges over a space group) included."""

    remat: bool = False

    def __call__(self, *args, **kwargs):
        if self.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(super().__call__, *args, use_reentrant=False, **kwargs)
        return super().__call__(*args, **kwargs)


def check_remat_policy(policy: Optional[str]) -> None:
    """A ValueError unless ``policy`` is one of JAX's save-policy names or None."""
    if policy is not None and policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; expected one of {REMAT_POLICIES} or None")


def set_remat(model: nn.Module, kinds: Tuple[type, ...], policy: Optional[str] = None) -> None:
    """Sets ``remat`` on every submodule of ``model`` that is one of ``kinds``.
    ``policy`` (`check_remat_policy`) changes nothing: the whole block is recomputed."""
    check_remat_policy(policy)
    for module in model.modules():
        if isinstance(module, kinds):
            module.remat = True


def heads_for(channels: int, num_head_channels: Optional[int]) -> Tuple[int, int]:
    """(num_heads, head_dim); zero, non-dividing or oversized head widths give one head."""
    if not num_head_channels or num_head_channels <= 0 or num_head_channels > channels:
        return 1, channels
    if channels % num_head_channels:
        return 1, channels
    return channels // num_head_channels, num_head_channels


def nearest_upsample_2x(x: torch.Tensor, space: Optional[spatial.SpaceGroup] = None,
                        depth: Optional[int] = None) -> torch.Tensor:
    """Nearest-neighbour x2 upsampling over all spatial dims of (N, C, *S). Over
    ``space``, ``x`` is a depth slab of global depth ``depth`` and the result is
    this rank's slab of the output depth: output planes [a, b) repeat input
    planes [a // 2, (b + 1) // 2), which are gathered first (none move where the
    slabs line up)."""
    if space is not None:
        n = spatial.depth_of(x, space, depth)
        outs = [spatial.slab(2 * n, i, space.size) for i in range(space.size)]
        sources = [(a // 2, (b + 1) // 2 if b > a else a // 2) for a, b in outs]
        x = spatial.gather_ranges(x, space, 2, n, sources, "resample")
        (a, b), lo = outs[space.index], sources[space.index][0]
    for axis in range(2, x.ndim):
        x = x.repeat_interleave(2, dim=axis)
    if space is not None:
        x = x.narrow(2, a - 2 * lo if b > a else 0, b - a)
    return x


def avg_pool_2x(x: torch.Tensor, space: Optional[spatial.SpaceGroup] = None,
                depth: Optional[int] = None) -> torch.Tensor:
    """2x VALID average pooling over all spatial dims of (N, C, *S), in any dtype.
    Over ``space``, ``x`` is a depth slab of global depth ``depth`` and the
    result is this rank's slab of depth // 2: output planes [a, b) pool input
    planes [2a, 2b), which are gathered first (a pair may straddle two ranks)."""
    if space is not None:
        n = spatial.depth_of(x, space, depth)
        outs = [spatial.slab(n // 2, i, space.size) for i in range(space.size)]
        x = spatial.gather_ranges(x, space, 2, n, [(2 * a, 2 * b) for a, b in outs], "resample")
    spatial_ = [s // 2 for s in x.shape[2:]]
    x = x[(slice(None), slice(None)) + tuple(slice(0, 2 * s) for s in spatial_)]
    windows = x.reshape(*x.shape[:2], *(d for s in spatial_ for d in (s, 2)))
    return windows.mean(dim=tuple(range(3, windows.ndim, 2)))


class GroupNorm(nn.GroupNorm):
    """Group norm with fp32 statistics, affine applied in the activation dtype,
    and the activation that follows it (``act``: None, ``"silu"`` or
    ``"leaky_relu"``) in the same call.

    The per-(sample, channel) scale and offset are formed in fp32 and rounded
    to the activation dtype before the one multiply-add, as the JAX package's
    GroupNorm does. An fp64 input (a reference run) keeps fp64 statistics.
    Over a ``space`` group the statistics are the whole volume's. A bf16 or
    fp32 CUDA input runs the fused kernels, anything on the CPU or in fp64 the
    plain version (`ops.group_norm`).
    """

    space: Optional[spatial.SpaceGroup] = None

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__(num_groups, num_channels, eps=eps)

    def forward(self, x: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, act, self.space)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in fp32 and cast back to the input dtype (flax eps 1e-6)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps).to(x.dtype)


class Linear(nn.Linear):
    """Dense layer with fp32 parameters applied in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class Conv(nn.Module):
    """'same' convolution, padding (k-1)//2; parameters at ``conv.weight`` / ``conv.bias``
    (MONAI ``Convolution(conv_only=True)`` naming). ``zero_init`` marks the
    reference's zero-initialised output convs. Over a ``space`` group the input
    is a depth slab of a volume of global depth ``depth`` (by default equal
    slabs) and the output this rank's slab of the conv's (`spatial.halo_conv`)."""

    space: Optional[spatial.SpaceGroup] = None

    def __init__(
        self, spatial_dims: int, in_channels: int, out_channels: int,
        kernel: int = 3, stride: int = 1, zero_init: bool = False,
    ):
        super().__init__()
        self.conv = _CONV_CLS[spatial_dims](
            in_channels, out_channels, kernel, stride=stride, padding=(kernel - 1) // 2
        )
        self.zero_init = zero_init

    def forward(self, x: torch.Tensor, depth: Optional[int] = None) -> torch.Tensor:
        c = self.conv
        if self.space is not None:
            return spatial.halo_conv(x, c.weight.to(x.dtype), c.bias.to(x.dtype), c.stride, c.padding, self.space,
                                     depth)
        return _CONV_FN[x.ndim - 2](
            x, c.weight.to(x.dtype), c.bias.to(x.dtype), stride=c.stride, padding=c.padding
        )


def output_depth(module: nn.Module, depth: Optional[int]) -> Optional[int]:
    """The depth of ``module``'s output for an input of depth ``depth`` (None: None)."""
    return depth if depth is None or not hasattr(module, "output_depth") else module.output_depth(depth)


def _depth(module: nn.Module, x: torch.Tensor, depth: Optional[int]) -> Optional[int]:
    """``x``'s global depth over the module's space group, None without one."""
    return None if module.space is None else spatial.depth_of(x, module.space, depth)


class Downsample(Remat, nn.Module):
    """Stride-2 conv (use_conv) or 2x average-pool downsampling."""

    space: Optional[spatial.SpaceGroup] = None

    def __init__(self, spatial_dims: int, in_channels: int, use_conv: bool, out_channels: Optional[int] = None):
        super().__init__()
        self.op = Conv(spatial_dims, in_channels, out_channels or in_channels, 3, 2) if use_conv else None

    def output_depth(self, depth: int) -> int:
        return depth // 2 if self.op is None else spatial.conv_output_size(depth, 3, 2, 1)

    def forward(self, x: torch.Tensor, depth: Optional[int] = None) -> torch.Tensor:
        return avg_pool_2x(x, self.space, depth) if self.op is None else self.op(x, depth)


class Upsample(nn.Module):
    """Nearest x2 upsampling with optional 3x3 conv."""

    space: Optional[spatial.SpaceGroup] = None

    def __init__(self, spatial_dims: int, in_channels: int, use_conv: bool, out_channels: Optional[int] = None):
        super().__init__()
        self.conv = Conv(spatial_dims, in_channels, out_channels or in_channels, 3) if use_conv else None

    def output_depth(self, depth: int) -> int:
        return 2 * depth

    def forward(self, x: torch.Tensor, depth: Optional[int] = None) -> torch.Tensor:
        depth = _depth(self, x, depth)
        x = nearest_upsample_2x(x, self.space, depth)
        return x if self.conv is None else self.conv(x, output_depth(self, depth))


class ResnetBlock(Remat, nn.Module):
    """GN -> SiLU -> (up/down) -> conv -> GN -> SiLU -> zero-conv, + skip.

    With ``up``/``down`` the 2x resample is applied to both the input and the
    normalised branch, after norm1/SiLU and before conv1. ``skip_name`` names
    the 1x1 skip conv: ``skip_connection`` in the AttenUNet family,
    ``nin_shortcut`` in MONAI-generative's AutoencoderKL.
    """

    space: Optional[spatial.SpaceGroup] = None

    def __init__(
        self, spatial_dims: int, in_channels: int, out_channels: Optional[int] = None,
        up: bool = False, down: bool = False, norm_num_groups: int = 32, norm_eps: float = 1e-6,
        skip_name: str = "skip_connection",
    ):
        super().__init__()
        out_channels = out_channels or in_channels
        self.up, self.down = up, down
        self.norm1 = GroupNorm(norm_num_groups, in_channels, norm_eps)
        self.conv1 = Conv(spatial_dims, in_channels, out_channels, 3)
        self.norm2 = GroupNorm(norm_num_groups, out_channels, norm_eps)
        self.conv2 = Conv(spatial_dims, out_channels, out_channels, 3, zero_init=True)
        self._skip_name = skip_name
        setattr(self, skip_name,
                Conv(spatial_dims, in_channels, out_channels, 1) if out_channels != in_channels else None)

    def output_depth(self, depth: int) -> int:
        return 2 * depth if self.up else depth // 2 if self.down else depth

    def forward(self, x: torch.Tensor, depth: Optional[int] = None) -> torch.Tensor:
        depth = _depth(self, x, depth)
        h = self.norm1(x, act="silu")
        if self.up:
            x, h = nearest_upsample_2x(x, self.space, depth), nearest_upsample_2x(h, self.space, depth)
        elif self.down:
            x, h = avg_pool_2x(x, self.space, depth), avg_pool_2x(h, self.space, depth)
        depth = output_depth(self, depth)
        h = self.conv1(h, depth)
        h = self.conv2(self.norm2(h, act="silu"), depth)
        skip = getattr(self, self._skip_name)
        if skip is not None:
            x = skip(x, depth)
        return x + h


class CrossAttention(nn.Module):
    """Multi-head (cross-)attention over tokens (B, L, C); self-attention without
    context. Over a ``space`` group the tokens are a depth slab's, ``planes``
    giving the volume's global depth and its tokens a plane, and self-attention
    gathers the whole volume's K and V (`gather_kv`)."""

    space: Optional[spatial.SpaceGroup] = None

    def __init__(
        self, query_dim: int, cross_attention_dim: Optional[int] = None,
        num_attention_heads: int = 8, num_head_channels: int = 64,
    ):
        super().__init__()
        inner_dim = num_head_channels * num_attention_heads
        context_dim = cross_attention_dim or query_dim
        self.num_heads = num_attention_heads
        self.scale = 1.0 / (num_head_channels**0.5)
        self.to_q = Linear(query_dim, inner_dim, bias=False)
        self.to_k = Linear(context_dim, inner_dim, bias=False)
        self.to_v = Linear(context_dim, inner_dim, bias=False)
        self.to_out = nn.Sequential(Linear(inner_dim, query_dim))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                planes: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        ctx = x if context is None else context
        if ctx.ndim == 2:
            ctx = ctx[:, None, :]
        q = split_heads(self.to_q(x), self.num_heads)
        k = split_heads(self.to_k(ctx), self.num_heads)
        v = split_heads(self.to_v(ctx), self.num_heads)
        if context is None and self.space is not None:
            k, v = gather_kv(k, v, self.space, planes)
        out = multi_head_attention(q, k, v, scale=self.scale, self_attention=context is None)
        return self.to_out(merge_heads(out))


class GEGLUFeedForward(nn.Module):
    """Linear -> (h, gate) -> h * gelu(gate) (exact erf) -> Linear."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.linear1 = Linear(dim, dim * mult * 2)
        self.linear2 = Linear(dim * mult, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.linear1(x).chunk(2, dim=-1)
        return self.linear2(h * F.gelu(gate, approximate="none"))


class BasicTransformerBlock(nn.Module):
    """Pre-LN self-attention -> cross-attention -> GEGLU MLP, each with a residual."""

    def __init__(
        self, num_channels: int, num_attention_heads: int, num_head_channels: int,
        cross_attention_dim: Optional[int] = None,
    ):
        super().__init__()
        kw = dict(num_attention_heads=num_attention_heads, num_head_channels=num_head_channels)
        self.attn1 = CrossAttention(num_channels, **kw)
        self.attn2 = CrossAttention(num_channels, cross_attention_dim=cross_attention_dim, **kw)
        self.ff = GEGLUFeedForward(num_channels)
        self.norm1 = LayerNorm(num_channels)
        self.norm2 = LayerNorm(num_channels)
        self.norm3 = LayerNorm(num_channels)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                planes: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        x = self.attn1(self.norm1(x), planes=planes) + x
        x = self.attn2(self.norm2(x), context=context, planes=planes) + x
        return self.ff(self.norm3(x)) + x


def gather_kv(k: torch.Tensor, v: torch.Tensor, space: spatial.SpaceGroup,
              planes: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole volume's K and V, (B, H, L, Dh) each, from every rank's slab of
    them: tokens run depth outermost, so a depth slab is a contiguous token range
    and the slabs in rank order are the sequence. ``planes``: (the volume's global
    depth, tokens a plane); a slab may hold any number of planes, none included.
    One exchange for both; the backward sums every rank's dK and dV into the
    owner's slab."""
    kv = torch.cat([k, v], dim=-1)
    (b, h, l, width), (depth, per_plane) = kv.shape, planes
    kv = spatial.gather(kv.reshape(b, h, l // per_plane, per_plane * width), space, 2, "kv", n=depth)
    k, v = kv.reshape(b, h, depth * per_plane, width).chunk(2, dim=-1)
    return k.contiguous(), v.contiguous()


def _planes(module: nn.Module, x: torch.Tensor, depth: Optional[int]) -> Optional[Tuple[int, int]]:
    """(global depth, tokens a plane) of the (N, C, d, *S) slab ``x`` over the module's space group."""
    return None if module.space is None else (spatial.depth_of(x, module.space, depth), math.prod(x.shape[3:]))


def _to_tokens(h: torch.Tensor) -> torch.Tensor:
    """(N, C, *S) -> (N, L, C), tokens in (d, h, w) order."""
    return h.flatten(2).transpose(1, 2)


def _from_tokens(tokens: torch.Tensor, spatial: Sequence[int]) -> torch.Tensor:
    return tokens.transpose(1, 2).reshape(tokens.shape[0], tokens.shape[2], *spatial)


class SpatialTransformer(nn.Module):
    """GN -> 1x1 proj -> voxel tokens -> transformer blocks -> 1x1 zero-proj, + residual."""

    space: Optional[spatial.SpaceGroup] = None

    def __init__(
        self, spatial_dims: int, in_channels: int, num_attention_heads: int, num_head_channels: int,
        num_layers: int = 1, norm_num_groups: int = 32, norm_eps: float = 1e-6,
        cross_attention_dim: Optional[int] = None,
    ):
        super().__init__()
        inner_dim = num_attention_heads * num_head_channels
        self.norm = GroupNorm(norm_num_groups, in_channels, norm_eps)
        self.proj_in = Conv(spatial_dims, in_channels, inner_dim, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(
                inner_dim, num_attention_heads, num_head_channels, cross_attention_dim=cross_attention_dim
            )
            for _ in range(num_layers)
        )
        self.proj_out = Conv(spatial_dims, inner_dim, in_channels, 1, zero_init=True)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                depth: Optional[int] = None) -> torch.Tensor:
        h = self.proj_in(self.norm(x), depth)
        tokens = _to_tokens(h)
        planes = _planes(self, x, depth)
        for block in self.transformer_blocks:
            tokens = block(tokens, context=context, planes=planes)
        return self.proj_out(_from_tokens(tokens, h.shape[2:]), depth) + x


class AttentionBlock(nn.Module):
    """Spatial self-attention: GN, linear q/k/v over voxel tokens, projection, +
    residual; over a ``space`` group K and V are gathered (`gather_kv`)."""

    space: Optional[spatial.SpaceGroup] = None

    def __init__(
        self, spatial_dims: int, num_channels: int, num_head_channels: Optional[int] = None,
        norm_num_groups: int = 32, norm_eps: float = 1e-6,
    ):
        super().__init__()
        self.num_heads, _ = heads_for(num_channels, num_head_channels)
        self.scale = 1.0 / ((num_channels / self.num_heads) ** 0.5)
        self.norm = GroupNorm(norm_num_groups, num_channels, norm_eps)
        self.to_q = Linear(num_channels, num_channels)
        self.to_k = Linear(num_channels, num_channels)
        self.to_v = Linear(num_channels, num_channels)
        self.proj_attn = Linear(num_channels, num_channels)

    def forward(self, x: torch.Tensor, depth: Optional[int] = None) -> torch.Tensor:
        tokens = _to_tokens(self.norm(x))
        q = split_heads(self.to_q(tokens), self.num_heads)
        k = split_heads(self.to_k(tokens), self.num_heads)
        v = split_heads(self.to_v(tokens), self.num_heads)
        if self.space is not None:
            k, v = gather_kv(k, v, self.space, _planes(self, x, depth))
        out = self.proj_attn(merge_heads(multi_head_attention(q, k, v, scale=self.scale, self_attention=True)))
        return _from_tokens(out, x.shape[2:]) + x


def attention_mode(level_has_attention: bool, with_conditioning: bool) -> Optional[str]:
    """Reference block-factory selection: None, 'self' or 'cross'."""
    if not level_has_attention:
        return None
    return "cross" if with_conditioning else "self"


def _make_attention(
    mode: Optional[str], spatial_dims: int, channels: int, num_head_channels: int,
    norm_num_groups: int, norm_eps: float, transformer_num_layers: int,
    cross_attention_dim: Optional[int],
) -> Optional[nn.Module]:
    if mode == "self":
        return AttentionBlock(spatial_dims, channels, num_head_channels, norm_num_groups, norm_eps)
    if mode == "cross":
        n_heads, head_dim = heads_for(channels, num_head_channels)
        return SpatialTransformer(
            spatial_dims, channels, n_heads, head_dim, num_layers=transformer_num_layers,
            norm_num_groups=norm_num_groups, norm_eps=norm_eps, cross_attention_dim=cross_attention_dim,
        )
    return None


def _apply_attention(attn: nn.Module, h: torch.Tensor, context: Optional[torch.Tensor],
                     depth: Optional[int] = None) -> torch.Tensor:
    return attn(h, context=context, depth=depth) if isinstance(attn, SpatialTransformer) else attn(h, depth)


class DownBlock(Remat, nn.Module):
    """Resnets (each followed by attention where the level has it) and a downsampler.

    ``forward`` returns the new hidden state and the residuals for the skips.
    """

    def __init__(
        self, spatial_dims: int, in_channels: int, out_channels: int, num_res_blocks: int = 1,
        norm_num_groups: int = 32, norm_eps: float = 1e-6, add_downsample: bool = True,
        resblock_updown: bool = False, attention_mode: Optional[str] = None,
        num_head_channels: int = 1, transformer_num_layers: int = 1,
        cross_attention_dim: Optional[int] = None,
    ):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(
                spatial_dims, in_channels if i == 0 else out_channels, out_channels,
                norm_num_groups=norm_num_groups, norm_eps=norm_eps,
            )
            for i in range(num_res_blocks)
        )
        self.attentions = nn.ModuleList(
            _make_attention(
                attention_mode, spatial_dims, out_channels, num_head_channels, norm_num_groups,
                norm_eps, transformer_num_layers, cross_attention_dim,
            )
            for _ in range(num_res_blocks if attention_mode else 0)
        )
        self.downsampler = None
        if add_downsample:
            self.downsampler = (
                ResnetBlock(
                    spatial_dims, out_channels, out_channels, down=True,
                    norm_num_groups=norm_num_groups, norm_eps=norm_eps,
                )
                if resblock_updown
                else Downsample(spatial_dims, out_channels, use_conv=True, out_channels=out_channels)
            )

    def output_depth(self, depth: int) -> int:
        return output_depth(self.downsampler, depth) if self.downsampler is not None else depth

    def forward(
        self, h: torch.Tensor, context: Optional[torch.Tensor] = None, depth: Optional[int] = None
    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        outputs = []
        for i, resnet in enumerate(self.resnets):
            h = resnet(h, depth)
            if self.attentions:
                h = _apply_attention(self.attentions[i], h, context, depth)
            outputs.append(h)
        if self.downsampler is not None:
            h = self.downsampler(h, depth)
            outputs.append(h)
        return h, outputs


class MidBlock(Remat, nn.Module):
    """resnet -> (cross|self) attention -> resnet."""

    def __init__(
        self, spatial_dims: int, in_channels: int, norm_num_groups: int = 32, norm_eps: float = 1e-6,
        with_conditioning: bool = False, num_head_channels: int = 1, transformer_num_layers: int = 1,
        cross_attention_dim: Optional[int] = None,
    ):
        super().__init__()
        self.resnet_1 = ResnetBlock(spatial_dims, in_channels, in_channels, norm_num_groups=norm_num_groups, norm_eps=norm_eps)
        self.attention = _make_attention(
            "cross" if with_conditioning else "self", spatial_dims, in_channels, num_head_channels,
            norm_num_groups, norm_eps, transformer_num_layers, cross_attention_dim,
        )
        self.resnet_2 = ResnetBlock(spatial_dims, in_channels, in_channels, norm_num_groups=norm_num_groups, norm_eps=norm_eps)

    def forward(self, h: torch.Tensor, context: Optional[torch.Tensor] = None,
                depth: Optional[int] = None) -> torch.Tensor:
        h = self.resnet_1(h, depth)
        h = _apply_attention(self.attention, h, context, depth)
        return self.resnet_2(h, depth)


class UpBlock(Remat, nn.Module):
    """Pop a skip per resnet, concat [h, skip] on channels, resnet (+ attention), upsample.

    ``skip_channels`` lists the channel counts of the skips in the order they
    are popped (last residual first).
    """

    def __init__(
        self, spatial_dims: int, in_channels: int, skip_channels: Sequence[int], out_channels: int,
        norm_num_groups: int = 32, norm_eps: float = 1e-6, add_upsample: bool = True,
        resblock_updown: bool = False, attention_mode: Optional[str] = None,
        num_head_channels: int = 1, transformer_num_layers: int = 1,
        cross_attention_dim: Optional[int] = None,
    ):
        super().__init__()
        h_channels = [in_channels] + [out_channels] * (len(skip_channels) - 1)
        self.resnets = nn.ModuleList(
            ResnetBlock(
                spatial_dims, hc + sc, out_channels, norm_num_groups=norm_num_groups, norm_eps=norm_eps,
            )
            for hc, sc in zip(h_channels, skip_channels)
        )
        self.attentions = nn.ModuleList(
            _make_attention(
                attention_mode, spatial_dims, out_channels, num_head_channels, norm_num_groups,
                norm_eps, transformer_num_layers, cross_attention_dim,
            )
            for _ in range(len(skip_channels) if attention_mode else 0)
        )
        self.upsampler = None
        if add_upsample:
            self.upsampler = (
                ResnetBlock(
                    spatial_dims, out_channels, out_channels, up=True,
                    norm_num_groups=norm_num_groups, norm_eps=norm_eps,
                )
                if resblock_updown
                else Upsample(spatial_dims, out_channels, use_conv=True, out_channels=out_channels)
            )

    def output_depth(self, depth: int) -> int:
        return output_depth(self.upsampler, depth) if self.upsampler is not None else depth

    def forward(
        self, h: torch.Tensor, res_list: Sequence[torch.Tensor], context: Optional[torch.Tensor] = None,
        depth: Optional[int] = None,
    ) -> torch.Tensor:
        res_list = list(res_list)
        for i, resnet in enumerate(self.resnets):
            h = resnet(torch.cat([h, res_list.pop()], dim=1), depth)
            if self.attentions:
                h = _apply_attention(self.attentions[i], h, context, depth)
        if self.upsampler is not None:
            h = self.upsampler(h, depth)
        return h
