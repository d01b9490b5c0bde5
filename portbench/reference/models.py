"""Plain fp32 PyTorch versions of the networks the benchmark's cells train.

Each module computes the published architecture with stock PyTorch
operations: `F.conv3d`, `F.group_norm`, `nn.Linear`, plain softmax attention.
Parameter names are those of the program's ``state_dict``, so one set of
weights loads into both. Nothing here imports the program.

``Precision`` sets how every convolution, linear layer and attention product
takes its operands: ``float32`` as given, or rounded to float8 (e4m3, one
scale a tensor: its largest magnitude at 448) before the product, which is
then summed in fp32: the tensor cores' fp8 path, the control of the check.
`attention` records the shape of every self-attention it computes in
``Precision.sites`` when that is a list, for the FLOP and bytes counts.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

FP8_MAX = 448.0


class Precision:
    """How products take their operands (``fp8``), whether each attention is
    recomputed in its backward (``recompute``, to fit beside the program), and
    the list of self-attention shapes met (``sites``, or None)."""

    def __init__(self, fp8: bool = False, recompute: bool = True, sites: Optional[list] = None,
                 query_block: int = 4096):
        self.fp8 = fp8
        self.recompute = recompute
        self.sites = sites
        self.query_block = query_block


PLAIN = Precision()


def operand(x: torch.Tensor, p: Precision) -> torch.Tensor:
    """``x`` as a product takes it: itself, or rounded to e4m3 at a per-tensor
    scale, the gradient passing the rounding unchanged (the product's backward
    then works from the rounded operands it saved)."""
    if not p.fp8 or x.device.type == "meta":
        return x
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    rounded = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (rounded - x.detach())


class Conv(nn.Module):
    """'same' convolution (padding (k-1)//2), parameters at ``conv.weight``/``conv.bias``."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, p: Precision = PLAIN):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2)
        self.p = p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        return F.conv3d(operand(x, self.p), operand(c.weight, self.p), c.bias, c.stride, c.padding)


class Linear(nn.Linear):
    def __init__(self, cin: int, cout: int, bias: bool = True, p: Precision = PLAIN):
        super().__init__(cin, cout, bias=bias)
        self.p = p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(operand(x, self.p), operand(self.weight, self.p), self.bias)


class GroupNorm(nn.GroupNorm):
    def __init__(self, groups: int, channels: int, eps: float = 1e-6):
        super().__init__(groups, channels, eps=eps)


def _softmax_attention(q, k, v, scale, p: Precision):
    out = []
    for s in range(0, q.shape[2], p.query_block):
        scores = torch.matmul(operand(q[:, :, s:s + p.query_block], p), operand(k, p).transpose(-1, -2)) * scale
        out.append(torch.matmul(operand(torch.softmax(scores, dim=-1), p), operand(v, p)))
    return torch.cat(out, dim=2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, p: Precision,
              self_attention: bool) -> torch.Tensor:
    """softmax(q k^T scale) v over (B, H, L, Dh), a block of queries at a time;
    recomputed in the backward when ``p.recompute`` and autograd is on."""
    if self_attention and p.sites is not None:
        p.sites.append((q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3]))
    if p.recompute and torch.is_grad_enabled() and q.device.type != "meta":
        return torch.utils.checkpoint.checkpoint(_softmax_attention, q, k, v, scale, p, use_reentrant=False)
    return _softmax_attention(q, k, v, scale, p)


def heads_for(channels: int, head_channels: int):
    if not head_channels or head_channels <= 0 or head_channels > channels or channels % head_channels:
        return 1, channels
    return channels // head_channels, head_channels


def upsample(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def downsample(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool3d(x, 2)


class ResnetBlock(nn.Module):
    """GN, SiLU, (2x resample of both paths), conv, GN, SiLU, conv, plus the (1x1) skip."""

    def __init__(self, cin: int, cout: int, groups: int, eps: float, up=False, down=False,
                 skip_name="skip_connection", p: Precision = PLAIN):
        super().__init__()
        self.up, self.down, self.skip_name = up, down, skip_name
        self.norm1 = GroupNorm(groups, cin, eps)
        self.conv1 = Conv(cin, cout, 3, p=p)
        self.norm2 = GroupNorm(groups, cout, eps)
        self.conv2 = Conv(cout, cout, 3, p=p)
        setattr(self, skip_name, Conv(cin, cout, 1, p=p) if cin != cout else None)

    def forward(self, x):
        h = F.silu(self.norm1(x))
        if self.up:
            x, h = upsample(x), upsample(h)
        elif self.down:
            x, h = downsample(x), downsample(h)
        h = self.conv2(F.silu(self.norm2(self.conv1(h))))
        skip = getattr(self, self.skip_name)
        return (x if skip is None else skip(x)) + h


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: Optional[int], heads: int, head_dim: int, p: Precision):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.scale, self.p = heads, head_dim ** -0.5, p
        self.to_q = Linear(dim, inner, bias=False, p=p)
        self.to_k = Linear(context_dim or dim, inner, bias=False, p=p)
        self.to_v = Linear(context_dim or dim, inner, bias=False, p=p)
        self.to_out = nn.Sequential(Linear(inner, dim, p=p))

    def forward(self, x, context=None):
        ctx = x if context is None else context
        b, h = x.shape[0], self.heads

        def split(t):
            return t.reshape(b, t.shape[1], h, -1).transpose(1, 2)

        out = attention(split(self.to_q(x)), split(self.to_k(ctx)), split(self.to_v(ctx)), self.scale, self.p,
                        self_attention=context is None)
        return self.to_out(out.transpose(1, 2).reshape(b, x.shape[1], -1))


class FeedForward(nn.Module):
    """GEGLU: linear1 -> (h, gate) -> h * gelu(gate) -> linear2."""

    def __init__(self, dim: int, p: Precision):
        super().__init__()
        self.linear1 = Linear(dim, dim * 8, p=p)
        self.linear2 = Linear(dim * 4, dim, p=p)

    def forward(self, x):
        h, gate = self.linear1(x).chunk(2, dim=-1)
        return self.linear2(h * F.gelu(gate))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: Optional[int], p: Precision):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, heads, head_dim, p)
        self.attn2 = CrossAttention(dim, context_dim, heads, head_dim, p)
        self.ff = FeedForward(dim, p)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim, eps=1e-6) for _ in range(3))

    def forward(self, x, context=None):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """GN, 1x1 conv in, voxel tokens through the transformer blocks, 1x1 conv out, plus the input."""

    def __init__(self, channels: int, head_channels: int, layers: int, groups: int, eps: float,
                 context_dim: Optional[int], p: Precision):
        super().__init__()
        heads, head_dim = heads_for(channels, head_channels)
        inner = heads * head_dim
        self.norm = GroupNorm(groups, channels, eps)
        self.proj_in = Conv(channels, inner, 1, p=p)
        self.transformer_blocks = nn.ModuleList(
            TransformerBlock(inner, heads, head_dim, context_dim, p) for _ in range(layers))
        self.proj_out = Conv(inner, channels, 1, p=p)

    def forward(self, x, context=None):
        h = self.proj_in(self.norm(x))
        spatial = h.shape[2:]
        tokens = h.flatten(2).transpose(1, 2)
        for block in self.transformer_blocks:
            tokens = block(tokens, context)
        return self.proj_out(tokens.transpose(1, 2).reshape(h.shape[0], -1, *spatial)) + x


class DownBlock(nn.Module):
    def __init__(self, cin, cout, res_blocks, groups, eps, downsample_, attn, head_channels, layers,
                 context_dim, p: Precision):
        super().__init__()
        self.resnets = nn.ModuleList(ResnetBlock(cin if i == 0 else cout, cout, groups, eps, p=p)
                                     for i in range(res_blocks))
        self.attentions = nn.ModuleList(
            SpatialTransformer(cout, head_channels, layers, groups, eps, context_dim, p)
            for _ in range(res_blocks if attn else 0))
        self.downsampler = ResnetBlock(cout, cout, groups, eps, down=True, p=p) if downsample_ else None

    def forward(self, h, context=None):
        outs = []
        for i, resnet in enumerate(self.resnets):
            h = resnet(h)
            if len(self.attentions):
                h = self.attentions[i](h, context)
            outs.append(h)
        if self.downsampler is not None:
            h = self.downsampler(h)
            outs.append(h)
        return h, outs


class MidBlock(nn.Module):
    def __init__(self, channels, groups, eps, head_channels, layers, context_dim, p: Precision):
        super().__init__()
        self.resnet_1 = ResnetBlock(channels, channels, groups, eps, p=p)
        self.attention = SpatialTransformer(channels, head_channels, layers, groups, eps, context_dim, p)
        self.resnet_2 = ResnetBlock(channels, channels, groups, eps, p=p)

    def forward(self, h, context=None):
        return self.resnet_2(self.attention(self.resnet_1(h), context))


class UpBlock(nn.Module):
    def __init__(self, cin, skips: Sequence[int], cout, groups, eps, upsample_, attn, head_channels, layers,
                 context_dim, p: Precision):
        super().__init__()
        hc = [cin] + [cout] * (len(skips) - 1)
        self.resnets = nn.ModuleList(ResnetBlock(a + s, cout, groups, eps, p=p) for a, s in zip(hc, skips))
        self.attentions = nn.ModuleList(
            SpatialTransformer(cout, head_channels, layers, groups, eps, context_dim, p)
            for _ in range(len(skips) if attn else 0))
        self.upsampler = ResnetBlock(cout, cout, groups, eps, up=True, p=p) if upsample_ else None

    def forward(self, h, skips: List[torch.Tensor], context=None):
        skips = list(skips)
        for i, resnet in enumerate(self.resnets):
            h = resnet(torch.cat([h, skips.pop()], dim=1))
            if len(self.attentions):
                h = self.attentions[i](h, context)
        return h if self.upsampler is None else self.upsampler(h)


def _per_level(v, n):
    return (v,) * n if isinstance(v, (int, bool)) else tuple(v)


class AttenUNet(nn.Module):
    """The flagship generator: channels-last (N, D, H, W, 1) volume and (N, 1, K)
    covariate row in, the synthesized volume out. Every down, middle and up
    block cross-attends at the levels ``attention_levels`` marks; the skips
    carry every resnet's and downsampler's output; the resamplers are resnets
    (``resblock_updown``)."""

    def __init__(self, num_channels, num_res_blocks, attention_levels, norm_num_groups, norm_eps,
                 num_head_channels, transformer_num_layers, cross_attention_dim, in_channels=1,
                 out_channels=1, p: Precision = PLAIN, **_):
        super().__init__()
        n = len(num_channels)
        res, heads = _per_level(num_res_blocks, n), _per_level(num_head_channels, n)
        kw = dict(groups=norm_num_groups, eps=norm_eps, layers=transformer_num_layers,
                  context_dim=cross_attention_dim, p=p)
        self.conv_in = Conv(in_channels, num_channels[0], 3, p=p)
        skips, prev = [num_channels[0]], num_channels[0]
        self.down_blocks = nn.ModuleList()
        for i in range(n):
            last = i == n - 1
            self.down_blocks.append(DownBlock(prev, num_channels[i], res[i], downsample_=not last,
                                              attn=attention_levels[i], head_channels=heads[i], **kw))
            skips += [num_channels[i]] * (res[i] + (0 if last else 1))
            prev = num_channels[i]
        self.middle_block = MidBlock(prev, head_channels=heads[-1], **kw)
        self.takes = [res[n - 1 - i] + 1 for i in range(n)]
        self.up_blocks = nn.ModuleList()
        for i in range(n):
            level = n - 1 - i
            popped, skips = skips[-self.takes[i]:][::-1], skips[:-self.takes[i]]
            self.up_blocks.append(UpBlock(prev, popped, num_channels[level], upsample_=i != n - 1,
                                          attn=attention_levels[level], head_channels=heads[level], **kw))
            prev = num_channels[level]
        self.out = nn.Sequential(GroupNorm(norm_num_groups, prev, norm_eps), nn.SiLU(),
                                 Conv(prev, out_channels, 3, p=p))

    def forward(self, x, context):
        h = self.conv_in(x.movedim(-1, 1))
        residuals = [h]
        for block in self.down_blocks:
            h, outs = block(h, context)
            residuals += outs
        h = self.middle_block(h, context)
        for block, take in zip(self.up_blocks, self.takes):
            skips, residuals = residuals[-take:], residuals[:-take]
            h = block(h, skips, context)
        return self.out(h).movedim(1, -1)


class PatchDiscriminator(nn.Module):
    """k4 stride-2 convs (instance norm and LeakyReLU 0.2 after all but the
    first), a stride-1 conv with norm, a 1-channel stride-1 head; returns the
    channels-last logits."""

    def __init__(self, num_channels=64, num_layers_d=3, in_channels=1, out_channels=1, p: Precision = PLAIN, **_):
        super().__init__()
        self.layers = num_layers_d
        self.conv_0 = Conv(in_channels, num_channels, 4, 2, p=p)
        ch = num_channels
        for i in range(1, num_layers_d):
            prev, ch = ch, min(ch * 2, 512)
            setattr(self, f"conv_{i}", Conv(prev, ch, 4, 2, p=p))
            setattr(self, f"norm_{i}", GroupNorm(ch, ch, 1e-5))
        prev, ch = ch, min(ch * 2, 512)
        self.conv_penultimate = Conv(prev, ch, 4, 1, p=p)
        self.norm_penultimate = GroupNorm(ch, ch, 1e-5)
        self.conv_out = Conv(ch, out_channels, 4, 1, p=p)

    def forward(self, x):
        h = F.leaky_relu(self.conv_0(x.movedim(-1, 1)), 0.2)
        for i in range(1, self.layers):
            h = F.leaky_relu(getattr(self, f"norm_{i}")(getattr(self, f"conv_{i}")(h)), 0.2)
        h = F.leaky_relu(self.norm_penultimate(self.conv_penultimate(h)), 0.2)
        return self.conv_out(h).movedim(1, -1)


class SpatialEncoder(nn.Module):
    """The causal generator's T1 encoder: the AttenUNet's down path (the last
    level not downsampling), its transformers without a context (both attentions
    attend to the tokens), then GN, SiLU and ``conv_out`` to the 2z-channel latent."""

    def __init__(self, num_channels, num_res_blocks, attention_levels, norm_num_groups, norm_eps,
                 num_head_channels, transformer_num_layers, in_channels=1, out_channels=2,
                 p: Precision = PLAIN, **_):
        super().__init__()
        n = len(num_channels)
        res, heads = _per_level(num_res_blocks, n), _per_level(num_head_channels, n)
        self.conv_in = Conv(in_channels, num_channels[0], 3, p=p)
        self.down_blocks = nn.ModuleList()
        prev = num_channels[0]
        for i in range(n):
            self.down_blocks.append(DownBlock(prev, num_channels[i], res[i], norm_num_groups, norm_eps,
                                              downsample_=i != n - 1, attn=attention_levels[i],
                                              head_channels=heads[i], layers=transformer_num_layers,
                                              context_dim=None, p=p))
            prev = num_channels[i]
        self.out_norm = GroupNorm(norm_num_groups, prev, norm_eps)
        self.conv_out = Conv(prev, out_channels, 3, p=p)

    def forward(self, x):
        h = self.conv_in(x.movedim(-1, 1))
        for block in self.down_blocks:
            h, _ = block(h)
        return self.conv_out(F.silu(self.out_norm(h))).movedim(1, -1)


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv (``conv.conv.*``)."""

    def __init__(self, channels: int, p: Precision):
        super().__init__()
        self.conv = Conv(channels, channels, 3, p=p)

    def forward(self, x):
        return self.conv(upsample(x))


class VAEDecoder(nn.Module):
    """The KL-VAE decoder (MONAI-generative's flat ``blocks``): conv_in, per
    level (coarse to fine) resnets and an upsampler between levels, GN, conv_out."""

    def __init__(self, num_channels, num_res_blocks, norm_num_groups, norm_eps, in_channels=3, out_channels=1,
                 p: Precision = PLAIN, **_):
        super().__init__()
        n = len(num_channels)
        channels, res = list(reversed(num_channels)), list(reversed(_per_level(num_res_blocks, n)))
        blocks: list = [Conv(in_channels, channels[0], 3, p=p)]
        prev = channels[0]
        for i in range(n):
            for _ in range(res[i]):
                blocks.append(ResnetBlock(prev, channels[i], norm_num_groups, norm_eps, skip_name="nin_shortcut", p=p))
                prev = channels[i]
            if i != n - 1:
                blocks.append(Upsample(prev, p))
        blocks += [GroupNorm(norm_num_groups, prev, norm_eps), Conv(prev, out_channels, 3, p=p)]
        self.blocks = nn.ModuleList(blocks)

    def forward(self, z):
        h = z.movedim(-1, 1)
        *body, norm, conv_out = self.blocks
        for block in body:
            h = block(h)
        return conv_out(F.silu(norm(h))).movedim(1, -1)


class DecoderLevel(nn.Module):
    def __init__(self, resnets, attentions, upsampler):
        super().__init__()
        self.resnets, self.attentions, self.upsampler = nn.ModuleList(resnets), nn.ModuleList(attentions), upsampler

    def forward(self, h, context):
        for i, resnet in enumerate(self.resnets):
            h = resnet(h)
            if len(self.attentions):
                h = self.attentions[i](h, context)
        return h if self.upsampler is None else self.upsampler(h)


class PETDecoder(nn.Module):
    """The covariate-conditioned latent-to-PET decoder: conv_in, the mid block,
    per level resnets (with cross-attending transformers where the level
    attends) and an upsampler between levels, GN, SiLU, conv_out."""

    def __init__(self, num_channels, num_res_blocks, attention_levels, norm_num_groups, norm_eps,
                 num_head_channels, cross_attention_dim, in_channels=3, out_channels=1, transformer_num_layers=1,
                 p: Precision = PLAIN, **_):
        super().__init__()
        n = len(num_channels)
        res, heads = _per_level(num_res_blocks, n), _per_level(num_head_channels, n)
        g, e = norm_num_groups, norm_eps
        self.conv_in = Conv(in_channels, num_channels[0], 3, p=p)
        self.middle_block = MidBlock(num_channels[0], g, e, heads[0], transformer_num_layers, cross_attention_dim, p)
        self.up_blocks = nn.ModuleList()
        prev = num_channels[0]
        for i in range(n):
            c = num_channels[i]
            resnets = [ResnetBlock(prev if j == 0 else c, c, g, e, p=p) for j in range(res[i])]
            attentions = [SpatialTransformer(c, heads[i], transformer_num_layers, g, e, cross_attention_dim, p)
                          for _ in range(res[i] if attention_levels[i] else 0)]
            self.up_blocks.append(DecoderLevel(resnets, attentions, Upsample(c, p) if i != n - 1 else None))
            prev = c
        self.out = nn.Sequential(GroupNorm(g, prev, e), nn.SiLU(), Conv(prev, out_channels, 3, p=p))

    def forward(self, z, context):
        h = self.middle_block(self.conv_in(z.movedim(-1, 1)), context)
        for level in self.up_blocks:
            h = level(h, context)
        return self.out(h).movedim(1, -1)
