"""Multi-head attention over flattened voxel tokens (port of cips_tpu/ops/attention.py).

Shapes: q (B, H, Lq, Dh), k and v (B, H, Lk, Dh).

Every equal-length attention (Lq == Lk) goes through the flash-attention
forward (`ops/flash_attention.py`): its CUDA kernel on the card, its plain
version on the CPU. The JAX package's TPU token threshold is a v5e crossover
and is not carried over. Cross-attention to the covariate token (Lk = 1)
takes `_reference_attention`, as in the JAX package.

Scores are always formed in fp32 from fp32 copies of q and k, so the
reference's optional score upcast (`upcast_attention`) has nothing left to
change here: the products of bf16 values are exact in fp32 either way.
"""

from __future__ import annotations

from typing import Optional

import torch

from cips_tpu_torch.ops.flash_attention import flash_attention_forward


def _reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """fp32 scores, softmax probabilities rounded to the input dtype before P.V,
    fp32 accumulation, output in the input dtype."""
    dtype = q.dtype
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.matmul(probs.float(), v.float()).to(dtype)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Scaled dot-product attention; ``scale`` defaults to 1/sqrt(Dh)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.shape[2] == k.shape[2]:
        return flash_attention_forward(q, k, v, scale)[0]
    return _reference_attention(q, k, v, scale)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H*Dh) -> (B, H, L, Dh), contiguous."""
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2).contiguous()


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, Dh) -> (B, L, H*Dh)."""
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)
