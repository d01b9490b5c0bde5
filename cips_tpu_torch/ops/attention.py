"""Multi-head attention over flattened voxel tokens (port of cips_tpu/ops/attention.py).

Shapes: q (B, H, Lq, Dh), k and v (B, H, Lk, Dh).

Every self-attention goes through `FlashAttention` (`ops/flash_attention.py`):
the flash kernels, forward and backward, on the card, and their plain versions
on the CPU. That includes a depth-sharded one, whose slab of queries (Lq =
L / n_space) attends to the whole volume's keys (Lk = L). The JAX package's TPU
token threshold is a v5e crossover and is not carried over. Cross-attention to
the covariate token (Lk = 1) takes `_reference_attention`, as in the JAX
package. The call site names its kind (``self_attention``); a caller that does
not is routed by equal lengths.

Scores are always formed in fp32 from fp32 copies of q and k, so the
reference's optional score upcast (`upcast_attention`) has nothing left to
change here: the products of bf16 values are exact in fp32 either way.
"""

from __future__ import annotations

from typing import Optional

import torch

from cips_tpu_torch.ops.flash_attention import FlashAttention


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
    self_attention: Optional[bool] = None,
) -> torch.Tensor:
    """Scaled dot-product attention; ``scale`` defaults to 1/sqrt(Dh). A
    self-attention takes `FlashAttention`, a cross-attention the plain path;
    ``self_attention`` None takes Lq == Lk for one."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if self_attention is None:
        self_attention = q.shape[2] == k.shape[2]
    if self_attention:
        return FlashAttention.apply(q, k, v, scale)
    return _reference_attention(q, k, v, scale)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H*Dh) -> (B, H, L, Dh), contiguous."""
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2).contiguous()


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, Dh) -> (B, L, H*Dh)."""
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)
