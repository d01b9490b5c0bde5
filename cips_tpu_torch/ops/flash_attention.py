"""Flash attention: hand-written CUDA kernels, their plain versions, and the
autograd Function that joins them.

The kernels replace the Pallas TPU kernels of
`cips_tpu/ops/pallas/flash_attention.py`:

  forward  `csrc/flash_attention_fwd.cu`  <- `_flash_kernel` (launched by `_flash_forward`)
  dQ       `csrc/flash_attention_bwd.cu`  <- `_bwd_dq_kernel` (`_flash_backward_pallas`)
  dK/dV    `csrc/flash_attention_bwd.cu`  <- `_bwd_dkv_kernel` (`_flash_backward_pallas`)

Their sources note what bounds them on an H100 and what the design does about
that. They are built into the port's one kernel library (`cuda_library`).

Each kernel wrapper takes the plain version only for tensors on the CPU. For
CUDA tensors it launches the kernel or raises; there is no fallback. Its
`launches` attribute counts kernel launches.

fp32 inputs take kernels whose products are 3xTF32 on the tensor cores; their
rounding models are `flash_attention_tf32x3_reference` (forward) and
`flash_attention_bwd_tf32x3_reference`, which only tests and `chip_smoke.py` call.

Any scale, as in the JAX package: the kernels take the row max before the
scale, so the wrappers hand every kernel a positive one (`_positive_scale`:
a negated K for a negative scale, a zero K for scale 0).

Layout: q (B, H, Lq, Dh), k and v (B, H, Lk, Dh); any L. No query (Lq = 0,
a depth-sharded rank that holds no plane of the attended level) launches no
kernel: the output is empty and dK, dV are 0.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from cips_tpu_torch.ops import cuda_library

HEAD_DIMS = (32, 64, 128)

Tensors3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel, with its rounding points.

    fp32 scores, P = exp(s - rowmax) rounded to the input dtype before P.V
    with fp32 accumulation, out = acc / max(l, 1e-30) in the input dtype,
    lse = m + log(max(l, 1e-30)) in fp32 of shape (B, H, Lq).
    """
    dtype = q.dtype
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(dtype).float(), v.float())
    return (acc / l).to(dtype), (m + torch.log(l)).squeeze(-1)


def _probs_and_ds(q, k, v, dout, lse, delta, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """P = exp(scale q k^T - lse) in fp32 and dS = P (dO v^T - delta) rounded to
    the input dtype, as both backward kernels recompute them."""
    p = torch.exp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale - lse[..., None])
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    return p, (p * (dp - delta[..., None])).to(q.dtype)


def flash_attention_bwd_dq_reference(q, k, v, dout, lse, delta, scale) -> torch.Tensor:
    """Plain version of the dQ kernel: dQ = scale (dS K), fp32 accumulation,
    scale applied after it; dQ in q's dtype. ``dout`` is in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, dout, lse, delta, scale)
    return (torch.matmul(ds.float(), k.float()) * scale).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, dout, lse, delta, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel: dK = scale (dS^T Q), dV = P^T dO with P
    rounded to dO's dtype first; fp32 accumulation; outputs in k's and v's dtype."""
    p, ds = _probs_and_ds(q, k, v, dout, lse, delta, scale)
    dk = torch.matmul(ds.float().transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) of fp32 ``x`` as the fp32 kernels split every operand:
    big = rna(x), small = rna(x - big), rna rounding the 13 low mantissa bits to
    nearest, ties away from zero (cvt.rna.tf32.f32), in integer arithmetic on the
    fp32 bits. x - big is exact; big + small is x to within about 2^-22 relative."""

    def rna(t: torch.Tensor) -> torch.Tensor:
        return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    big = rna(x.float())
    return big, rna(x.float() - big)


def _tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as 3xTF32: a_b b_s + a_s b_b + a_b b_b, each product of tf32 parts
    exact in fp32 and summed in fp32 (a_s b_s, under 2^-22 relative, dropped)."""
    a_big, a_small = tf32_split(a)
    b_big, b_small = tf32_split(b)
    return torch.matmul(a_big, b_small) + torch.matmul(a_small, b_big) + torch.matmul(a_big, b_big)


def flash_attention_tf32x3_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rounding model of the fp32 forward kernel, (out, lse): the plain version's
    math with S = Q K^T and P V taken as 3xTF32 (`tf32_split`), P kept in fp32.
    fp32 inputs; the sums run in another order than the kernel's, so it models
    its rounding and is not bit-equal to it. Matmuls in full fp32 (TF32 off)."""
    q, k, v = (t.float() for t in (q, k, v))
    s = _tf32x3_matmul(q, k.transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return _tf32x3_matmul(p, v) / l, (m + torch.log(l)).squeeze(-1)


def flash_attention_bwd_tf32x3_reference(q, k, v, dout, lse, delta, scale) -> Tensors3:
    """Rounding model of the fp32 dQ and dK/dV kernels, (dq, dk, dv): the plain
    versions' math with each of the five products (S = Q K^T, dP = dO V^T,
    dQ = dS K, dV = P^T dO, dK = dS^T Q) taken as 3xTF32 (`tf32_split`). fp32
    inputs; the sums run in another order than the kernels', so it models their
    rounding and is not bit-equal to them. Matmuls in full fp32 (TF32 off)."""
    q, k, v, dout = (t.float() for t in (q, k, v, dout))
    p = torch.exp(_tf32x3_matmul(q, k.transpose(-1, -2)) * scale - lse[..., None])
    ds = p * (_tf32x3_matmul(dout, v.transpose(-1, -2)) - delta[..., None])
    dq = _tf32x3_matmul(ds, k) * scale
    dk = _tf32x3_matmul(ds.transpose(-1, -2), q) * scale
    return dq, dk, _tf32x3_matmul(p.transpose(-1, -2), dout)


def _delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in fp32, (B, H, Lq), from dO before its cast to q's dtype."""
    return (dout.float() * out.float()).sum(dim=-1)


def flash_attention_backward_reference(q, k, v, out, lse, dout, scale) -> Tensors3:
    """Plain backward, (dq, dk, dv): delta = rowsum(dO * O) in fp32, dO cast to
    q's dtype, then the two kernels' plain versions."""
    delta = _delta(dout, out)
    dout = dout.to(q.dtype)
    dq = flash_attention_bwd_dq_reference(q, k, v, dout, lse, delta, scale)
    return (dq, *flash_attention_bwd_dkv_reference(q, k, v, dout, lse, delta, scale))


@functools.cache
def _library() -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return cuda_library.load({
        "cips_flash_attention_fwd": [ptr] * 5 + [i32] * 5 + [ctypes.c_float, ptr],
        "cips_flash_attention_bwd_dq": [ptr] * 7 + [i32] * 5 + [ctypes.c_float, ptr],
        "cips_flash_attention_bwd_dkv": [ptr] * 8 + [i32] * 5 + [ctypes.c_float, ptr],
        "cips_flash_attention_bwd_dq_smem": [i32, ptr],
    })


def dq_kernel_smem(head_dim: int) -> int:
    """Dynamic shared memory, in bytes, that the bf16 dQ kernel launches with at
    ``head_dim`` (ptxas reports only static shared memory)."""
    value = ctypes.c_int(0)
    cuda_library.check(_library().cips_flash_attention_bwd_dq_smem(head_dim, ctypes.addressof(value)),
                       "cips_flash_attention_bwd_dq_smem")
    return value.value


def _is_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_cuda_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"q, k, v must all be CUDA tensors, got {q.device}, {k.device}, {v.device}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtype must be bfloat16 or float32 for all of q, k, v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (B, H, L, Dh)")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"incompatible shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.shape[2] == 0 or k.shape[2] == 0 or b * h == 0 or b * h > 65535:
        raise ValueError(f"unsupported sizes q {tuple(q.shape)}, k {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_cuda_residuals(q: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor) -> None:
    """dO like q; lse and delta (B, H, Lq) fp32; all contiguous on q's device."""
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"dout must match q {tuple(q.shape)} {q.dtype}, got {tuple(dout.shape)} {dout.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be {tuple(q.shape[:3])} float32 on {q.device}, got {tuple(t.shape)} {t.dtype}")
    for name, t in (("dout", dout), ("lse", lse), ("delta", delta)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _positive_scale(k: torch.Tensor, scale: float) -> Tuple[torch.Tensor, float, float]:
    """(k', scale', dk_sign) with scale' > 0 and scale' q k'^T = scale q k^T, for
    the kernels, which take the row max before the scale: a negative
    scale negates k (exact in every dtype), and scale 0 zeroes k with scale' 1
    (uniform P, lse = log Lk, dQ = 0). The kernels' dK is the gradient for k', so
    the gradient for k is dk_sign times it (0 at scale 0, where dK is 0)."""
    if scale > 0:
        return k, scale, 1.0
    if scale < 0:
        return -k, -scale, -1.0
    return torch.zeros_like(k), 1.0, 0.0


def _launch(name: str, q: torch.Tensor, k: torch.Tensor, *pointers: int, scale: float) -> None:
    """Calls the C entry point ``name`` with the data pointers, then the sizes,
    dtype flag, scale and q's current stream; raises on a CUDA error."""
    b, h, lq, d = q.shape
    with torch.cuda.device(q.device):
        rc = getattr(_library(), name)(
            *pointers, b * h, lq, k.shape[2], d, int(q.dtype == torch.bfloat16), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    cuda_library.check(rc, name)


def flash_attention_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of softmax(scale q k^T) v; out like q, lse (B, H, Lq) fp32.

    CPU tensors take `flash_attention_reference`; CUDA tensors launch the
    kernel (and count the launch) or raise. It records no gradient: use
    `FlashAttention` for that.
    """
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if _is_cpu(q, k, v):
        return flash_attention_reference(q, k, v, scale)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if q.shape[2] == 0:
        return out, lse
    _check_cuda_inputs(q, k, v)
    k, scale, _ = _positive_scale(k, scale)
    _launch("cips_flash_attention_fwd", q, k, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), scale=scale)
    flash_attention_forward.launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale: float) -> torch.Tensor:
    """dQ from the residuals; ``dout`` in q's dtype, ``delta`` = rowsum(dO * O).

    CPU tensors take `flash_attention_bwd_dq_reference`; CUDA tensors launch
    the dQ kernel (and count the launch) or raise."""
    if _is_cpu(q, k, v, dout, lse, delta):
        return flash_attention_bwd_dq_reference(q, k, v, dout, lse, delta, scale)
    if q.shape[2] == 0:
        return torch.empty_like(q)
    _check_cuda_inputs(q, k, v)
    _check_cuda_residuals(q, dout, lse, delta)
    k, scale, _ = _positive_scale(k, scale)
    dq = torch.empty_like(q)
    _launch("cips_flash_attention_bwd_dq", q, k, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), scale=scale)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) from the residuals; ``dout`` in q's dtype, ``delta`` = rowsum(dO * O).

    CPU tensors take `flash_attention_bwd_dkv_reference`; CUDA tensors launch
    the dK/dV kernel (and count the launch) or raise."""
    if _is_cpu(q, k, v, dout, lse, delta):
        return flash_attention_bwd_dkv_reference(q, k, v, dout, lse, delta, scale)
    if q.shape[2] == 0:
        return torch.zeros_like(k), torch.zeros_like(v)
    _check_cuda_inputs(q, k, v)
    _check_cuda_residuals(q, dout, lse, delta)
    k, scale, dk_sign = _positive_scale(k, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("cips_flash_attention_bwd_dkv", q, k, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), scale=scale)
    flash_attention_bwd_dkv.launches += 1
    if dk_sign != 1.0:
        dk.mul_(dk_sign)
    return dk, dv


flash_attention_forward.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


class FlashAttention(torch.autograd.Function):
    """softmax(scale q k^T) v with the flash kernels on both passes (their plain
    versions on the CPU). Saves (q, k, v, out, lse), as the JAX package's
    `_flash_core_fwd` does; the backward computes delta = rowsum(dO * O) in
    fp32, casts dO to q's dtype, and runs the dQ and the dK/dV kernel."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
        out, lse = flash_attention_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        q, k, v, out, lse = ctx.saved_tensors
        delta = _delta(dout, out)
        dout = dout.to(q.dtype).contiguous()
        dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, ctx.scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, ctx.scale)
        return dq, dk, dv, None
