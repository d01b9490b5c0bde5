"""Flash-attention forward: a hand-written CUDA kernel and its plain version.

The kernel (`csrc/flash_attention_fwd.cu`) replaces the Pallas TPU kernel
`cips_tpu/ops/pallas/flash_attention.py:_flash_kernel` (launched by
`_flash_forward`). Its source notes what bounds it on an H100 and what the
design does about that. It is built with nvcc for sm_90a into a shared
library with a plain C interface at first use, and loaded with ctypes.

`flash_attention_forward` takes the plain version only for tensors on the
CPU. For CUDA tensors it launches the kernel or raises; there is no
fallback. Its `launches` attribute counts kernel launches.

Layout: q (B, H, Lq, Dh), k and v (B, H, Lk, Dh); any L.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from typing import Optional, Tuple

import torch

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PACKAGE_DIR, "csrc", "flash_attention_fwd.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), "build", "cips_tpu_torch")
LIBRARY = os.path.join(BUILD_DIR, "libcips_flash_fwd.so")
HEAD_DIMS = (32, 64, 128)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, with its rounding points.

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


def build(verbose: bool = False) -> str:
    """Compile the kernel library if it is missing or older than its source;
    returns its path. ``verbose`` prints nvcc's register/shared-memory report."""
    if os.path.exists(LIBRARY) and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE):
        return LIBRARY
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the flash-attention kernel cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True, check=False
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    if verbose:
        print(proc.stderr.strip())
    os.replace(tmp, LIBRARY)
    return LIBRARY


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    fn = lib.cips_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


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


def flash_attention_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of softmax(scale q k^T) v; out like q, lse (B, H, Lq) fp32.

    CPU tensors take `flash_attention_reference`; CUDA tensors launch the
    kernel (and count the launch) or raise. The kernel has no backward yet,
    so CUDA inputs that need a gradient raise instead of getting none.
    """
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("the flash-attention kernel has no backward: run it under no_grad or inference_mode")
    _check_cuda_inputs(q, k, v)
    b, h, lq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _library().cips_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b * h, lq, k.shape[2], d, int(q.dtype == torch.bfloat16), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash-attention kernel launch failed: CUDA error {rc}")
    flash_attention_forward.launches += 1
    return out, lse


flash_attention_forward.launches = 0

