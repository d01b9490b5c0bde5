"""Phase-structured packed 3-D k3 convolution: hand-written CUDA kernels, their
variants, and their plain versions.

The kernels replace the Pallas TPU kernel `cips_tpu/ops/pallas/phase_conv.py:_kernel`
(launched by `phase_conv_apply`) and the three TPU probes of it, as variants of one
C entry point (`cips_phase_conv`, `csrc/phase_conv.cu`). The bf16 `full`,
`noshift`, `one_tap` and `dot` kernels (TMA + wgmma) and the `copy` kernel of both
dtypes (1-D bulk copies) are in `csrc/phase_conv_sm90.cu`; the fp32 product
variants (one 3xTF32 kernel on the tensor cores, TMA + wgmma) in
`csrc/phase_conv_tf32.cu`; `shift` and `select` in `csrc/phase_conv.cu`.

  full      `phase_conv_apply`; `scripts/probe_pallas_bisect.py` full;
            `scripts/debug_pallas_stages.py` stage >= 4
  noshift   `probe_pallas_bisect.py` nosel: every phase group reads x[c + k - 1]
  shift     `probe_pallas_bisect.py` sel, `debug_pallas_stages.py` stage 2: x' at k = 0
  one_tap   `debug_pallas_stages.py` stage 3: x' . Wp[0, 0, 0]
  copy      `debug_pallas_stages.py` stage 1: out = x
  dot       `scripts/probe_pallas_dot.py` dot4d and dot2d: sum_{k<8} x . W[k]
  select    `probe_pallas_dot.py` sel (`lane_select`)

x is space-to-depth packed (B, Z, Y, X, 8C), channels last, phase-major; 8C a
multiple of 128; bf16 or fp32; any Z, Y, X. The function:

  out[c] = sum_{k in {0,1}^3} x'[c + k] . Wp[k],   x'[i][q*C + ch] = x[i - q][q*C + ch]

zero outside the volume, fp32 accumulation, out in x's dtype, with
Wp = `s2d.pack_conv_kernel_phase(w)` (2, 2, 2, 8C, 8C). It equals the packed conv
`s2d.packed_conv`. The bf16 `dot` kernel computes x . (sum_k W[k]) with the sum
rounded once to bf16 (`dot_rounded_reference`). The fp32 kernel takes each
product as 3xTF32 and sums a 32-channel chunk of one tap in the tensor cores
before an fp32 add (`phase_conv_tf32x3_reference`). The bf16 `dot` and `one_tap`
kernels keep their weights in shared memory and take 8C = 128 or 256.

Each wrapper takes the plain version only for tensors on the CPU. For CUDA tensors
it launches the kernel or raises; there is no fallback. The JAX function has no
VJP, so a CUDA tensor that requires grad raises NotImplementedError. Launches are
counted in `cips_tpu_torch.profiling.COUNTERS` as ``phase_conv.launches.<variant>``
(``select`` for `lane_select`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional

import torch
import torch.nn.functional as F

from cips_tpu_torch.ops import cuda_library
from cips_tpu_torch.ops.flash_attention import tf32_split
from cips_tpu_torch.ops.s2d import _phase_shift_input, pack_conv_kernel_phase
from cips_tpu_torch import profiling

# variant -> the kernel's variant code (csrc/phase_conv.cu, enum Variant)
VARIANTS = {"full": 0, "noshift": 1, "one_tap": 2, "dot": 3, "shift": 4, "copy": 5}
_SELECT = 6
WITH_WEIGHTS = ("full", "noshift", "one_tap", "dot")  # the variants with products
LANES = 128
# the bf16 dot and one_tap kernels keep sum_k W[k] and Wp[0, 0, 0]'s columns in shared memory
RESIDENT_BF16 = ("dot", "one_tap")
RESIDENT_BF16_CHANNELS = (128, 256)
TF32_CHUNK = 32  # input channels of one tap that the fp32 kernel sums in the tensor cores at a time


def _check_x(x: torch.Tensor) -> None:
    """5-D bf16 or fp32 x with a multiple of 128 packed channels."""
    if x.ndim != 5:
        raise ValueError(f"x must be (B, Z, Y, X, 8C), got {tuple(x.shape)}")
    pc = x.shape[-1]
    if pc % LANES:
        raise ValueError(f"the packed channel count must be a multiple of {LANES}, got {pc}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")


def _check_contract(x: torch.Tensor, wp: Optional[torch.Tensor], variant: str) -> None:
    """The function's own contract, on every device: `_check_x`, and the weights
    the variant needs, in x's dtype."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {sorted(VARIANTS)}")
    _check_x(x)
    pc = x.shape[-1]
    if variant not in WITH_WEIGHTS:
        if wp is not None:
            raise ValueError(f"variant {variant!r} takes no weights")
        return
    want = (8, pc, pc) if variant == "dot" else (2, 2, 2, pc, pc)
    if wp is None or tuple(wp.shape) != want:
        raise ValueError(f"variant {variant!r} needs weights of shape {want}, got "
                         f"{None if wp is None else tuple(wp.shape)}")
    if wp.dtype != x.dtype:
        raise ValueError(f"weights must be in x's dtype {x.dtype}, got {wp.dtype}")


def _windows(x: torch.Tensor, variant: str) -> List[torch.Tensor]:
    """The A operand of each tap the variant sums over, (B, Z, Y, X, 8C) each."""
    _, z, y, xd, _ = x.shape
    if variant == "dot":
        return [x] * 8
    if variant == "noshift":
        src = F.pad(x, (0, 0, 1, 0, 1, 0, 1, 0))  # src[i] = x[i - 1]
    else:
        src = _phase_shift_input(x)  # src[i] = x'[i]
    taps = [(0, 0, 0)] if variant in ("one_tap", "shift") else [(a, b, c) for a in range(2) for b in range(2)
                                                              for c in range(2)]
    return [src[:, kz : kz + z, ky : ky + y, kx : kx + xd] for kz, ky, kx in taps]


def phase_conv_stage_reference(x: torch.Tensor, wp: Optional[torch.Tensor], variant: str) -> torch.Tensor:
    """Plain version of each variant, with the kernel's rounding points: the sum
    over taps in fp32 by torch.matmul on fp32 casts of x and the weights (both in
    x's dtype), then the output in x's dtype."""
    _check_contract(x, wp, variant)
    if variant == "copy":
        return x.clone()
    windows = _windows(x, variant)
    if variant == "shift":
        return windows[0].contiguous()
    w = wp.reshape(-1, x.shape[-1], x.shape[-1])
    acc = torch.matmul(windows[0].float(), w[0].float())
    for a, wk in zip(windows[1:], w[1:]):
        acc += torch.matmul(a.float(), wk.float())
    return acc.to(x.dtype)


def dot_rounded_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The bf16 `dot` kernel's own arithmetic: S = sum_k W[k] in fp32, rounded once
    to x's dtype, then x . S in fp32, the output in x's dtype. It differs from
    `phase_conv_stage_reference(x, w, "dot")` by the rounding of S."""
    _check_contract(x, w, "dot")
    s = w.float().sum(0).to(x.dtype).float()
    return torch.matmul(x.float(), s).to(x.dtype)


def phase_conv_tf32x3_reference(x: torch.Tensor, wp: torch.Tensor, variant: str) -> torch.Tensor:
    """Rounding model of the fp32 kernel of a product variant: each product as
    3xTF32 (`tf32_split` of both operands; a_b w_s + a_s w_b + a_b w_b, the
    small-small term dropped), summed over TF32_CHUNK input channels of one tap
    as the tensor cores chain them, then those sums added in fp32 in the
    kernel's order (chunk outer, tap inner). fp32 inputs; it models the
    kernel's rounding and is not bit-equal to it (the tensor cores truncate
    inside their chained sums, torch.matmul rounds). Matmuls in full fp32
    (TF32 off)."""
    _check_contract(x, wp, variant)
    if variant not in WITH_WEIGHTS or x.dtype != torch.float32:
        raise ValueError(f"the tf32x3 model covers the fp32 product variants, got {variant!r} in {x.dtype}")
    pc = x.shape[-1]
    windows = _windows(x, variant)
    w = wp.reshape(-1, pc, pc)
    out = torch.zeros_like(x)
    for c0 in range(0, pc, TF32_CHUNK):
        for a, wk in zip(windows, w):
            a_big, a_small = tf32_split(a[..., c0:c0 + TF32_CHUNK])
            w_big, w_small = tf32_split(wk[c0:c0 + TF32_CHUNK])
            out += torch.matmul(a_big, w_small) + torch.matmul(a_small, w_big) + torch.matmul(a_big, w_big)
    return out


def lane_select_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of `lane_select`: x on even channels, ((x * 2) * 0.5) * 3 on
    odd ones, rounded to x's dtype after each product."""
    odd = torch.arange(x.shape[-1], device=x.device) % 2 == 1
    return torch.where(odd, ((x * 2.0) * 0.5) * 3.0, x)


@functools.cache
def _library() -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return cuda_library.load({"cips_phase_conv": [ptr] * 3 + [i32] * 7 + [ptr],
                              "cips_phase_conv_smem": [i32, i32, ptr],
                              "cips_phase_conv_tf32_smem": [i32, i32, ptr]})


def _launch(x: torch.Tensor, wp: Optional[torch.Tensor], code: int) -> torch.Tensor:
    """Checks what the kernel takes, launches variant ``code`` on x's current
    stream and returns the output; raises on a CUDA error."""
    tensors = [x] if wp is None else [x, wp]
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError("the phase conv has no backward (the JAX function has no VJP)")
    for t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"all tensors must be CUDA tensors on one device, got {[t.device for t in tensors]}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("x and the weights must be contiguous and 16-byte aligned")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _library().cips_phase_conv(
            x.data_ptr(), 0 if wp is None else wp.data_ptr(), out.data_ptr(), code, int(x.dtype == torch.bfloat16),
            *x.shape, torch.cuda.current_stream(x.device).cuda_stream,
        )
    cuda_library.check(rc, "cips_phase_conv")
    return out


def kernel_smem(variant: str, pc: int) -> int:
    """Dynamic shared memory, in bytes, that the bf16 `full`, `noshift`, `one_tap` or
    `dot` kernel, or the `copy` kernel, launches with at ``pc`` packed channels (ptxas
    reports only static shared memory)."""
    value = ctypes.c_int(0)
    cuda_library.check(_library().cips_phase_conv_smem(VARIANTS[variant], pc, ctypes.addressof(value)),
                       "cips_phase_conv_smem")
    return value.value


def kernel_smem_f32(variant: str, n_tile: int) -> int:
    """Dynamic shared memory, in bytes, that the fp32 `full`, `noshift`, `one_tap` or
    `dot` kernel launches with at N tiles of ``n_tile`` (128, 64 or 32) output channels."""
    value = ctypes.c_int(0)
    cuda_library.check(_library().cips_phase_conv_tf32_smem(VARIANTS[variant], n_tile, ctypes.addressof(value)),
                       "cips_phase_conv_tf32_smem")
    return value.value


def _on_cpu(x: torch.Tensor, wp: Optional[torch.Tensor]) -> bool:
    return x.device.type == "cpu" and (wp is None or wp.device.type == "cpu")


def phase_conv_stage(x: torch.Tensor, wp: Optional[torch.Tensor], variant: str) -> torch.Tensor:
    """One variant (see the module docstring) of the phase conv. ``wp`` is
    (2, 2, 2, 8C, 8C) for full, noshift and one_tap, (8, 8C, 8C) for dot, and None
    for shift and copy, in x's dtype.

    CPU tensors take `phase_conv_stage_reference`; CUDA tensors launch the kernel
    (and count the launch) or raise."""
    _check_contract(x, wp, variant)
    if _on_cpu(x, wp):
        return phase_conv_stage_reference(x, wp, variant)
    if variant in RESIDENT_BF16 and x.dtype == torch.bfloat16 and x.shape[-1] not in RESIDENT_BF16_CHANNELS:
        raise ValueError(f"the bf16 {variant} kernel takes {RESIDENT_BF16_CHANNELS} packed channels, "
                         f"got {x.shape[-1]}")
    out = _launch(x, wp, VARIANTS[variant])
    profiling.COUNTERS[f"phase_conv.launches.{variant}"] += 1
    return out


def lane_select(x: torch.Tensor) -> torch.Tensor:
    """The TPU probe's select pass (`scripts/probe_pallas_dot.py:k_sel`): x on even
    channels, ((x * 2) * 0.5) * 3 on odd ones, rounded to x's dtype at each step.

    CPU tensors take `lane_select_reference`; CUDA tensors launch the kernel (and
    count the launch) or raise."""
    _check_x(x)
    if _on_cpu(x, None):
        return lane_select_reference(x)
    out = _launch(x, None, _SELECT)
    profiling.COUNTERS["phase_conv.launches.select"] += 1
    return out


def phase_conv_apply(x: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """The phase-structured conv given the (2, 2, 2, 8C, 8C) phase kernel in x's
    dtype: (B, Z, Y, X, 8C) -> (B, Z, Y, X, 8C)."""
    return phase_conv_stage(x, wp, "full")


def phase_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact packed conv (== s2d.packed_conv with f = (2, 2, 2)) through the
    kernel. w: the original (3, 3, 3, Cin, Cout) kernel; x: (B, Z, Y, X, 8 Cin)."""
    return phase_conv_apply(x, pack_conv_kernel_phase(w.to(x.dtype)))


def packed_conv_phase(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of `phase_conv` on every device: the plain full variant with
    the phase kernel built from w in x's dtype."""
    return phase_conv_stage_reference(x, pack_conv_kernel_phase(w.to(x.dtype)), "full")

