"""The fp32 flash kernels (the 3xTF32 forward, dQ and dK/dV) beside copies of themselves with
one design choice changed, and the rate of the tensor cores' tf32 products: error and device
time on one card.

    python -m cips_tpu_torch.scripts.time_flash_f32 [fwd | bwd | rate | <copy> ...]

Each copy is `csrc/flash_attention_fwd.cu` (FWD_COPIES) or `csrc/flash_attention_bwd.cu`
(COPIES) with `csrc/mma_tf32.cuh`, with the text edits of its entry, built by nvcc into a
library of its own under `build/cips_tpu_torch/flash_f32_copies/` (`..._fwd_copies/`) and
called through `cips_flash_attention_fwd` or `cips_flash_attention_bwd_dq` and
`cips_flash_attention_bwd_dkv`. Every copy computes the same function, so each is held to the
plain version in fp32 (its error printed: of max|out| and in lse for the forward, of each
max|grad| for the backward; the forward's also to its rounding model) and timed by device time
at the flagship's attention (2, 4, 2304, 32), at the causal generator's 18,432 tokens (1, 1,
18432, 32) and at Dh 64 and 128, beside SDPA's fp32 (memory-efficient) forward or backward.
Prints each copy's registers and spills (ptxas) at Dh 32, 64 and 128. `rate` times
back-to-back tf32 products on register operands (`mma.sync.m16n8k8`) and from shared memory
(`wgmma` m64n64k8) on every SM, against the card's TF32 peak.

Arguments: `fwd` (every forward copy), `bwd` (every backward copy), `rate`, or the names of
copies (the unedited kernel of their group runs with them; `kernel` names the unedited forward
and backward); without arguments, all of it. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

import torch

from cips_tpu_torch.ops import cuda_library
from cips_tpu_torch.ops import flash_attention as fa
from cips_tpu_torch.scripts.time_full_kernel import build_copies, device_ms, edited

SHAPES = ((2, 4, 2304, 32), (1, 1, 18432, 32), (1, 2, 4608, 64), (1, 2, 2048, 128))
SOURCES = ("flash_attention_bwd.cu", "mma_tf32.cuh")
FWD_SOURCES = ("flash_attention_fwd.cu", "mma_tf32.cuh")
TOL_F32_GRAD_REL = 1e-5  # of max|grad|, against the plain backward, as chip_smoke.py holds the kernels
TOL_F32_OUT_REL = 1e-5  # of max|out|, against the plain forward, as chip_smoke.py holds the kernel
TOL_LSE = 1e-4  # absolute
TF32_PEAK = 494.5e12  # dense TF32 tensor-core peak of an H100 SXM at 700 W (989 / 2 TFLOP/s)

Edits = Dict[str, List[Tuple[str, str]]]  # source file -> (old, new) text edits
DQ_SUM = "tf32x3::mma3(part[d], dsa, kb);"
DV_SUM = "tf32x3::mma3(dv_part[d], pa, ob);"
DK_SUM = "tf32x3::mma3(dk_part[d], dsa, qb);"
CHUNK = "constexpr int kScoreChunk = 4;"
HOLD_A = "constexpr bool kHoldA = DH == 32;"
DQ_TILE = "static constexpr int BK = DH >= 128 ? 32 : 64;"
DKV_TILE = "static constexpr int BQ = DH >= 64 ? 32 : 64;"
SLICES = "static constexpr int kSlices = DH >= 128 ? 2 : 1;"
FWD_PV_SUM = "tf32x3::mma3(part[d], pa, vb);"
FWD_CTAS = "constexpr int kF32Ctas = DH == 32 ? 3 : 1;"
FWD_HOLD_Q = "constexpr bool kHoldQ = DH == 32;"
FWD_TILE = "static constexpr int BK = DH >= 128 ? 32 : 64;  // keys a ring tile"
FWD_STAGES = "static constexpr int kStages = 2;"
FWD_ROWS = "constexpr int kF32Rows = 32;"


def _bwd(*edits: Tuple[str, str]) -> Edits:
    return {"flash_attention_bwd.cu": list(edits)}


def _fwd(*edits: Tuple[str, str]) -> Edits:
    return {"flash_attention_fwd.cu": list(edits)}


COPIES: Dict[str, Edits] = {
    "kernel": {},
    # the long sums (dQ over keys, dK and dV over q rows) held in the tensor cores' accumulators
    "chained long sums": _bwd((DQ_SUM, "tf32x3::mma3(acc[d], dsa, kb);"),
                              (DV_SUM, "tf32x3::mma3(dv_acc[d], pa, ob);"),
                              (DK_SUM, "tf32x3::mma3(dk_acc[d], dsa, qb);")),
    # the long sums added to the running ones by fp32 adds a k-step (8 rows) at a time, not a tile
    "k-step sums": _bwd(*((old, "{ float z[4] = {0.f, 0.f, 0.f, 0.f}; " + old.replace(part, "z")
                           + f" for (int e = 0; e < 4; ++e) {acc}[d][e] += z[e]; }}")
                          for old, part, acc in ((DQ_SUM, "part[d]", "acc"), (DV_SUM, "dv_part[d]", "dv_acc"),
                                                 (DK_SUM, "dk_part[d]", "dk_acc")))),
    # S and dP held in the tensor cores' accumulators over all of Dh at every Dh (a macro,
    # so that each instantiation reads its own DH)
    "scores chained": _bwd((CHUNK, "#define kScoreChunk (DH / 8)")),
    # ... over 2 k-steps (16 columns) or one at a time, each added to S and dP by fp32 adds
    "scores in 2-step chunks": _bwd((CHUNK, "constexpr int kScoreChunk = 2;")),
    "scores a k-step at a time": _bwd((CHUNK, "constexpr int kScoreChunk = 1;")),
    # the A fragments of Q and dO (dQ), K and V (dK/dV) loaded and split again each tile at Dh 32
    "A split each tile": _bwd((HOLD_A, "constexpr bool kHoldA = false;")),
    "32-row tiles": _bwd((DQ_TILE, "static constexpr int BK = 32;"), (DKV_TILE, "static constexpr int BQ = 32;")),
    # the choices at Dh 64 and 128 undone one at a time
    "dK/dV at Dh 128 in one slice": _bwd((SLICES, "static constexpr int kSlices = 1;")),
    "16-row dK/dV tiles at Dh 128": _bwd((DKV_TILE, "static constexpr int BQ = DH >= 128 ? 16 : DH >= 64 ? 32 : 64;")),
    "64-row dK/dV tiles at Dh 64": _bwd((DKV_TILE, "static constexpr int BQ = DH >= 128 ? 32 : 64;")),
    "dK/dV at Dh 64 in two slices, 64-row tiles": _bwd(
        (SLICES, "static constexpr int kSlices = DH >= 64 ? 2 : 1;"),
        (DKV_TILE, "static constexpr int BQ = DH >= 128 ? 32 : 64;")),
    # rna by the conversion instruction (the same bits as the integer ops for finite x)
    "cvt.rna split": {"mma_tf32.cuh": [(
        "__device__ __forceinline__ uint32_t to_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }",
        "__device__ __forceinline__ uint32_t to_tf32(float x) {\n  uint32_t y;\n"
        "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(y) : \"f\"(x));\n  return y;\n}")]},
    # small's 13 low bits left for the tensor cores to drop (CUTLASS's round_half_ulp_truncate):
    # if they ignore them, the products are those of the kernel, bit for bit
    "small unmasked": {"mma_tf32.cuh": [("  small = to_tf32(x - __uint_as_float(big));",
                                        "  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;")]},
}


FWD_COPIES: Dict[str, Edits] = {
    "kernel": {},
    # the first design: 64 q rows a CTA, two CTAs an SM at Dh 32 and 64 (at most 128 registers a
    # thread), Q split again each key tile, 32-key tiles at Dh 64, 3 stages at Dh 32
    "fwd first design": _fwd((FWD_ROWS, "constexpr int kF32Rows = 64;"),
                             (FWD_CTAS, "constexpr int kF32Ctas = DH >= 128 ? 1 : 2;"),
                             (FWD_HOLD_Q, "constexpr bool kHoldQ = false;"),
                             (FWD_TILE, "static constexpr int BK = DH >= 64 ? 32 : 64;  // keys a ring tile"),
                             (FWD_STAGES, "static constexpr int kStages = DH >= 64 ? 2 : 3;")),
    # 64 q rows a CTA (two groups of 4 warps), one CTA an SM, 3 stages at Dh 32
    "fwd 64-row q tiles": _fwd((FWD_ROWS, "constexpr int kF32Rows = 64;"), (FWD_CTAS, "constexpr int kF32Ctas = 1;"),
                               (FWD_STAGES, "static constexpr int kStages = DH >= 64 ? 2 : 3;")),
    # at Dh 32 one CTA an SM (no register cap), with 2 or 3 ring stages
    "fwd one CTA an SM": _fwd((FWD_CTAS, "constexpr int kF32Ctas = 1;")),
    "fwd one CTA an SM, 3 stages at Dh 32": _fwd((FWD_CTAS, "constexpr int kF32Ctas = 1;"),
                                                 (FWD_STAGES, "static constexpr int kStages = DH >= 64 ? 2 : 3;")),
    # Q's split A fragments loaded and split again each key tile at Dh 32, or held at Dh 64 too
    "fwd Q split each tile": _fwd((FWD_HOLD_Q, "constexpr bool kHoldQ = false;")),
    "fwd Q held at Dh 64": _fwd((FWD_HOLD_Q, "constexpr bool kHoldQ = DH <= 64;")),
    # P V summed over all keys in the tensor cores' accumulators (O rescaled in them)
    "fwd chained P V": _fwd((FWD_PV_SUM, "tf32x3::mma3(acc[d], pa, vb);")),
    # S summed over all of Dh in the accumulators (differs at Dh 64 and 128 only)
    "fwd scores chained": _fwd((CHUNK, "#define kScoreChunk (DH / 8)")),
    # 32-key tiles at every Dh
    "fwd 32-key tiles": _fwd((FWD_TILE, "static constexpr int BK = 32;")),
}

# Back-to-back tf32 products on every SM: mma.sync m16n8k8 on register operands (kChains
# independent accumulators a warp, 8 warps a CTA) and wgmma m64n64k8 from shared memory (one
# warpgroup a CTA, kBatch chained products a commit). Operand values do not change the rate.
RATE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace {

constexpr int kChains = 8;
constexpr int kBatch = 16;

__global__ void __launch_bounds__(256) mma_sync_tf32_kernel(float* out, int iters) {
  const uint32_t x = __float_as_uint(1.0f + threadIdx.x * 1e-3f) & 0xffffe000u;
  const uint32_t a[4] = {x, x, x, x}, b[2] = {x, x};
  float c[kChains][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
                   "{%8, %9}, {%0, %1, %2, %3};\n"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kChains; ++j) sum += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

__device__ __forceinline__ void wgmma_tf32_m64n64k8(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

// A and B: (64, 8) tf32 tiles, K-major rows of 32 bytes with the 32-byte swizzle.
__global__ void __launch_bounds__(128) wgmma_tf32_kernel(float* out, int iters) {
  __shared__ __align__(1024) float a[64 * 8];
  __shared__ __align__(1024) float b[64 * 8];
  for (int i = threadIdx.x; i < 64 * 8; i += 128) a[i] = b[i] = 1.0f + i * 1e-3f;
  sm90::fence_proxy_async();
  __syncthreads();
  const uint64_t da = sm90::make_desc(sm90::smem_u32(a), 16, 8 * 32, 32);
  const uint64_t db = sm90::make_desc(sm90::smem_u32(b), 16, 8 * 32, 32);
  float d[32] = {};
  for (int i = 0; i < iters; ++i) {
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBatch; ++j) wgmma_tf32_m64n64k8(d, da, db);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) sum += d[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

// kind 0: mma.sync (256 threads a CTA), 1: wgmma (128 threads a CTA); out holds a float a thread.
extern "C" int cips_tf32_rate(void* out, int kind, int ctas, int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    mma_sync_tf32_kernel<<<ctas, 256, 0, s>>>(static_cast<float*>(out), iters);
  } else {
    wgmma_tf32_kernel<<<ctas, 128, 0, s>>>(static_cast<float*>(out), iters);
  }
  return static_cast<int>(cudaGetLastError());
}
"""
RATE_ITERS = 4096
RATE_CTAS_PER_SM = 4
# (kind, threads a CTA, operations a CTA an iteration): mma.sync 8 warps x 8 chains x 2 16 8 8;
# wgmma 16 products of 2 64 64 8
RATE_KINDS = {"mma.sync m16n8k8 (register operands)": (0, 256, 8 * 8 * 2 * 16 * 8 * 8),
              "wgmma m64n64k8 (shared memory)": (1, 128, 16 * 2 * 64 * 64 * 8)}


def sources(names=SOURCES) -> Dict[str, str]:
    out = {}
    for name in names:
        with open(os.path.join(cuda_library.CSRC, name), encoding="utf-8") as f:
            out[name] = f.read()
    return out


def build(copies: Dict[str, Edits] = COPIES) -> Tuple[Dict[str, ctypes.CDLL], Dict[str, str]]:
    """One library per entry of ``copies`` of the backward (nvcc jobs in parallel);
    (libraries, each copy's ptxas report)."""
    libs, reports = build_copies(copies, SOURCES, "flash_f32_copies")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.cips_flash_attention_bwd_dq.argtypes = [ptr] * 7 + [i32] * 5 + [ctypes.c_float, ptr]
        lib.cips_flash_attention_bwd_dkv.argtypes = [ptr] * 8 + [i32] * 5 + [ctypes.c_float, ptr]
    return libs, reports


def build_fwd(copies: Dict[str, Edits] = FWD_COPIES) -> Tuple[Dict[str, ctypes.CDLL], Dict[str, str]]:
    """One library per entry of ``copies`` of the forward; (libraries, each copy's ptxas report)."""
    libs, reports = build_copies(copies, FWD_SOURCES, "flash_f32_fwd_copies")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.cips_flash_attention_fwd.argtypes = [ptr] * 5 + [i32] * 5 + [ctypes.c_float, ptr]
    return libs, reports


def registers(report: str) -> str:
    """Registers and spill-store bytes of the fp32 kernels at each Dh in a ptxas report."""
    found = []
    for kernel, dh, body in re.findall(r"Compiling entry function '\S*?flash_(fwd|bwd_dq|bwd_dkv)_tf32x3_kernelILi"
                                       r"(\d+)E\S*' for 'sm_90a'(.*?)(?=Compiling entry|\Z)", report, flags=re.S):
        regs = re.search(r"Used (\d+) registers", body)
        spills = re.search(r"(\d+) bytes spill stores", body)
        found.append(f"{kernel.replace('bwd_', '')}<{dh}> {regs.group(1) if regs else '?'}"
                     + (f" ({spills.group(1)} B spilled)" if spills and spills.group(1) != "0" else ""))
    return "registers " + ", ".join(sorted(found))


def backward(lib: ctypes.CDLL, q, k, v, dout, lse, delta, scale: float, dq, dk, dv) -> None:
    b, h, lq, d = q.shape
    stream = torch.cuda.current_stream().cuda_stream
    cuda_library.check(lib.cips_flash_attention_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                                                       lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b * h, lq,
                                                       k.shape[2], d, 0, scale, stream), "bwd_dq")
    cuda_library.check(lib.cips_flash_attention_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                                                        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                                        b * h, lq, k.shape[2], d, 0, scale, stream), "bwd_dkv")


def forward(lib: ctypes.CDLL, q, k, v, scale: float, out, lse) -> None:
    b, h, lq, d = q.shape
    cuda_library.check(lib.cips_flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                                    lse.data_ptr(), b * h, lq, k.shape[2], d, 0, scale,
                                                    torch.cuda.current_stream().cuda_stream), "fwd")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sdpa_efficient(q, k, v, scale: float):
    """SDPA's fp32 forward pinned to its memory-efficient backend."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return F.scaled_dot_product_attention(q, k, v, scale=scale)


def time_forward(names: List[str]) -> dict:
    """Every forward copy in ``names`` held to the plain forward (and its rounding model) and
    timed at SHAPES beside SDPA's efficient forward, itself held to the plain forward."""
    libs, reports = build_fwd({n: FWD_COPIES[n] for n in names})
    results = {name: {"registers": registers(reports[name])} for name in libs}
    for name in libs:
        print(f"{name}: {results[name]['registers']}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape in SHAPES:
        q, k, v = (torch.randn(shape, device="cuda", generator=g) for _ in range(3))
        scale = shape[-1] ** -0.5
        want_out, want_lse = fa.flash_attention_reference(q, k, v, scale)
        model_out, model_lse = fa.flash_attention_tf32x3_reference(q, k, v, scale)
        peak = want_out.abs().max().item()
        label = "x".join(map(str, shape))
        out, lse = torch.empty_like(q), torch.empty(shape[:3], device="cuda")
        for name, lib in libs.items():
            forward(lib, q, k, v, scale, out, lse)
            torch.cuda.synchronize()
            row = results[name].setdefault(label, {})
            row["err"] = (out - want_out).abs().max().item() / peak
            row["lse_err"] = (lse - want_lse).abs().max().item()
            row["to_model"] = (out - model_out).abs().max().item() / peak
            row["within_limit"] = row["err"] <= TOL_F32_OUT_REL and row["lse_err"] <= TOL_LSE
            if name == "kernel" and not row["within_limit"]:
                raise RuntimeError(f"the fp32 forward kernel misses its limits at {label}: {row}")
            row["ms"] = device_ms(lambda lib=lib: forward(lib, q, k, v, scale, out, lse))
            print(f"{name} {label} fp32 forward: error {row['err']:.3e} of max|out| (to the 3xTF32 model "
                  f"{row['to_model']:.3e}), lse {row['lse_err']:.3e}; within the limits: {row['within_limit']}; "
                  f"{row['ms']:.4f} ms on the device", flush=True)
        sdpa_err = (sdpa_efficient(q, k, v, scale) - want_out).abs().max().item() / peak
        sdpa = device_ms(lambda: sdpa_efficient(q, k, v, scale))
        results.setdefault("sdpa_efficient_fwd_ms", {})[label] = sdpa
        print(f"SDPA efficient forward {label} fp32: error {sdpa_err:.3e} of max|out|; {sdpa:.4f} ms on the device; "
              f"the kernel {results['kernel'][label]['ms'] / sdpa:.3f}x", flush=True)
        del q, k, v, want_out, want_lse, model_out, model_lse, out, lse
    return results


def time_backward(names: List[str]) -> dict:
    """Every backward copy in ``names`` held to the plain backward and timed at SHAPES beside
    SDPA's efficient backward."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    libs, reports = build({n: COPIES[n] for n in names})
    g = torch.Generator(device="cuda").manual_seed(0)
    results = {name: {"registers": registers(reports[name])} for name in libs}
    for name in libs:
        print(f"{name}: {results[name]['registers']}", flush=True)
    for shape in SHAPES:
        q, k, v, dout = (torch.randn(shape, device="cuda", generator=g) for _ in range(4))
        scale = shape[-1] ** -0.5
        _, lse = fa.flash_attention_forward(q, k, v, scale)
        out = fa.flash_attention_reference(q, k, v, scale)[0]
        delta = (dout * out).sum(-1)
        want = (fa.flash_attention_bwd_dq_reference(q, k, v, dout, lse, delta, scale),
                *fa.flash_attention_bwd_dkv_reference(q, k, v, dout, lse, delta, scale))
        got = tuple(torch.empty_like(t) for t in (q, k, v))
        label = "x".join(map(str, shape))
        first = None
        stream = torch.cuda.current_stream().cuda_stream
        for name, lib in libs.items():
            backward(lib, q, k, v, dout, lse, delta, scale, *got)
            torch.cuda.synchronize()
            errs = {n: ((a - b).abs().max() / b.abs().max()).item() for n, a, b in zip(("dq", "dk", "dv"), got, want)}
            row = results[name].setdefault(label, {})
            row["err"] = errs
            first = first or tuple(t.clone() for t in got)  # the unedited kernel's
            row["bit_equal_to_kernel"] = all(torch.equal(a, b) for a, b in zip(got, first))
            row["within_limit"] = max(errs.values()) <= TOL_F32_GRAD_REL
            bh, lq, d = shape[0] * shape[1], shape[2], shape[3]
            row["dq_ms"] = device_ms(lambda lib=lib: cuda_library.check(lib.cips_flash_attention_bwd_dq(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                got[0].data_ptr(), bh, lq, lq, d, 0, scale, stream), "bwd_dq"))
            row["dkv_ms"] = device_ms(lambda lib=lib: cuda_library.check(lib.cips_flash_attention_bwd_dkv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                got[1].data_ptr(), got[2].data_ptr(), bh, lq, lq, d, 0, scale, stream), "bwd_dkv"))
            print(f"{name} {label} fp32: error of max|grad| " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                  + f" (bit-equal to the kernel's: {row['bit_equal_to_kernel']}); dQ {row['dq_ms']:.4f} ms, "
                  f"dK/dV {row['dkv_ms']:.4f} ms, sum {row['dq_ms'] + row['dkv_ms']:.4f}", flush=True)
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
            o = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
            sdpa = device_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), dout, retain_graph=True))
        results.setdefault("sdpa_efficient_bwd_ms", {})[label] = sdpa
        print(f"SDPA efficient backward (dq, dk, dv) {label} fp32: {sdpa:.4f} ms on the device", flush=True)
        del q, k, v, dout, lse, out, delta, want, got, first, qg, kg, vg, o
    return results


def tf32_rate() -> Dict[str, float]:
    """TFLOP/s of back-to-back tf32 products on every SM (RATE_KINDS), CUDA events over one
    launch after a warm-up, against TF32_PEAK."""
    root = os.path.join(cuda_library.BUILD_DIR, "tf32_rate")
    os.makedirs(root, exist_ok=True)
    src, lib_path = os.path.join(root, "rate.cu"), os.path.join(root, "librate.so")
    with open(src, "w", encoding="utf-8") as f:
        f.write(RATE_SOURCE)
    proc = subprocess.run(["/usr/local/cuda/bin/nvcc", *cuda_library.NVCC_FLAGS, "-I", cuda_library.CSRC, "-shared",
                           "-o", lib_path, src], capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the rate probe:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    lib.cips_tf32_rate.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    ctas = torch.cuda.get_device_properties(0).multi_processor_count * RATE_CTAS_PER_SM
    rates = {}
    for label, (kind, threads, ops) in RATE_KINDS.items():
        out = torch.empty(ctas * threads, device="cuda")

        def run(iters: int) -> None:
            cuda_library.check(lib.cips_tf32_rate(out.data_ptr(), kind, ctas, iters,
                                                  torch.cuda.current_stream().cuda_stream), "cips_tf32_rate")

        run(16)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(RATE_ITERS)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        rates[label] = ops * ctas * RATE_ITERS / (ms * 1e-3)
        print(f"tf32 rate, {label}: {ms:.3f} ms for {ops * ctas * RATE_ITERS:.4g} operations on {ctas} CTAs = "
              f"{rates[label] / 1e12:.1f} TFLOP/s, {rates[label] / TF32_PEAK:.1%} of the TF32 peak "
              f"({TF32_PEAK / 1e12:g} TFLOP/s); finite: {bool(torch.isfinite(out).all())}", flush=True)
    return rates


def main(argv: Optional[List[str]] = None) -> dict:
    """Runs the groups and copies named in ``argv`` (everything without arguments) and returns
    their results: {"rate": ..., "fwd": ..., "bwd": ...}."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_flash_f32 needs a CUDA card")
    argv = list(argv or ("rate", "fwd", "bwd"))
    unknown = [a for a in argv if a not in ("rate", "fwd", "bwd") and a not in FWD_COPIES and a not in COPIES]
    if unknown:
        raise ValueError(f"unknown copies {unknown}; the groups are rate, fwd and bwd")
    fwd = [n for n in FWD_COPIES if "fwd" in argv or n in argv]
    bwd = [n for n in COPIES if "bwd" in argv or n in argv]
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card()}")
    results = {}
    if fwd:
        results["fwd"] = time_forward(["kernel", *(n for n in fwd if n != "kernel")])
    if bwd:
        results["bwd"] = time_backward(["kernel", *(n for n in bwd if n != "kernel")])
    if "rate" in argv:
        results["rate"] = tf32_rate()
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
