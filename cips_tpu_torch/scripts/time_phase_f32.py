"""The phase conv's fp32 (3xTF32) kernel beside copies of itself with one design choice
changed: error and device time of `full` and `one_tap` on one card.

    python -m cips_tpu_torch.scripts.time_phase_f32 [<copy> ...]

Each copy is `csrc/phase_conv_tf32.cu` with the text edits of its entry in COPIES, built by
`time_full_kernel.build_copies` (one nvcc a copy, all at once) into a library of its own under
`build/cips_tpu_torch/phase_f32_copies/`, linked with `csrc/phase_conv.cu` and
`csrc/phase_conv_sm90.cu`, and called through `cips_phase_conv`. The copies: the products on
`mma.sync` m16n8k8 instead of `wgmma`; A loaded after the products, not under them; longer
sums in the tensor cores (8 weight stages, or the whole sum); no narrower N tiles at small
grids; N tiles of 64 channels at most; no products, no halo-box loads, no weight loads, no
stores (these compute nothing useful: they show where the time goes). At the `stages` probe's
fp32 shapes, (8, 48, 64, 48, 128) and the TPU probe's own (1, 8, 16, 8, 128), TF32 off, each
copy's error (of max|out|, against the plain version in fp32, and its distance to the rounding
model `phase_conv_tf32x3_reference`) and device time (the weight split and the conv) are
printed with ptxas' registers and spills. The unedited kernel must stay within 1e-5 of
max|out|. Without arguments, every copy. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import re
import sys
from typing import Dict, List, Optional, Tuple

import torch

from cips_tpu_torch.ops import cuda_library
from cips_tpu_torch.ops.phase_conv import VARIANTS, phase_conv_stage_reference, phase_conv_tf32x3_reference
from cips_tpu_torch.ops.s2d import pack_conv_kernel_phase
from cips_tpu_torch.scripts.time_flash_f32 import card
from cips_tpu_torch.scripts.time_full_kernel import build_copies, device_ms

SOURCE = "phase_conv_tf32.cu"
SHAPES = ((8, 48, 64, 48, 128), (1, 8, 16, 8, 128))  # packed (B, Z, Y, X, 8C), as chip_smoke.PHASE_F32_SHAPES
VARIANTS_TIMED = ("full", "one_tap")
TOL_F32_REL = 1e-5  # of max|out|, against the plain version in fp32, as chip_smoke.py holds the kernel
CHAIN = "constexpr int kChainStages = 1;"
WGMMA = """      fence_operand(part);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        wgmma_tf32<BN>(part, a[s].big, desc_b(small, s), chain == 0 && s == 0 ? 0 : 1);
        wgmma_tf32<BN>(part, a[s].small, desc_b(big, s), 1);
        wgmma_tf32<BN>(part, a[s].big, desc_b(big, s), 1);
      }
      wgmma_commit();
"""
WGMMA_WAIT = """      wgmma_wait_all();
      fence_operand(part);
"""
# 3xTF32 on mma.sync m16n8k8: warp `warp` takes its 16 rows, B fragments loaded from the split tiles
MMA_SYNC = """      if (chain == 0) {
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
      }
      const float* bb = reinterpret_cast<const float*>(big);
      const float* bs = reinterpret_cast<const float*>(small);
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
          tf32x3::B b;
          b.big[0] = __float_as_uint(bb[tf32x3::at<BN>(8 * n, g, 8 * s, t4)]);
          b.big[1] = __float_as_uint(bb[tf32x3::at<BN>(8 * n, g, 8 * s, t4 + 4)]);
          b.small[0] = __float_as_uint(bs[tf32x3::at<BN>(8 * n, g, 8 * s, t4)]);
          b.small[1] = __float_as_uint(bs[tf32x3::at<BN>(8 * n, g, 8 * s, t4 + 4)]);
          tf32x3::mma3(part[n], a[s], b);
        }
      }
"""
PREFETCH = "      if (more) load_a(next, box, (st + 1) / kTaps, (st + 1) % kTaps);  // under the products\n"
NEXT_A = """      if (more) {
#pragma unroll
        for (int s = 0; s < kSteps; ++s) a[s] = next[s];
      }
"""
PRODUCTS = """        wgmma_tf32<BN>(part, a[s].big, desc_b(small, s), chain == 0 && s == 0 ? 0 : 1);
        wgmma_tf32<BN>(part, a[s].small, desc_b(big, s), 1);
        wgmma_tf32<BN>(part, a[s].big, desc_b(big, s), 1);"""
HALO_LOAD = """          mbar_expect_tx(&full_a[sa], L::kBoxBytes);
          tma_load_5d(smem + sa * L::kABox, &x_map, &full_a[sa], cb * kChunk, tile.x0 + kO, tile.y0 + kO,
                      tile.z0 + kO, tile.b);"""
WEIGHT_LOAD = """            mbar_expect_tx(&full_b[sb], L::kBStage);
            uint8_t* dst = smem + L::kB + sb * L::kBStage;
            tma_load_3d(dst, &w_map, &full_b[sb], cb * kChunk, tile.n0, tap);                   // big
            tma_load_3d(dst + L::kBHalf, &w_map, &full_b[sb], cb * kChunk, tile.n0, kTaps + tap);  // small"""
STORE = "          *reinterpret_cast<float2*>(o + 8 * n) = make_float2(run[n][2 * h], run[n][2 * h + 1]);"
SPLIT_N = "  while (bn > 32 && cell_tiles(b, z, y, xdim) * (pc / bn) < sm_count()) bn /= 2;"

COPIES: Dict[str, List[Tuple[str, str]]] = {
    "kernel": [],
    "mma.sync": [(WGMMA, MMA_SYNC), (WGMMA_WAIT, "")],
    "no A prefetch": [(PREFETCH, ""), (NEXT_A, PREFETCH.replace("next", "a").replace("  // under the products", ""))],
    "8 stages chained": [(CHAIN, "constexpr int kChainStages = 8;")],
    "whole sum chained": [(CHAIN, "constexpr int kChainStages = 1 << 30;")],
    "no N split": [(SPLIT_N, SPLIT_N.replace("while (", "while (false && "))],
    "N tiles of 64": [("constexpr int kMaxN = 128;", "constexpr int kMaxN = 64;")],
    "no products": [(PRODUCTS, "        (void)desc_b(small, s);")],
    "no halo loads": [(HALO_LOAD, "          mbar_expect_tx(&full_a[sa], 0);")],
    "no weight loads": [(WEIGHT_LOAD, "            mbar_expect_tx(&full_b[sb], 0);")],
    "no stores": [(STORE, "          if (v.pc < 0) " + STORE.lstrip())],
}
# the copies that compute the function, held to the plain version
WITH_RESULT = ("kernel", "mma.sync", "no A prefetch", "8 stages chained", "whole sum chained", "no N split",
               "N tiles of 64")


def build(names: List[str]) -> Tuple[Dict[str, ctypes.CDLL], Dict[str, str]]:
    """One library per copy in ``names``; (libraries, each copy's ptxas report)."""
    libs, reports = build_copies({n: {SOURCE: COPIES[n]} for n in names}, (SOURCE,), "phase_f32_copies",
                                 companions=("phase_conv.cu", "phase_conv_sm90.cu"))
    for lib in libs.values():
        lib.cips_phase_conv.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return libs, reports


def registers(report: str) -> str:
    """Registers and spilled bytes of each instantiation of the fp32 kernel in a ptxas report."""
    found = []
    for variant, bn, body in re.findall(r"Compiling entry function '\S*?tf32x3_kernelILi(\d)ELi(\d+)E\S*' for "
                                        r"'sm_90a'(.*?)(?=Compiling entry|\Z)", report, flags=re.S):
        regs = re.search(r"Used (\d+) registers", body)
        spills = re.search(r"(\d+) bytes spill stores", body)
        found.append(f"<{variant},{bn}> {regs.group(1) if regs else '?'}"
                     + (f" ({spills.group(1)} B spilled)" if spills and spills.group(1) != "0" else ""))
    return "registers " + ", ".join(sorted(found))


def launch(lib: ctypes.CDLL, x: torch.Tensor, wp: torch.Tensor, out: torch.Tensor, variant: str) -> None:
    rc = lib.cips_phase_conv(x.data_ptr(), wp.data_ptr(), out.data_ptr(), VARIANTS[variant], 0, *x.shape,
                             torch.cuda.current_stream().cuda_stream)
    cuda_library.check(rc, "cips_phase_conv")


def main(argv: Optional[List[str]] = None) -> dict:
    names = list(argv) if argv else list(COPIES)
    unknown = [n for n in names if n not in COPIES]
    if unknown:
        raise ValueError(f"unknown copies {unknown}; the copies are {list(COPIES)}")
    if not torch.cuda.is_available():
        raise RuntimeError("time_phase_f32 needs a CUDA card")
    print(f"card: {card()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs, reports = build(["kernel", *(n for n in names if n != "kernel")])
    results = {name: {"registers": registers(reports[name])} for name in libs}
    for name in libs:
        print(f"{name}: {results[name]['registers']}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape in SHAPES:
        p = shape[-1]
        x = torch.randn(shape, device="cuda", generator=g)
        w = torch.randn((3, 3, 3, p // 8, p // 8), device="cuda", generator=g) * 0.1
        weights = {"full": pack_conv_kernel_phase(w),  # the real conv, as chip_smoke.py times it
                   "one_tap": torch.randn((2, 2, 2, p, p), device="cuda", generator=g) * 0.1}
        out = torch.empty_like(x)
        label = "x".join(map(str, shape))
        for variant in VARIANTS_TIMED:
            wp = weights[variant]
            want = phase_conv_stage_reference(x, wp, variant)
            model = phase_conv_tf32x3_reference(x, wp, variant)
            peak = want.abs().max().item()
            for name, lib in libs.items():
                row = results[name].setdefault(f"{variant} {label}", {})
                if name in WITH_RESULT:
                    out.zero_()
                    launch(lib, x, wp, out, variant)
                    torch.cuda.synchronize()
                    row["err"] = (out - want).abs().max().item() / peak
                    row["to_model"] = (out - model).abs().max().item() / peak
                    row["within_limit"] = row["err"] <= TOL_F32_REL
                    if name == "kernel" and not row["within_limit"]:
                        raise RuntimeError(f"the fp32 {variant} kernel misses 1e-5 at {label}: {row['err']:.3e}")
                row["ms"] = device_ms(lambda lib=lib, wp=wp: launch(lib, x, wp, out, variant))
                err = (f"error {row['err']:.3e} of max|out| (to the model {row['to_model']:.3e}; within 1e-5: "
                       f"{row['within_limit']}); " if "err" in row else "")
                print(f"{name} {variant} {label} fp32: {err}{row['ms']:.4f} ms on the device", flush=True)
        del x, w, weights, out
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
