"""The phase conv's `copy` and bf16 `one_tap` kernels beside copies of themselves
with one thing changed, by device time on one card.

    python -m cips_tpu_torch.scripts.time_stage_kernels [copy|one_tap ...]

Each copy is `csrc/phase_conv_sm90.cu` with the text edits of its entry in
COPY_COPIES or ONE_TAP_COPIES, built as `scripts/time_full_kernel.py` builds its
copies (under `build/cips_tpu_torch/stage_copies_*/`) and called through
`cips_phase_conv`. The `copy` copies are other stage sizes, ring depths and CTAs
an SM of the bulk copy, L2 evict-first hints, one contiguous range a CTA, and a
register copy (4 or 8 16-byte loads in flight a thread, streaming loads and
stores); each is held bit-exact to x first and timed beside `x.clone()`. The `one_tap` copies drop work (products, halo-box loads, the
output stores) and compute nothing useful: they show which part of the kernel its
time goes to. The unedited `one_tap` is held to the plain version first. Needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

import torch

from cips_tpu_torch.ops import cuda_library
from cips_tpu_torch.ops.phase_conv import VARIANTS, phase_conv_stage_reference
from cips_tpu_torch.scripts.probe_phase_conv import PROBE, WIDE
from cips_tpu_torch.scripts.time_full_kernel import build, device_ms

SHAPES = (PROBE, WIDE, (2, *PROBE[1:]))  # packed (B, Z, Y, X, 8C), as chip_smoke.py's phase 9
TOL_BF16_REL = 1e-2  # of max|out|, against the plain version in fp32, as chip_smoke.py holds the kernel


def register_copy(in_flight: int) -> List[Tuple[str, str]]:
    """Edits that launch a register copy instead: ``in_flight`` 16-byte vectors loaded a
    thread before any is stored, streaming (evict-first) loads and stores, 8 CTAs of 256
    threads an SM, grid-stride."""
    kernel = f"""
__global__ void __launch_bounds__(256) register_copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                                                            long long n) {{
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  for (; i + {in_flight - 1} * stride < n; i += {in_flight} * stride) {{
    uint4 v[{in_flight}];
#pragma unroll
    for (int u = 0; u < {in_flight}; ++u) v[u] = __ldcs(x + i + u * stride);
#pragma unroll
    for (int u = 0; u < {in_flight}; ++u) __stcs(out + i + u * stride, v[u]);
  }}
  for (; i < n; i += stride) __stcs(out + i, __ldcs(x + i));
}}
"""
    return [
        ("constexpr int kCopyBytes = kCopyStages * kCopyStage + kCopyStages * 8;\n",
         "constexpr int kCopyBytes = kCopyStages * kCopyStage + kCopyStages * 8;\n" + kernel),
        ("""  copy_kernel<<<chunks < ctas ? static_cast<int>(chunks) : ctas, 32, kCopyBytes, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), bytes);""",
         """  (void)chunks;
  (void)ctas;
  register_copy_kernel<<<sm_count() * 8, 256, 0, stream>>>(static_cast<const uint4*>(x), static_cast<uint4*>(out),
                                                           bytes / 16);""")]


# the bulk loads and stores with an L2 evict-first policy
EVICT_FIRST = [
    ("""    bulk_load(copy_smem + st * kCopyStage, x + off, n, &landed[st]);""",
     """    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;"
                 ::"r"(smem_u32(copy_smem + st * kCopyStage)), "l"(x + off), "r"(n), "r"(smem_u32(&landed[st])),
                 "l"(policy) : "memory");"""),
    ("""    bulk_store(out + off, copy_smem + st * kCopyStage, chunk_bytes(off));""",
     """    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;"
                 ::"l"(out + off), "r"(smem_u32(copy_smem + st * kCopyStage)), "r"(chunk_bytes(off)), "l"(policy)
                 : "memory");"""),
]

COPY_COPIES: Dict[str, List[Tuple[str, str]]] = {
    "kernel": [],
    "stages of 8 KB": [("constexpr int kCopyStage = 16384;", "constexpr int kCopyStage = 8192;")],
    "stages of 32 KB": [("constexpr int kCopyStage = 16384;", "constexpr int kCopyStage = 32768;")],
    "ring of 3": [("constexpr int kCopyStages = 2;", "constexpr int kCopyStages = 3;")],
    "ring of 4": [("constexpr int kCopyStages = 2;", "constexpr int kCopyStages = 4;")],
    "1 CTA an SM": [("constexpr int kCopyCtasPerSm = 2;", "constexpr int kCopyCtasPerSm = 1;")],
    "3 CTAs an SM": [("constexpr int kCopyCtasPerSm = 2;", "constexpr int kCopyCtasPerSm = 3;")],
    "4 CTAs an SM": [("constexpr int kCopyCtasPerSm = 2;", "constexpr int kCopyCtasPerSm = 4;")],
    "evict-first loads and stores": EVICT_FIRST,
    "each CTA one contiguous range": [(
        "auto offset = [&](long long i) { return (block + i * grid) * kCopyStage; };",
        "auto offset = [&](long long i) { return ((chunks + grid - 1) / grid * block + i) * kCopyStage; };"), (
        "const long long mine = block < chunks ? (chunks - 1 - block) / grid + 1 : 0;",
        "const long long per = (chunks + grid - 1) / grid;\n"
        "  const long long mine = per * block < chunks ? (chunks - per * block < per ? chunks - per * block : per) : 0;")],
    "register copy, 4 vectors in flight": register_copy(4),
    "register copy, 8 vectors in flight": register_copy(8),
}

ONE_TAP_COPIES: Dict[str, List[Tuple[str, str]]] = {
    "kernel": [],
    "no products": [(
        "wgmma_ss<128, 1>(acc[p], desc_k_major<kHaloRows, L::kBoxC>(rows, j), db, q == 0 && j == 0 ? 0 : 1);",
        "(void)rows;\n            (void)db;")],
    "no halo loads": [(
        """          mbar_expect_tx(&full_a[sa], kHaloRows * L::kBoxC * 2);
          tma_load_5d(ring + sa * L::kBox, &x_map, &full_a[sa], q * L::kBoxC, tile.x0 - (q & 1), tile.y0 - 1,
                      tile.z0 - 1, tile.b);""", "          mbar_expect_tx(&full_a[sa], 0);")],
    "no stores": [(
        """      if (lane == 0) mbar_arrive(&empty_a[(ja - 1) % L::kStages]);

      store_planes(acc, staging, &out_map, tile, wg, tid);""",
        """      if (lane == 0) mbar_arrive(&empty_a[(ja - 1) % L::kStages]);
      if (v.pc < 0) store_planes(acc, staging, &out_map, tile, wg, tid);""")],
}

KERNELS = {"copy": COPY_COPIES, "one_tap": ONE_TAP_COPIES}


def launch(lib: ctypes.CDLL, x: torch.Tensor, wp: Optional[torch.Tensor], out: torch.Tensor, variant: str) -> None:
    rc = lib.cips_phase_conv(x.data_ptr(), 0 if wp is None else wp.data_ptr(), out.data_ptr(), VARIANTS[variant],
                             int(x.dtype == torch.bfloat16), *x.shape, torch.cuda.current_stream().cuda_stream)
    cuda_library.check(rc, "cips_phase_conv")


def main(argv: Optional[List[str]] = None) -> dict:
    kernels = list(argv) if argv else list(KERNELS)
    if not torch.cuda.is_available():
        raise RuntimeError("time_stage_kernels needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {kernel: build(KERNELS[kernel], f"stage_copies_{kernel}") for kernel in kernels}
    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for shape in SHAPES:
        p = shape[-1]
        x = torch.randn(shape, device="cuda", generator=g).bfloat16()
        wp = (torch.randn((2, 2, 2, p, p), device="cuda", generator=g) * 0.1).bfloat16()
        out = torch.empty_like(x)
        row = {}
        if "copy" in libs:
            for name, lib in libs["copy"].items():
                out.zero_()
                launch(lib, x, None, out, "copy")
                if not torch.equal(out, x):
                    raise RuntimeError(f"copy ({name}) does not return x at {shape}")
            row.update({f"copy: {name}": device_ms(lambda lib=lib: launch(lib, x, None, out, "copy"))
                        for name, lib in libs["copy"].items()})
            row["x.clone()"] = device_ms(x.clone)
        if "one_tap" in libs:
            launch(libs["one_tap"]["kernel"], x, wp, out, "one_tap")
            want = phase_conv_stage_reference(x.float(), wp.float(), "one_tap")
            rel = ((out.float() - want).abs().max() / want.abs().max()).item()
            if rel > TOL_BF16_REL:
                raise RuntimeError(f"one_tap disagrees with its plain version at {shape}: {rel:.3e}")
            row.update({f"one_tap: {name}": device_ms(lambda lib=lib: launch(lib, x, wp, out, "one_tap"))
                        for name, lib in libs["one_tap"].items()})
        results[shape] = row
        print(f"{shape} bf16, device ms: " + "; ".join(f"{name} {ms:.4f}" for name, ms in row.items()), flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
