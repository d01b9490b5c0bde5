"""The fp32 flash backward (3xTF32 dQ and dK/dV kernels) beside copies of itself with
one design choice changed: error and device time on one card.

    python -m cips_tpu_torch.scripts.time_flash_f32

Each copy is `csrc/flash_attention_bwd.cu` and `csrc/mma_tf32.cuh` with the text edits
of its entry in COPIES, built by nvcc into a library of its own under
`build/cips_tpu_torch/flash_f32_copies/` and called through its
`cips_flash_attention_bwd_dq` and `cips_flash_attention_bwd_dkv`. Every copy computes
the same function, so each is held to the plain backward in fp32 (its error printed,
of each max|grad|) and timed by device time at the flagship's attention (2, 4, 2304,
32), at the causal generator's 18,432 tokens (1, 1, 18432, 32) and at Dh 64 and 128,
beside SDPA's fp32 (memory-efficient) backward. Prints each copy's registers and
spills (ptxas) at Dh 32, 64 and 128. Arguments name the copies to build (the unedited
kernel always); without them, every copy. Needs a CUDA card and nvcc.
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
TOL_F32_GRAD_REL = 1e-5  # of max|grad|, against the plain backward, as chip_smoke.py holds the kernels

Edits = Dict[str, List[Tuple[str, str]]]  # source file -> (old, new) text edits
DQ_SUM = "tf32x3::mma3(part[d], dsa, kb);"
DV_SUM = "tf32x3::mma3(dv_part[d], pa, ob);"
DK_SUM = "tf32x3::mma3(dk_part[d], dsa, qb);"
CHUNK = "constexpr int kScoreChunk = 4;"
HOLD_A = "constexpr bool kHoldA = DH == 32;"
DQ_TILE = "static constexpr int BK = DH >= 128 ? 32 : 64;"
DKV_TILE = "static constexpr int BQ = DH >= 64 ? 32 : 64;"
SLICES = "static constexpr int kSlices = DH >= 128 ? 2 : 1;"


def _bwd(*edits: Tuple[str, str]) -> Edits:
    return {"flash_attention_bwd.cu": list(edits)}


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


def sources() -> Dict[str, str]:
    out = {}
    for name in SOURCES:
        with open(os.path.join(cuda_library.CSRC, name), encoding="utf-8") as f:
            out[name] = f.read()
    return out


def build(copies: Dict[str, Edits] = COPIES) -> Tuple[Dict[str, ctypes.CDLL], Dict[str, str]]:
    """One library per entry of ``copies`` (nvcc jobs in parallel); (libraries, each
    copy's ptxas report)."""
    libs, reports = build_copies(copies, SOURCES, "flash_f32_copies")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.cips_flash_attention_bwd_dq.argtypes = [ptr] * 7 + [i32] * 5 + [ctypes.c_float, ptr]
        lib.cips_flash_attention_bwd_dkv.argtypes = [ptr] * 8 + [i32] * 5 + [ctypes.c_float, ptr]
    return libs, reports


def registers(report: str) -> str:
    """Registers and spill-store bytes of the fp32 dQ and dK/dV kernels at each Dh in a ptxas report."""
    found = []
    for kernel, dh, body in re.findall(r"Compiling entry function '\S*?flash_bwd_(dq|dkv)_tf32x3_kernelILi(\d+)E\S*' "
                                       r"for 'sm_90a'(.*?)(?=Compiling entry|\Z)", report, flags=re.S):
        regs = re.search(r"Used (\d+) registers", body)
        spills = re.search(r"(\d+) bytes spill stores", body)
        found.append(f"{kernel}<{dh}> {regs.group(1) if regs else '?'}"
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


def main(argv: Optional[List[str]] = None) -> dict:
    """Builds the copies named in ``argv`` (all of COPIES without arguments; "kernel" always),
    prints and returns their errors, device times and registers."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_flash_f32 needs a CUDA card")
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    names = ["kernel", *(n for n in (argv or COPIES) if n != "kernel")]
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
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


if __name__ == "__main__":
    main(sys.argv[1:])
