"""What holds the phase conv's bf16 `full` kernel back: timing-only copies of it,
beside the kernel itself and `noshift`, by device time on one card.

    python -m cips_tpu_torch.scripts.time_full_kernel

Each copy is `csrc/phase_conv_sm90.cu` with the text edits of its entry in COPIES,
built by nvcc beside `csrc/phase_conv.cu` and `csrc/phase_conv_tf32.cu` into a
library of its own under `build/cips_tpu_torch/full_copies/` and called through
`cips_phase_conv`. The
copies that drop work (products, halo-box loads, Wp loads) compute nothing
useful and are for timing only; the other copies are designs that `full` tried
before its own (Wp stages of two k-steps; two 2 KB copies a Wp k-step). The
unedited copy is held to the plain version first. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from cips_tpu_torch.ops import cuda_library
from cips_tpu_torch.ops.phase_conv import VARIANTS, phase_conv_stage_reference
from cips_tpu_torch.ops.s2d import pack_conv_kernel_phase
from cips_tpu_torch.scripts.probe_phase_conv import PROBE, WIDE

SHAPES = (PROBE, WIDE, (2, *PROBE[1:]))  # packed (B, Z, Y, X, 8C); the last is the flagship's level 0 at batch 2
ITERS = 100
TOL_BF16_REL = 1e-2  # of max|out|, against the plain version in fp32, as chip_smoke.py holds the kernel

COPIES: Dict[str, List[Tuple[str, str]]] = {
    "kernel": [],
    "no products": [(
        """                wgmma_ss<128, 1>(acc[i], da[h][i], desc_mn_major<16, 128>(wt + h * (kKStep / 2), 0),
                                 first && h == 0 ? 0 : 1);""", "(void)da;")],
    "no halo loads": [
        ("""            tma_load_5d(smem + sa * kFullABox, &x_map, &full_a[sa], cb * 64, tile.x0 + dx, tile.y0 - 1, tile.z0 - 1,
                        tile.b);""", ""),
        ("mbar_expect_tx(&full_a[sa], kFullABox);", "mbar_expect_tx(&full_a[sa], 0);")],
    "no Wp loads": [
        ("tma_load_4d(dst, &w_map, &full_b[sb], 0, ch, tile.n0 / 64, tap);", ""),
        ("mbar_expect_tx(&full_b[sb], kFullBStage);", "mbar_expect_tx(&full_b[sb], 0);")],
    "Wp stages of 2 k-steps": [("constexpr int kStageSteps = 4;", "constexpr int kStageSteps = 2;")],
    "two 2 KB copies a Wp k-step": [
        ("tma_load_4d(dst, &w_map, &full_b[sb], 0, ch, tile.n0 / 64, tap);",
         "tma_load_3d(dst, &w_map, &full_b[sb], tile.n0, ch, tap);\n"
         "                tma_load_3d(dst + 16 * 64, &w_map, &full_b[sb], tile.n0 + 64, ch, tap);"),
        ("!kstep_map(&w_map, wp, pc)", "!tile_map(&w_map, wp, 8, pc, pc, 16)")],
}


def edited(source: str, edits: List[Tuple[str, str]]) -> str:
    """``source`` with each (old, new) edit applied; each old text must occur exactly once."""
    for old, new in edits:
        if source.count(old) != 1:
            raise ValueError(f"edit target found {source.count(old)} times: {old[:80]!r}")
        source = source.replace(old, new)
    return source


def build_copies(copies: Dict[str, Dict[str, List[Tuple[str, str]]]], sources: Sequence[str], subdir: str,
                 companions: Sequence[str] = ()) -> Tuple[Dict[str, ctypes.CDLL], Dict[str, str]]:
    """One library per entry of ``copies`` under ``build/cips_tpu_torch/{subdir}/``: the files
    ``sources`` of csrc/ (the first a .cu, the others headers that it includes) with the
    entry's text edits ({file: [(old, new), ...]}), written to a directory of their own, so
    that an edited header is found before csrc/'s, and linked with the ``companions`` of
    csrc/ (.cu files, unedited). The nvcc jobs run in parallel; (libraries, each copy's
    nvcc output with ptxas' report)."""
    root = os.path.join(cuda_library.BUILD_DIR, subdir)
    os.makedirs(root, exist_ok=True)
    nvcc = "/usr/local/cuda/bin/nvcc"
    flags = [*cuda_library.NVCC_FLAGS, "-I", cuda_library.CSRC]
    text = {}
    for name in sources:
        with open(os.path.join(cuda_library.CSRC, name), encoding="utf-8") as f:
            text[name] = f.read()

    def compile_job(src: str, obj: str) -> subprocess.Popen:
        return subprocess.Popen([nvcc, *flags, "-c", "-o", obj, src], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    objects = [os.path.join(root, name[:-3] + ".o") for name in companions]
    jobs = {obj: compile_job(os.path.join(cuda_library.CSRC, name), obj) for name, obj in zip(companions, objects)}
    for i, edits in enumerate(copies.values()):
        out = os.path.join(root, f"copy{i}")
        os.makedirs(out, exist_ok=True)
        for name in sources:
            with open(os.path.join(out, name), "w", encoding="utf-8") as f:
                f.write(edited(text[name], edits.get(name, [])))
        jobs[os.path.join(out, "copy.o")] = compile_job(os.path.join(out, sources[0]), os.path.join(out, "copy.o"))
    reports = {}
    for obj, job in jobs.items():
        reports[obj], _ = job.communicate()
        if job.returncode != 0:
            raise RuntimeError(f"nvcc failed on {obj}:\n{reports[obj]}")
    libs, copy_reports = {}, {}
    for i, name in enumerate(copies):
        out = os.path.join(root, f"copy{i}")
        subprocess.run([nvcc, "-shared", "-o", os.path.join(out, "lib.so"), os.path.join(out, "copy.o"), *objects],
                       check=True)
        libs[name] = ctypes.CDLL(os.path.join(out, "lib.so"))
        copy_reports[name] = reports[os.path.join(out, "copy.o")]
    return libs, copy_reports


def build(copies: Dict[str, List[Tuple[str, str]]] = COPIES, subdir: str = "full_copies") -> Dict[str, ctypes.CDLL]:
    """One library per entry of ``copies`` (edits of phase_conv_sm90.cu, linked with
    phase_conv.cu and phase_conv_tf32.cu), each with `cips_phase_conv` declared."""
    libs, _ = build_copies({name: {"phase_conv_sm90.cu": edits} for name, edits in copies.items()},
                           ("phase_conv_sm90.cu",), subdir, companions=("phase_conv.cu", "phase_conv_tf32.cu"))
    for lib in libs.values():
        lib.cips_phase_conv.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return libs


def launch(lib: ctypes.CDLL, x: torch.Tensor, wp: torch.Tensor, out: torch.Tensor, variant: str) -> None:
    rc = lib.cips_phase_conv(x.data_ptr(), wp.data_ptr(), out.data_ptr(), VARIANTS[variant], 1, *x.shape,
                             torch.cuda.current_stream().cuda_stream)
    cuda_library.check(rc, "cips_phase_conv")


def device_ms(fn, iters: int = ITERS) -> float:
    """Device time of one call: each kernel in a torch.profiler trace of ``iters``
    calls after 5 warm-up calls, at its mean duration times its launches a call
    (CUPTI drops a few records now and then); CUDA events if the trace holds none."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    records = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    if records:
        return sum(e.self_device_time_total * (round(e.count / iters) / e.count if round(e.count / iters) else 1 / iters)
                   for e in records) / 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv: Optional[List[str]] = None) -> dict:
    del argv
    if not torch.cuda.is_available():
        raise RuntimeError("time_full_kernel needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    libs = build()
    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for shape in SHAPES:
        p = shape[-1]
        x = torch.randn(shape, device="cuda", generator=g).bfloat16()
        w = (torch.randn((3, 3, 3, p // 8, p // 8), device="cuda", generator=g) * 0.1).bfloat16()
        wp = pack_conv_kernel_phase(w)
        wn = (torch.randn((2, 2, 2, p, p), device="cuda", generator=g) * 0.1).bfloat16()
        out = torch.empty_like(x)
        launch(libs["kernel"], x, wp, out, "full")
        want = phase_conv_stage_reference(x.float(), wp.float(), "full")
        rel = ((out.float() - want).abs().max() / want.abs().max()).item()
        if rel > TOL_BF16_REL:
            raise RuntimeError(f"full disagrees with its plain version at {shape}: {rel:.3e}")
        row = {name: device_ms(lambda lib=lib: launch(lib, x, wp, out, "full")) for name, lib in libs.items()}
        row["noshift"] = device_ms(lambda: launch(libs["kernel"], x, wn, out, "noshift"))
        results[shape] = row
        print(f"{shape} bf16, device ms (/ noshift): full err {rel:.3e} of max|out|; " + "; ".join(
            f"{name} {ms:.4f} ({ms / row['noshift']:.2f}x)" for name, ms in row.items()), flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
