"""Correctness and timing of the phase-structured packed conv kernel and its probe
variants (`cips_tpu_torch/ops/phase_conv.py`), the port of the JAX package's TPU
probe scripts:

    python -m cips_tpu_torch.scripts.probe_phase_conv phase
    python -m cips_tpu_torch.scripts.probe_phase_conv dot [dot4d|dot2d|sel]
    python -m cips_tpu_torch.scripts.probe_phase_conv bisect [nosel|sel|full]
    python -m cips_tpu_torch.scripts.probe_phase_conv stages [1|2|3|4]

Without a mode, a subcommand runs all of its modes. It runs on CUDA unless
``--device cpu`` is given (the plain versions then stand in for the kernel, and
times are the CPU's). Kernel times are CUDA events over ITERS launches after
one warm-up; the yardsticks beside them are cuDNN convolutions that this
package never calls: the dense k3 conv over the packed layout with
`pack_conv_kernel`'s weights (the JAX probe's "XLA dense k3") and the same conv
at the unpacked full-grid shape. TF32 is off, so fp32 stays fp32.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from cips_tpu_torch import default_device
from cips_tpu_torch.ops.phase_conv import lane_select, phase_conv, phase_conv_apply, phase_conv_stage
from cips_tpu_torch.ops.s2d import depth_to_space, pack_conv_kernel, pack_conv_kernel_phase, packed_conv, space_to_depth

PHASE_CHECK = (2, 16, 32, 16, 16)  # full-grid (B, D, H, W, C) of the fp32 check
# packed (B, Z, Y, X, 8C): the flagship's level-0 conv (C = 16), also the dot and bisect probes' shape
PROBE = (8, 48, 64, 48, 128)
WIDE = (8, 48, 64, 48, 256)  # the 32-channel case
STAGES = (1, 8, 16, 8, 128)  # the stage-wise debug, fp32
ITERS = 20
TOL_F32 = 1e-4  # absolute, as the JAX probe's fp32 check
TOL_BF16_REL = 1e-2  # of max|out|: both sides round an fp32 sum to bf16 (2^-9 relative each)
MODES = {"dot": ("dot4d", "dot2d", "sel"), "bisect": ("nosel", "sel", "full"), "stages": ("1", "2", "3", "4")}


def timeit(fn: Callable[[], torch.Tensor], device: torch.device, n: int = ITERS) -> float:
    """Mean ms of ``fn`` over ``n`` calls after one warm-up: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n


def _randn(shape, device: torch.device, generator: torch.Generator, scale: float = 1.0) -> torch.Tensor:
    return torch.randn(shape, device=device, generator=generator) * scale


def yardsticks(x: torch.Tensor, w: torch.Tensor) -> Dict[str, Callable[[], torch.Tensor]]:
    """The two cuDNN convolutions the kernel is timed against, on x's data: the
    dense k3 conv over the packed layout (channels last, as a view) with the
    scattered (8C, 8C) kernel, and the unpacked conv at twice the resolution."""
    dense = pack_conv_kernel(w.to(x.dtype)).permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
    packed = x.permute(0, 4, 1, 2, 3)
    full = depth_to_space(x).permute(0, 4, 1, 2, 3).contiguous()
    w_full = w.to(x.dtype).permute(4, 3, 0, 1, 2).contiguous()
    return {"dense k3 packed": lambda: F.conv3d(packed, dense, padding=1),
            "unpacked": lambda: F.conv3d(full, w_full, padding=1)}


def _bf16_case(label: str, shape, device: torch.device, g: torch.Generator) -> dict:
    b, z, y, xd, pc = shape
    c = pc // 8
    x = _randn(shape, device, g).to(torch.bfloat16)
    w = _randn((3, 3, 3, c, c), device, g, 0.1)
    want = packed_conv(x, w).float()
    got = phase_conv(x, w).float()
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    if not rel <= TOL_BF16_REL:
        raise RuntimeError(f"{label}: phase conv disagrees with the packed conv: {rel:.3e} of max|out|")
    wp = pack_conv_kernel_phase(w.to(x.dtype))
    times = {"kernel": timeit(lambda: phase_conv_apply(x, wp), device)}
    times.update({name: timeit(fn, device) for name, fn in yardsticks(x, w).items()})
    print(f"{label} {tuple(shape)} bf16: err {err:.3e} ({rel:.3e} of max|out|); "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()), flush=True)
    return {"err": err, "rel": rel, **times}


def run_phase(device: torch.device) -> dict:
    """Port of scripts/probe_pallas_phase.py: fp32 correctness against the packed
    conv on a full grid, then the flagship level-0 shape and the 32-channel case
    in bf16, each timed against the yardsticks (the TPU tile knob tz is gone)."""
    g = torch.Generator(device=device).manual_seed(0)
    c = PHASE_CHECK[-1]
    x_full = _randn(PHASE_CHECK, device, g)
    w = _randn((3, 3, 3, c, c), device, g, 0.2)
    xp = space_to_depth(x_full)
    err = (packed_conv(xp, w) - phase_conv(xp, w)).abs().max().item()
    print(f"correctness fp32 {tuple(xp.shape)}: max err {err:.2e}", flush=True)
    if not err < TOL_F32:
        raise RuntimeError(f"fp32 phase conv disagrees with the packed conv: {err:.3e}")
    return {"fp32_err": err, "level0": _bf16_case("level 0", PROBE, device, g),
            "wide": _bf16_case("32ch 256->256", WIDE, device, g)}


def run_dot(device: torch.device, modes: List[str]) -> dict:
    """Port of scripts/probe_pallas_dot.py: dot4d and dot2d (out = sum_{k<8} x . W[k];
    on the TPU they differ only in layout, here both are the kernel's dot variant)
    and sel (the lane-select pass alone), at (8, 48, 64, 48, 128) bf16."""
    g = torch.Generator(device=device).manual_seed(0)
    pc = PROBE[-1]
    x = _randn(PROBE, device, g).to(torch.bfloat16)
    w = _randn((8, pc, pc), device, g, 0.1).to(torch.bfloat16)
    flops = 2.0 * 8 * x[..., 0].numel() * pc * pc
    out = {}
    for mode in modes:
        fn = (lambda: lane_select(x)) if mode == "sel" else (lambda: phase_conv_stage(x, w, "dot"))
        ms = timeit(fn, device)
        rate = "" if mode == "sel" else f" ({flops / ms / 1e9:.1f} TFLOP/s issued, 8 dense taps)"
        print(f"{mode}: {ms:.4f} ms{rate}", flush=True)
        out[mode] = ms
    return out


def run_bisect(device: torch.device, modes: List[str]) -> dict:
    """Port of scripts/probe_pallas_bisect.py: nosel (the 8 window products with every
    group shifted by 1, no phase shift), sel (the phase shift alone, no products)
    and full, at (8, 48, 64, 48, 128) bf16."""
    g = torch.Generator(device=device).manual_seed(0)
    pc = PROBE[-1]
    x = _randn(PROBE, device, g).to(torch.bfloat16)
    wp = _randn((2, 2, 2, pc, pc), device, g, 0.1).to(torch.bfloat16)
    out = {}
    for mode in modes:
        variant = {"nosel": "noshift", "sel": "shift", "full": "full"}[mode]
        ms = timeit(lambda: phase_conv_stage(x, None if variant == "shift" else wp, variant), device)
        print(f"{mode}: {ms:.4f} ms", flush=True)
        out[mode] = ms
    return out


def run_stages(device: torch.device, modes: List[str]) -> dict:
    """Port of scripts/debug_pallas_stages.py at (1, 8, 16, 8, 128) fp32: stage 1
    copies x, 2 is the phase shift alone, 3 the tap (0, 0, 0) only, >= 4 the full
    conv. Prints whether each output is finite and its sum; stage 1 must equal x."""
    g = torch.Generator(device=device).manual_seed(0)
    pc = STAGES[-1]
    x = _randn(STAGES, device, g)
    wp = _randn((2, 2, 2, pc, pc), device, g, 0.1)
    out = {}
    for mode in modes:
        variant = {"1": "copy", "2": "shift", "3": "one_tap"}.get(mode, "full")
        got = phase_conv_stage(x, wp if variant in ("one_tap", "full") else None, variant)
        finite, total = bool(torch.isfinite(got).all()), got.sum().item()
        print(f"stage {mode}: finite={finite} sum={total:.4f}", flush=True)
        if mode == "1" and not torch.equal(got, x):
            raise RuntimeError("stage 1 (copy) does not return x")
        out[mode] = {"finite": finite, "sum": total}
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("probe", choices=("phase", "dot", "bisect", "stages"))
    parser.add_argument("mode", nargs="?", default=None, help="one mode of dot, bisect or stages (default: all)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = default_device(args.device)
    if args.probe == "phase":
        if args.mode is not None:
            parser.error("phase takes no mode")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        return run_phase(device)
    modes = MODES[args.probe]
    if args.mode is not None and args.mode not in modes:
        parser.error(f"{args.probe} modes are {modes}")
    run = {"dot": run_dot, "bisect": run_bisect, "stages": run_stages}[args.probe]
    return run(device, list(modes) if args.mode is None else [args.mode])


if __name__ == "__main__":
    main()
