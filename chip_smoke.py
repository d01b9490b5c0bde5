"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device   — the card's name and power limit; TF32 off for the fp32 checks;
  2. build    — nvcc builds the kernel library from cips_tpu_torch/csrc/ (one
                nvcc per source, all at once);
  3. kernels  — the forward kernel and the dQ and dK/dV backward kernels
                against their plain PyTorch versions at the paths' shapes, a
                ragged L and Dh 64; then each kernel's time beside its bound,
                its plain version's time and SDPA's (library yardstick);
  4. serving  — cips_tpu_torch.cli.output_predict at the flagship's full width
                and the full (96, 128, 96) volume in bf16 on a synthetic NIfTI
                tree, with seeded random weights; checks outputs, metrics and
                that the forward kernel ran 6 times per generator forward; then
                the same CLI run once more with each stage of the real path
                clocked, set-up apart; the forward's time and its device time
                by kernel kind (torch.profiler);
  5. parity   — the same fp32 weights on the card (kernels) and on the CPU
                (plain versions) at a reduced crop, forward only;
  6. training — cips_tpu_torch.cli.train_unet at full width and volume in
                bf16, batch 2, for a few epochs with eval and a checkpoint per
                epoch; checks losses, checkpoints and that every train step
                launched 6 forward, 6 dQ and 6 dK/dV kernels; then --resume,
                then output_predict serves the trained checkpoint;
  7. step     — the train step's time (CUDA events) and peak memory, one
                profiled step by kernel kind, and the rec loss falling over
                steps on one fixed batch;
  8. grads    — one fp32 train step from the same random weights on the card
                and on the CPU at the reduced crop: G and D gradients compared;
  9. phase conv — every variant of the phase-structured packed conv kernel
                (csrc/phase_conv.cu: the Pallas phase_conv and its three TPU
                probes) against its plain version at the probes' shapes, in
                fp32 and at a ragged shape; the kernel against the flagship
                generator's own level-0 conv on that conv's input; each
                variant's time beside its bound, its plain version's and the
                cuDNN yardsticks at three shapes; then the slice's main paths:
                each subcommand of `cips_tpu_torch.scripts.probe_phase_conv`,
                its launches counted;
 10. summary  — a JSON line of kernels, the card line, and the result line.

Imports nothing of JAX or of the JAX package. Exits non-zero without CUDA.
"""

from __future__ import annotations

import contextlib
import csv
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FLAGSHIP_K = 5  # AV45 covariates: ABETA, Age, Sex, APOE4, PTEDUCAT
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, SXM, 700 W
H100_BYTES_PER_S = 3.35e12
SERVING_BATCH = 2
N_SUBJECTS = 8
STAGED_RUNS = 1  # serving runs after the main path's, each stage clocked
SETUP = ("build model", "restore checkpoint")
CROP = (96, 128, 96)
PARITY_CROP = (32, 64, 32)
TRAIN_BATCH = 2
TRAIN_EPOCHS = 3  # 4 steps each over 8 subjects: step 10's loss record falls inside
N_EVAL = 2  # subjects of the per-epoch eval
STEPS_TIMED = 14  # train steps clocked after 2 warm-up steps, on one fixed batch
# Phase conv shapes, packed (B, Z, Y, X, 8C): the TPU probes' level-0 shape (C = 16), their
# 32-channel case, and the flagship's own level 0 at batch 2.
PHASE_SHAPES = ((8, 48, 64, 48, 128), (8, 48, 64, 48, 256), (2, 48, 64, 48, 128))
PHASE_CHECKS = ((PHASE_SHAPES[0], torch.bfloat16), (PHASE_SHAPES[1], torch.bfloat16),
                ((2, 8, 16, 8, 128), torch.float32), ((1, 5, 7, 9, 128), torch.bfloat16),
                ((1, 5, 7, 9, 128), torch.float32))  # the last two ragged on every axis
PHASE_VARIANTS = ("full", "noshift", "one_tap", "dot", "shift", "copy", "select")
PHASE_EXACT = ("shift", "copy", "select")  # no sums: the kernel must equal the plain version
PHASE_ROWS = (  # TPU kernel, its line, the probe entry's subcommand that runs it, the variants that port it
    ("phase_conv", "cips_tpu/ops/pallas/phase_conv.py:50", "phase", ("full",)),
    ("probe_pallas_dot", "scripts/probe_pallas_dot.py:34", "dot", ("dot", "select")),
    ("probe_pallas_bisect", "scripts/probe_pallas_bisect.py:30", "bisect", ("noshift", "shift", "full")),
    ("debug_pallas_stages", "scripts/debug_pallas_stages.py:22", "stages", ("one_tap", "shift", "copy", "full")),
)

# Kernel output limits, relative to max|out| of the plain version (about 0.16
# at L 4608, larger at shorter L, for unit-normal inputs). bf16 rounds P before
# P.V and the output, 2^-9 relative each; the worst measured is about 0.4 %.
# fp32 differs in summation order only.
TOL_BF16_OUT_REL = 1e-2
TOL_F32_OUT_REL = 1e-5
TOL_LSE = 1e-4  # fp32 scores and sums in both dtypes, absolute
TRAIN_ATTN = (2, 4, 2304, 32)  # the flagship's attention at training batch 2
# Backward kernel limits, relative to each output's max|grad|, against the plain
# backward computed in fp32 from the same (rounded) inputs. bf16 rounds dS and P
# before their products and the grads at the end (2^-9 relative each), and each
# grad sums L such terms; the worst measured is 5.5e-3 (dQ), so 2e-2 leaves
# about 3.6x. fp32 differs in summation order only.
TOL_BF16_GRAD_REL = 2e-2
TOL_F32_GRAD_REL = 1e-5
# Card vs CPU, full model in fp32: different conv/matmul algorithms and
# summation orders; the JAX package's full-model gate calibrates f32 noise
# at about 1e-3 relative (tests/test_halo_full_model.py).
TOL_MODEL_REL = 1e-3
TOL_METRIC = 1e-3
# One fp32 train step, card vs CPU: each gradient tensor within this share of
# its max|grad| (the forward's full-model limit; measured worst 2e-5); a tensor
# whose max|grad| is under 1e-3 of its network's largest (a conv bias ahead of
# a norm: exactly 0) must stay under that on both sides.
TOL_GRAD_MODEL_REL = 1e-3
TOL_STEP_METRIC_REL = 1e-3  # the step's losses, card vs CPU
# Phase conv product variants against their plain version in fp32 from the same
# inputs, relative to max|out|: bf16 rounds the fp32 sum to bf16 once at the end
# (2^-9 relative) and both sum 8 taps of pc products in other orders; the worst
# measured on an H100 is 3.4e-3. fp32 differs in summation order only (1.8e-6
# measured), and the kernel uses no TF32. The same bf16 limit holds the
# kernel to the flagship's cuDNN conv, which also rounds an fp32 sum to bf16.
TOL_PHASE_BF16_REL = 1e-2
TOL_PHASE_F32_REL = 1e-5


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float) -> tuple:
    """Least time of a function on the card: its operations at the bf16
    tensor-core peak or its bytes (each input read once, each output written
    once) at the memory rate, whichever is longer; (ms, what bounds it)."""
    t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_checks(fa) -> float:
    """Kernel vs the plain version in fp32 on the same inputs; returns the worst
    bf16 error at the serving shape."""
    g = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    cases = [
        ((1, 4, 2304, 32), torch.bfloat16), ((1, 4, 2304, 32), torch.float32),
        ((4, 4, 2304, 32), torch.bfloat16), ((4, 4, 2304, 32), torch.float32),
        ((SERVING_BATCH, 4, 2304, 32), torch.bfloat16),
        ((1, 2, 1000, 32), torch.bfloat16), ((1, 2, 1000, 32), torch.float32),
        ((1, 2, 4608, 64), torch.bfloat16), ((1, 2, 4608, 64), torch.float32),
    ]
    for shape, dtype in cases:
        q, k, v = (torch.randn(shape, device="cuda", generator=g).to(dtype) for _ in range(3))
        scale = shape[-1] ** -0.5
        out, lse = fa.flash_attention_forward(q, k, v, scale)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), scale)
        err = (out.float() - ref_out).abs().max().item()
        rel = err / ref_out.abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol = TOL_BF16_OUT_REL if dtype == torch.bfloat16 else TOL_F32_OUT_REL
        print(f"kernel {shape} {str(dtype)[6:]}: out max abs err {err:.3e}, / max|out| = {rel:.3e} "
              f"(tol {tol:g}), lse max abs err {lse_err:.3e} (tol {TOL_LSE:g})")
        check(torch.isfinite(out).all().item() and rel <= tol and lse_err <= TOL_LSE,
              f"flash kernel disagrees with its plain version at {shape} {dtype}")
        if shape == (SERVING_BATCH, 4, 2304, 32):
            worst = err
    return worst


def kernel_timing(fa, shape) -> dict:
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16) for _ in range(3))
    scale = shape[-1] ** -0.5
    ms = cuda_ms(lambda: fa.flash_attention_forward(q, k, v, scale), 200, warmup=20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v, scale), 20)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 200, warmup=20)
    b, h, l, d = shape
    bound, bound_by = bound_ms(4.0 * b * h * l * l * d, 4 * b * h * l * d * 2 + b * h * l * 4)  # q, k, v, out; lse
    print(f"flash {shape} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, "
          f"bound {bound:.5f} ms ({bound_by}); {bound / ms:.1%} of bound")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound, "bound_by": bound_by}


def counts(fa) -> tuple:
    """(forward, dQ, dK/dV) launch counts."""
    return (fa.flash_attention_forward.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches)


def set_counts(fa, values) -> None:
    (fa.flash_attention_forward.launches, fa.flash_attention_bwd_dq.launches,
     fa.flash_attention_bwd_dkv.launches) = values


@contextlib.contextmanager
def uncounted(fa):
    """Launches inside the block (checks, timing) leave the counts as they were."""
    saved = counts(fa)
    try:
        yield
    finally:
        set_counts(fa, saved)


@contextlib.contextmanager
def step_launches(fa, record: list):
    """Each train step that the train CLI runs inside the block appends its own
    (forward, dQ, dK/dV) launches to ``record``: wraps the step that
    `unet_synthesis.make_train_step` returns."""
    from cips_tpu_torch.training import unet_synthesis

    make_train_step = unet_synthesis.make_train_step

    def counted_make(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def counted(state, batch):
            before = counts(fa)
            out = step(state, batch)
            record.append(tuple(a - b for a, b in zip(counts(fa), before)))
            return out

        return counted

    unet_synthesis.make_train_step = counted_make
    try:
        yield record
    finally:
        unet_synthesis.make_train_step = make_train_step


def bwd_inputs(fa, shape, dtype, seed: int) -> tuple:
    """q, k, v, out, lse from the forward kernel; dO; delta; the scale."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, dout = (torch.randn(shape, device="cuda", generator=g).to(dtype) for _ in range(4))
    scale = shape[-1] ** -0.5
    out, lse = fa.flash_attention_forward(q, k, v, scale)
    delta = (dout.float() * out.float()).sum(-1)
    return q, k, v, out, lse, dout, delta, scale


def bwd_kernel_checks(fa) -> dict:
    """dQ and dK/dV kernels against the plain backward computed in fp32 on the same
    inputs; errors relative to each output's max|grad|. Returns the worst absolute
    errors {"dq": x, "dkv": y} at the training shape in bf16."""
    worst = {}
    cases = [
        (TRAIN_ATTN, torch.bfloat16), (TRAIN_ATTN, torch.float32), ((4, 4, 2304, 32), torch.bfloat16),
        ((1, 2, 1000, 32), torch.bfloat16), ((1, 2, 1000, 32), torch.float32),
        ((1, 2, 4608, 64), torch.bfloat16), ((1, 2, 4608, 64), torch.float32),
    ]
    for i, (shape, dtype) in enumerate(cases):
        q, k, v, out, lse, dout, delta, scale = bwd_inputs(fa, shape, dtype, seed=10 + i)
        got = (fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale),
               *fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale))
        torch.cuda.synchronize()
        f32 = [t.float() for t in (q, k, v, dout)]
        want = (fa.flash_attention_bwd_dq_reference(*f32, lse, delta, scale),
                *fa.flash_attention_bwd_dkv_reference(*f32, lse, delta, scale))
        tol = TOL_BF16_GRAD_REL if dtype == torch.bfloat16 else TOL_F32_GRAD_REL
        errs = []
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            err = (a.float() - b).abs().max().item()
            rel = err / b.abs().max().item()
            errs.append(f"{name} {err:.3e} abs, {rel:.3e} of max|grad| {b.abs().max().item():.3e}")
            check(a.dtype == dtype and torch.isfinite(a).all().item() and rel <= tol,
                  f"{name} kernel disagrees with its plain version at {shape} {dtype}: {rel:.3e} > {tol:g}")
            if shape == TRAIN_ATTN and dtype == torch.bfloat16:
                key = "dq" if name == "dq" else "dkv"
                worst[key] = max(worst.get(key, 0.0), err)
        print(f"bwd kernels {shape} {str(dtype)[6:]} (tol {tol:g} of max|grad|): " + "; ".join(errs))
    return worst


def bwd_kernel_timing(fa, shape) -> dict:
    """Each backward kernel's time beside its bound and its plain version's time;
    SDPA's backward (dq, dk and dv in one call) as the library yardstick."""
    import torch.nn.functional as F

    q, k, v, out, lse, dout, delta, scale = bwd_inputs(fa, shape, torch.bfloat16, seed=1)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    library_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), dout, retain_graph=True),
                         200, warmup=20)
    rows = {}
    for kind, kernel, plain in (
        ("dq", fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dq_reference),
        ("dkv", fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dkv_reference),
    ):
        ms = cuda_ms(lambda: kernel(q, k, v, dout, lse, delta, scale), 200, warmup=20)
        plain_ms = cuda_ms(lambda: plain(q, k, v, dout, lse, delta, scale), 20)
        # dQ does 6 B H L^2 Dh operations, dK/dV 8; each reads q, k, v, dO (bf16)
        # and lse, delta (fp32) and writes its grads (bf16)
        b, h, l, d = shape
        grads = 1 if kind == "dq" else 2
        bound, bound_by = bound_ms((6.0 if kind == "dq" else 8.0) * b * h * l * l * d,
                                   (4 + grads) * b * h * l * d * 2 + 2 * b * h * l * 4)
        print(f"flash bwd {kind} {shape} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"SDPA backward (dq, dk, dv) {library_ms:.4f} ms, bound {bound:.5f} ms ({bound_by}); "
              f"{bound / ms:.1%} of bound")
        rows[kind] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound,
                      "bound_by": bound_by}
    return rows


def phase_inputs(shape, dtype, seed: int) -> tuple:
    """x, the original k3 kernel w (3, 3, 3, C, C), and each product variant's weights
    in x's dtype: full takes pack_conv_kernel_phase(w) (the real conv, 27/64 dense);
    noshift, one_tap and dot take dense random weights, as the TPU probes did."""
    from cips_tpu_torch.ops.s2d import pack_conv_kernel_phase

    g = torch.Generator(device="cuda").manual_seed(seed)
    p = shape[-1]
    x = torch.randn(shape, device="cuda", generator=g).to(dtype)
    w = torch.randn((3, 3, 3, p // 8, p // 8), device="cuda", generator=g) * 0.1
    weights = {"full": pack_conv_kernel_phase(w.to(dtype)), "dot": (torch.randn((8, p, p), device="cuda",
                                                                                 generator=g) * 0.1).to(dtype)}
    for variant in ("noshift", "one_tap"):
        weights[variant] = (torch.randn((2, 2, 2, p, p), device="cuda", generator=g) * 0.1).to(dtype)
    return x, w, weights


def phase_variant(pc, variant: str, x: torch.Tensor, weights: dict) -> tuple:
    """(kernel, plain) callables of one variant on x; the plain one takes the
    dtype to compute in (fp32 for the checks of the product variants)."""
    if variant == "select":
        return (lambda: pc.lane_select(x)), (lambda dtype: pc.lane_select_reference(x.to(dtype)))
    wp = weights.get(variant)
    return ((lambda: pc.phase_conv_stage(x, wp, variant)),
            (lambda dtype: pc.phase_conv_stage_reference(x.to(dtype), None if wp is None else wp.to(dtype), variant)))


def phase_conv_checks(pc) -> dict:
    """Every variant against its plain version on the card: the product variants
    against the plain version in fp32 from the same inputs (relative to max|out|),
    shift, copy and select exactly. Returns each variant's max abs error at the
    probe shape, bf16."""
    worst = {}
    for i, (shape, dtype) in enumerate(PHASE_CHECKS):
        x, _, weights = phase_inputs(shape, dtype, seed=20 + i)
        errs = []
        for variant in PHASE_VARIANTS:
            kernel, plain = phase_variant(pc, variant, x, weights)
            got = kernel()
            torch.cuda.synchronize()
            exact = variant in PHASE_EXACT
            want = plain(dtype if exact else torch.float32)
            err = (got.float() - want.float()).abs().max().item()
            rel = err / want.abs().max().item()
            tol = 0.0 if exact else TOL_PHASE_BF16_REL if dtype == torch.bfloat16 else TOL_PHASE_F32_REL
            errs.append(f"{variant} {err:.3e} ({rel:.3e})")
            check(got.dtype == dtype and got.shape == x.shape and torch.isfinite(got).all().item() and rel <= tol,
                  f"phase conv {variant} disagrees with its plain version at {shape} {dtype}: {rel:.3e} > {tol:g}")
            if shape == PHASE_SHAPES[0] and dtype == torch.bfloat16:
                worst[variant] = err
        print(f"phase conv kernels {shape} {str(dtype)[6:]}: max abs err (/ max|out|) " + ", ".join(errs))
    return worst


def phase_conv_flagship(cfg: dict, state: dict) -> float:
    """The kernel against the flagship generator's own level-0 conv: full width,
    the full volume, batch 2, bf16, seeded random weights; returns the max abs error."""
    from cips_tpu_torch.training import unet_synthesis

    generator, _, _ = unet_synthesis.build_models(cfg, FLAGSHIP_K, dtype=torch.bfloat16, device="cuda")
    generator.load_state_dict(state)
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.rand((SERVING_BATCH, *CROP, 1), device="cuda", generator=g)
    ctx = torch.rand((SERVING_BATCH, 1, FLAGSHIP_K), device="cuda", generator=g)
    got, want = level0_tie(generator, x, ctx)
    err = (got.float() - want.float()).abs().max().item()
    rel = err / want.float().abs().max().item()
    print(f"phase conv vs the flagship's level-0 conv (down_blocks[0].resnets[0].conv1, cuDNN, NCDHW) on its "
          f"own input: packed {tuple(got.shape)} bf16, max abs err {err:.3e} = {rel:.3e} of max|out| "
          f"(tol {TOL_PHASE_BF16_REL:g})")
    check(got.shape == (SERVING_BATCH, *(n // 2 for n in CROP), 128) and rel <= TOL_PHASE_BF16_REL,
          "the phase conv disagrees with the flagship's level-0 conv")
    return err


def phase_conv_timing(pc, shape) -> dict:
    """Each variant's time (CUDA events, 200 launches after 20 warm-up) beside its
    bound, its plain version's time and, where one PyTorch call computes the same
    function, that call's; the two cuDNN yardsticks of the conv at this shape."""
    import torch.nn.functional as F

    from cips_tpu_torch.scripts.probe_phase_conv import yardsticks

    x, w, weights = phase_inputs(shape, torch.bfloat16, seed=30)
    b, z, y, xd, p = shape
    cells, c = b * z * y * xd, p // 8
    xc = x.permute(0, 4, 1, 2, 3)  # channels-last view for cuDNN
    convs = yardsticks(x, w)
    sticks = {name: cuda_ms(fn, 200, warmup=20) for name, fn in convs.items()}
    print(f"phase conv yardsticks {shape} bf16: F.conv3d dense k3 over the packed layout "
          f"{sticks['dense k3 packed']:.4f} ms; F.conv3d at the unpacked {(b, c, 2 * z, 2 * y, 2 * xd)} "
          f"{sticks['unpacked']:.4f} ms")

    def k2_conv(wk2):  # one conv over x padded by 1; its first (Z, Y, X) outputs are the variant's
        wk2 = wk2.contiguous(memory_format=torch.channels_last_3d)
        return lambda: F.conv3d(xc, wk2, padding=1)[:, :, :z, :y, :xd]

    one_tap = torch.zeros((p, p, 2, 2, 2), device="cuda", dtype=x.dtype)
    for q in range(8):  # group q of x'[cell] is x[cell - q]: offset 1 - q of the k2 window
        one_tap[:, q * c:(q + 1) * c, 1 - (q >> 2), 1 - ((q >> 1) & 1), 1 - (q & 1)] = \
            weights["one_tap"][0, 0, 0, q * c:(q + 1) * c].T
    library = {"full": convs["dense k3 packed"],
               "noshift": k2_conv(weights["noshift"].permute(4, 3, 0, 1, 2)), "one_tap": k2_conv(one_tap),
               "dot": lambda: torch.einsum("bzyxi,kio->bzyxo", x, weights["dot"]), "copy": x.clone}
    channels_first = ("full", "noshift", "one_tap")  # the cuDNN calls return (B, pc, Z, Y, X) views
    io_bytes = 2.0 * cells * p * 2  # x read once, out written once
    # The functions' own operations. dot is sum_k x . W[k] = x . (sum_k W[k]): one
    # product per cell plus the sum of W. full and dot also get the count that the
    # kernel issues (8 dense taps), as dense_bound_ms.
    ops = {"full": 2.0 * 27 * c * c * 8 * cells, "noshift": 2.0 * 8 * cells * p * p,
           "dot": 2.0 * cells * p * p + 8.0 * p * p, "one_tap": 2.0 * cells * p * p}
    rows = {}
    for variant in PHASE_VARIANTS:
        kernel, plain = phase_variant(pc, variant, x, weights)
        weight = weights.get(variant)
        bound, bound_by = bound_ms(ops.get(variant, 0.0), io_bytes + (0 if weight is None else weight.numel() * 2))
        ms = cuda_ms(kernel, 200, warmup=20)
        plain_ms = cuda_ms(lambda: plain(x.dtype), 5, warmup=1)
        library_ms = None
        if variant in library:
            lib_out, out = library[variant](), kernel()
            if variant in channels_first:
                lib_out = lib_out.permute(0, 2, 3, 4, 1)
            rel = ((lib_out.float() - out.float()).abs().max() / out.float().abs().max()).item()
            check(lib_out.shape == out.shape and rel <= TOL_PHASE_BF16_REL,
                  f"the library call of {variant} computes another function: {rel:.3e}")
            library_ms = cuda_ms(library[variant], 200, warmup=20)
        rows[variant] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                         "library_ms": library_ms, "unpacked_conv3d_ms": sticks["unpacked"]}
        dense = ""
        if variant in ("full", "dot"):
            rows[variant]["dense_bound_ms"], _ = bound_ms(2.0 * 8 * cells * p * p, io_bytes + weight.numel() * 2)
            dense = f", dense-count bound {rows[variant]['dense_bound_ms']:.5f} ms"
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"phase conv {variant} {shape} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib}, "
              f"bound {bound:.5f} ms ({bound_by}{dense}); {bound / ms:.1%} of bound")
    return rows


def phase_conv_entry(pc) -> dict:
    """The slice's main paths: each subcommand of the probe entry, through its
    `main`, with the launch counts set to 0 just before it and read just after;
    every variant of the row must have launched. Returns {row: {variant: launches}}."""
    from cips_tpu_torch.scripts import probe_phase_conv

    runs = {}
    for name, _, command, variants in PHASE_ROWS:
        pc.phase_conv_stage.launches.clear()
        pc.lane_select.launches = 0
        t0 = time.perf_counter()
        probe_phase_conv.main([command])
        torch.cuda.synchronize()
        launched = {v: pc.lane_select.launches if v == "select" else pc.phase_conv_stage.launches[v] for v in variants}
        print(f"entry `probe_phase_conv {command}` in {time.perf_counter() - t0:.1f} s: launches {launched}")
        check(all(n > 0 for n in launched.values()), f"`probe_phase_conv {command}` did not launch every kernel "
                                                     f"of {name}: {launched}")
        runs[name] = launched
    return runs


def level0_tie(model: torch.nn.Module, x: torch.Tensor, ctx) -> tuple:
    """(phase_conv(space_to_depth(h), w), space_to_depth(conv3d(h, w, padding 1))), no
    bias, for the input h and weight w of the generator's first level-0 k3 conv
    (`down_blocks[0].resnets[0].conv1`, 16 -> 16 in the flagship), h taken by a hook
    in one forward of ``model``. The hook sits on the `Conv` wrapper, which calls
    F.conv3d with `conv.weight` itself rather than the inner nn.Conv3d."""
    import torch.nn.functional as F

    from cips_tpu_torch.ops.phase_conv import phase_conv
    from cips_tpu_torch.ops.s2d import space_to_depth

    conv = model.down_blocks[0].resnets[0].conv1
    seen = {}
    handle = conv.register_forward_pre_hook(lambda module, args: seen.setdefault("h", args[0]))
    try:
        with torch.inference_mode():
            model(x, ctx)
            h = seen["h"]
            w = conv.conv.weight.to(h.dtype)
            want = space_to_depth(F.conv3d(h, w, padding=1).permute(0, 2, 3, 4, 1).contiguous())
            got = phase_conv(space_to_depth(h.permute(0, 2, 3, 4, 1).contiguous()), w.permute(2, 3, 4, 1, 0))
    finally:
        handle.remove()
    return got, want


def random_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Every parameter drawn from a seeded numpy generator, the zero-initialised
    output convs included (else the output is identically 0): LeCun-scaled
    kernels, small biases, norm scales near 1."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, p in model.state_dict().items():
        if name.endswith("weight") and p.ndim >= 2:
            std = 1.0 / np.sqrt(p[0].numel())
            arr = rng.standard_normal(p.shape) * std
        elif name.endswith("weight"):
            arr = 1.0 + 0.1 * rng.standard_normal(p.shape)
        else:
            arr = 0.1 * rng.standard_normal(p.shape)
        state[name] = torch.from_numpy(arr.astype(np.float32))
    return state


def write_tree(root: str, seed: int, shape=(100, 132, 100)) -> dict:
    """Synthetic subjects: a smooth head-like blob plus noise, slightly larger than
    the crop so pad/crop runs; a manifest with AV45 covariates and their stats."""
    from cips_tpu_torch.data import nifti

    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(*(np.linspace(-1, 1, s) for s in shape), indexing="ij")
    rows = []
    for i in range(N_SUBJECTS):
        subj, t1_date, pet_date = f"sub{i:03d}", "2015-01-01", "2015-01-20"
        radius = 0.7 + 0.05 * i
        blob = np.clip(1.0 - (zz**2 + yy**2 + xx**2) / radius**2, 0.0, None)
        for kind, date in (("t1", t1_date), ("pet", pet_date)):
            vol = blob * (1.0 + 0.2 * rng.standard_normal(shape)) + 0.02 * rng.random(shape)
            nifti.write(os.path.join(root, kind, subj, date, "img.nii.gz"), vol.astype(np.float32))
        rows.append({"Subject": subj, "T1_date": t1_date, "PET_date": pet_date, "ABETA": 600 + 200 * i,
                     "Age": 70 + i, "Sex": "Female" if i % 2 else "Male", "APOE4": i % 3, "PTEDUCAT": 12 + i})
    with open(os.path.join(root, "test.csv"), "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    stats = {"ABETA": [200, 1700], "Age": [55, 95], "PTEDUCAT": [6, 20]}
    with open(os.path.join(root, "stats.json"), "w", encoding="utf-8") as f:
        json.dump(stats, f)
    return {"csv": os.path.join(root, "test.csv"), "stats": os.path.join(root, "stats.json"),
            "t1": os.path.join(root, "t1"), "pet": os.path.join(root, "pet")}


KERNEL_KINDS = (  # (kind, substrings of the kernel name), first match wins
    ("flash attention forward (this port)", ("flash_fwd",)),
    ("flash attention backward (this port)", ("flash_bwd",)),
    ("convolution (cuDNN)", ("fprop", "dgrad", "wgrad", "conv", "xmma", "implicit_gemm", "cudnn")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "sm90")),
    ("optimizer (Adam, foreach)", ("multi_tensor",)),
    ("reductions", ("reduce",)),
    ("elementwise, copies, casts", ("elementwise", "copy", "vectorized", "cat", "index")),
)


def profile_window(fn, label: str) -> None:
    """Device time by kernel over one warm call of ``fn``, grouped by kind, and
    the device's busy share of that call (a second profiled window, so the
    profiler's start-up is outside it)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [
        (e.self_device_time_total / 1e3, e.count, e.key)
        for e in prof.key_averages()
        if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
    ]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    check(busy > 0, f"profile {label}: the profiler saw no device time")
    print(f"profile {label}: kernel time {busy:.3f} ms in {wall_ms:.3f} ms wall (profiler on); "
          f"device busy {busy / wall_ms:.1%}; {sum(r[1] for r in rows)} kernel launches")
    kinds = {}
    for ms, count, name in rows:
        kind = next((k for k, keys in KERNEL_KINDS if any(key in name for key in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"profile {label}: {ms:9.3f} ms {ms / busy:6.1%}  {kind}")
    for ms, count, name in rows[:12]:
        print(f"profile {label}: {ms:9.3f} ms {ms / busy:6.1%} x{count:<4d} {name[:110]}")


def subset_manifest(src: str, dst: str, n: int) -> str:
    """The first ``n`` rows of a manifest CSV, written to ``dst``."""
    with open(src, newline="", encoding="utf-8") as f:
        rows = list(itertools.islice(csv.reader(f), n + 1))
    with open(dst, "w", newline="", encoding="utf-8") as f:
        csv.writer(f).writerows(rows)
    return dst


def synthetic_batch(shape, batch: int, device: str, seed: int) -> dict:
    """{"t1", "pet", "info"}: PET a noisy affine function of T1, K covariates."""
    rng = np.random.default_rng(seed)
    t1 = rng.random((batch, *shape, 1), dtype=np.float32)
    pet = np.clip(t1 * 0.8 + 0.1 * rng.random((batch, *shape, 1), dtype=np.float32), 0, 1)
    info = rng.random((batch, 1, FLAGSHIP_K), dtype=np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in (("t1", t1), ("pet", pet), ("info", info))}


def compare_grads(label: str, got: dict, want: dict) -> float:
    """Card gradients against CPU gradients of one network, tensor by tensor
    (limits at TOL_GRAD_MODEL_REL); returns the worst error relative to a
    tensor's max|grad| among the tensors held to that."""
    tiny = 1e-3 * max(w.abs().max().item() for w in want.values())
    worst, worst_name, noise = 0.0, "", 0
    for name, w in want.items():
        g = got[name]
        scale = w.abs().max().item()
        check(torch.isfinite(g).all().item(), f"{label} {name}: non-finite gradient on the card")
        if scale < tiny:
            noise += 1
            check(g.abs().max().item() < tiny, f"{label} {name}: a zero gradient on the CPU is not on the card")
            continue
        rel = (g - w).abs().max().item() / scale
        if rel > worst:
            worst, worst_name = rel, name
    print(f"grads {label}: {len(want)} tensors, worst {worst:.3e} of max|grad| ({worst_name}); "
          f"{noise} tensors of rounding noise only (under {tiny:.3e}); tol {TOL_GRAD_MODEL_REL:g}")
    check(worst <= TOL_GRAD_MODEL_REL, f"{label} gradients disagree between card and CPU: {worst:.3e}")
    return worst


@contextlib.contextmanager
def stage_clock(times: dict):
    """Host-clock time of each stage of the real serving path: wraps the
    functions that output_predict and predict_dataset call, each call ended
    by a synchronize; ``times[stage]`` collects one entry (ms) per call."""
    from cips_tpu_torch.data import nifti
    from cips_tpu_torch.data.dataset import PairedVolumeDataset
    from cips_tpu_torch.inference import predict
    from cips_tpu_torch.training import unet_synthesis
    from cips_tpu_torch.training.common import CheckpointManager

    def timed(stage, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times.setdefault(stage, []).append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    make_predict_fn = unet_synthesis.make_predict_fn
    patches = [
        (unet_synthesis, "build_models", timed(SETUP[0], unet_synthesis.build_models)),
        (CheckpointManager, "restore", timed(SETUP[1], CheckpointManager.restore)),
        (PairedVolumeDataset, "__getitem__", timed("decode + pad/crop, per subject", PairedVolumeDataset.__getitem__)),
        (unet_synthesis, "make_predict_fn",
         lambda *a, **kw: timed(f"generator forward, per batch of {SERVING_BATCH}", make_predict_fn(*a, **kw))),
        (predict, "get_mask", timed("brain mask, per volume", predict.get_mask)),
        *((predict, name, timed("metrics (3 calls per volume)", getattr(predict, name)))
          for name in ("mae", "ms_ssim", "psnr")),
        (nifti, "write", timed("NIfTI gz write (2 per volume)", nifti.write)),
    ]
    saved = [(owner, name, owner.__dict__[name]) for owner, name, _ in patches]
    try:
        for owner, name, fn in patches:
            setattr(owner, name, fn)
        yield times
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 1
    from cips_tpu_torch.cli import output_predict, train_unet
    from cips_tpu_torch.cli.common import load_config
    from cips_tpu_torch.data import nifti
    from cips_tpu_torch.ops import cuda_library
    from cips_tpu_torch.ops import flash_attention as fa
    from cips_tpu_torch.ops import phase_conv as pc
    from cips_tpu_torch.ops.masking import get_mask
    from cips_tpu_torch.ops.metrics import mae, ms_ssim, psnr
    from cips_tpu_torch.training import unet_synthesis
    from cips_tpu_torch.training.common import CheckpointManager

    phase("1 device")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for cuDNN convolutions and matmuls: fp32 checks run in full fp32")

    phase("2 build")
    t0 = time.perf_counter()
    cuda_library.build(verbose=True)
    print(f"kernel library built in {time.perf_counter() - t0:.1f} s")

    phase("3 kernels")
    with uncounted(fa):
        fwd_err = kernel_checks(fa)
        kernel_timing(fa, (1, 4, 2304, 32))
        fwd_timing = kernel_timing(fa, (SERVING_BATCH, 4, 2304, 32))
        bwd_err = bwd_kernel_checks(fa)
        bwd_timing = bwd_kernel_timing(fa, TRAIN_ATTN)

    cfg = load_config(None, "training.json")
    train_cfg = cfg["training"]
    with tempfile.TemporaryDirectory() as tmp:
        phase("4 serving")
        tree = write_tree(os.path.join(tmp, "data"), seed=0)
        exp_dir = os.path.join(tmp, "exp")
        generator, discriminator, _ = unet_synthesis.build_models(cfg, FLAGSHIP_K, dtype=torch.float32, device="cpu")
        state = random_state_dict(generator, seed=0)
        d_state = random_state_dict(discriminator, seed=1)
        ckpt_dir = os.path.join(exp_dir, "conditional", "AV45", "ckpt")
        CheckpointManager(ckpt_dir).save({"unet": state, "discriminator": {}, "epoch": 0}, epoch=0)
        data_args = [
            "--PET_dir", tree["pet"], "--T1_dir", tree["t1"], "--min_and_max", tree["stats"], "--use_condition",
            "--crop_size", *map(str, CROP), "--device", "cuda",
        ]
        forwards = -(-N_SUBJECTS // SERVING_BATCH)
        serve_args = data_args + ["--exp_dir", exp_dir, "--eval_info_csv", tree["csv"], "--dtype", "bf16",
                                  "--batch_size", str(SERVING_BATCH)]

        def serve(args, out_dir: str):
            t0 = time.perf_counter()
            results = output_predict.main(args + ["--output_dir", out_dir])
            torch.cuda.synchronize()
            return results, time.perf_counter() - t0

        def check_served(results, pred_dir: str, n: int) -> list:
            summary = results.summary()
            check(all(np.isfinite(v) for v in summary.values()), f"non-finite metrics {summary}")
            recs = [os.path.join(dp, f) for dp, _, fs in os.walk(pred_dir) for f in fs if f == "rec.nii.gz"]
            check(len(recs) == n, f"expected {n} rec.nii.gz, found {len(recs)}")
            for path in recs:
                rec = nifti.read_array(path)
                check(rec.shape == CROP and np.isfinite(rec).all() and np.abs(rec).max() > 0, f"{path}: bad output")
            return recs

        pred_dir = os.path.join(tmp, "pred")
        set_counts(fa, (0, 0, 0))
        results, elapsed = serve(serve_args, pred_dir)  # the serving path's run
        serving_counts = counts(fa)
        summary = results.summary()
        print(f"serving: launches (forward, dQ, dK/dV) {serving_counts} over {forwards} generator forwards; "
              f"metrics {summary}")
        check(serving_counts == (6 * forwards, 0, 0), f"expected {(6 * forwards, 0, 0)} launches, got {serving_counts}")
        recs = check_served(results, pred_dir, N_SUBJECTS)
        print(f"serving run 1: {N_SUBJECTS} volumes in {elapsed:.3f} s = {N_SUBJECTS / elapsed:.3f} vol/s "
              f"end to end, set-up and the process's first forward included; batch {SERVING_BATCH}, bf16, {card}")

        with uncounted(fa):
            # The same CLI run again, each stage clocked; set-up (model build and
            # checkpoint restore) is reported apart from the per-volume work.
            for run in range(2, 2 + STAGED_RUNS):
                times = {}
                with stage_clock(times):
                    results, elapsed = serve(serve_args, os.path.join(tmp, f"pred{run}"))
                again = results.summary()
                check(all(np.isclose(again[k], summary[k], rtol=1e-4, atol=0) for k in summary),
                      f"a repeated serving run gave other metrics: {again}")
                setup = sum(sum(times[name]) for name in SETUP) / 1e3
                steady = elapsed - setup
                print(f"serving run {run}: {N_SUBJECTS} volumes in {elapsed:.3f} s = {N_SUBJECTS / elapsed:.3f} "
                      f"vol/s end to end; set-up {setup:.3f} s; without set-up {steady:.3f} s = "
                      f"{N_SUBJECTS / steady:.3f} vol/s; {card}")
                for name, ms in sorted(times.items(), key=lambda kv: -sum(kv[1])):
                    print(f"serving run {run} stage: {sum(ms):10.3f} ms total, {len(ms):3d} calls, "
                          f"{sum(ms) / len(ms):9.3f} ms mean, first {ms[0]:9.3f}  {name}")
                print(f"serving run {run} stage: {elapsed * 1e3 - sum(map(sum, times.values())):10.3f} ms total"
                      f"  rest (stacking, host to device, device to host, loop)")

            generator_bf16, _, _ = unet_synthesis.build_models(cfg, FLAGSHIP_K, dtype=torch.bfloat16, device="cuda")
            generator_bf16.load_state_dict(state)
            x = torch.rand((SERVING_BATCH, *CROP, 1), device="cuda")
            ctx = torch.rand((SERVING_BATCH, 1, FLAGSHIP_K), device="cuda")

            def forward():
                with torch.inference_mode():
                    generator_bf16(x, ctx)

            torch.cuda.reset_peak_memory_stats()
            fwd_ms = cuda_ms(forward, 5, warmup=2)
            print(f"serving: generator forward {fwd_ms:.3f} ms at batch {SERVING_BATCH} bf16 "
                  f"= {SERVING_BATCH / fwd_ms * 1e3:.2f} vol/s (forward only), "
                  f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, {card}")
            profile_window(forward, "forward")
            del generator_bf16

        phase("5 parity (card vs CPU, fp32 forward)")
        models = {}
        for dev in ("cuda", "cpu"):
            models[dev], _, _ = unet_synthesis.build_models(cfg, FLAGSHIP_K, dtype=torch.float32, device=dev)
            models[dev].load_state_dict(state)
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.random((1, *PARITY_CROP, 1), dtype=np.float32))
        ctx = torch.from_numpy(rng.random((1, 1, FLAGSHIP_K), dtype=np.float32))
        before = counts(fa)
        with uncounted(fa), torch.inference_mode():
            out_gpu = models["cuda"](x.cuda(), ctx.cuda()).cpu()
            out_cpu = models["cpu"](x, ctx)
            check(counts(fa)[0] - before[0] == 6, "card forward did not run the kernel 6 times")
        rel = ((out_gpu - out_cpu).abs().max() / out_cpu.abs().max()).item()
        del models
        print(f"parity: fp32 generator {PARITY_CROP} card vs CPU max abs err / max |out| = {rel:.3e} "
              f"(tol {TOL_MODEL_REL:g})")
        check(torch.isfinite(out_gpu).all().item() and rel <= TOL_MODEL_REL, "card and CPU forwards disagree")
        real = torch.from_numpy(nifti.read_array(recs[0]).astype(np.float32))
        metrics = {}
        for dev in ("cuda", "cpu"):
            r = real.to(dev)
            fake = (r * 0.9 + 0.05 * torch.sin(r * 7.0)) * get_mask(r).float()
            metrics[dev] = [mae(fake, r).item(), ms_ssim(fake, r, kernel_size=5, sigma=0.5).item(),
                            psnr(fake, r).item()]
        diff = max(abs(a - b) for a, b in zip(metrics["cuda"], metrics["cpu"]))
        print(f"parity: mask + MAE/MS-SSIM/PSNR card {metrics['cuda']} vs CPU {metrics['cpu']}, "
              f"max diff {diff:.3e} (tol {TOL_METRIC:g})")
        check(diff <= TOL_METRIC, "card and CPU metrics disagree")

        phase("6 training")
        train_exp = os.path.join(tmp, "train_exp")
        eval_csv = subset_manifest(tree["csv"], os.path.join(tmp, "eval.csv"), N_EVAL)
        train_args = data_args + [
            "--exp_dir", train_exp, "--training_info_csv", tree["csv"], "--eval_info_csv", eval_csv,
            "--dtype", "bf16", "--batch_size", str(TRAIN_BATCH), "--save_every", "1",
        ]
        steps_per_epoch = N_SUBJECTS // TRAIN_BATCH
        per_step = []
        set_counts(fa, (0, 0, 0))
        t0 = time.perf_counter()
        with step_launches(fa, per_step):
            trained = train_unet.main(train_args + ["--epochs", str(TRAIN_EPOCHS)])
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        train_counts = counts(fa)  # the training path's run
        steps = trained.step
        expected = (6 * (steps + TRAIN_EPOCHS * N_EVAL), 6 * steps, 6 * steps)  # eval: one forward per subject
        print(f"training: {steps} steps and {TRAIN_EPOCHS} evals of {N_EVAL} subjects in {train_wall:.3f} s "
              f"({steps / train_wall:.3f} steps/s end to end: decode, eval, NIfTI dumps and checkpoints "
              f"included); launches (forward, dQ, dK/dV) {train_counts}; per step {sorted(set(per_step))}; {card}")
        check(steps == TRAIN_EPOCHS * steps_per_epoch, f"expected {TRAIN_EPOCHS * steps_per_epoch} steps, got {steps}")
        check(len(per_step) == steps and set(per_step) == {(6, 6, 6)},
              f"every train step must launch 6 forward, 6 dQ and 6 dK/dV kernels: {per_step}")
        check(train_counts == expected, f"expected {expected} launches, got {train_counts}")
        base = os.path.join(train_exp, "conditional", "AV45")
        records = [json.loads(line) for line in open(os.path.join(base, "log", "metrics.jsonl"), encoding="utf-8")]
        print(f"training: metric records {records}")
        check([r["prefix"] for r in records].count("training") == steps // 10, "missing loss records")
        check(all(np.isfinite(v) for r in records for k, v in r.items() if k != "prefix"), "non-finite losses")
        with open(os.path.join(base, "ckpt", "meta.json"), encoding="utf-8") as f:
            meta = json.load(f)
        print(f"training: meta.json {meta}")
        check(meta["last_epoch"] == TRAIN_EPOCHS - 1 and np.isfinite(meta["best_metric"]), f"bad meta.json {meta}")
        for e in range(TRAIN_EPOCHS):
            check(os.path.exists(os.path.join(base, "ckpt", f"epoch_{e}")), f"no checkpoint of epoch {e}")
            check(nifti.read_array(os.path.join(base, "visual", f"epoch{e}_rec.nii.gz")).shape == CROP,
                  f"no eval dump of epoch {e}")
        del trained

        with uncounted(fa):
            set_counts(fa, (0, 0, 0))
            resumed = train_unet.main(train_args + ["--epochs", str(TRAIN_EPOCHS + 1), "--resume"])
            resume_counts = counts(fa)
        expected = (6 * (steps_per_epoch + N_EVAL), 6 * steps_per_epoch, 6 * steps_per_epoch)
        print(f"training: --resume ran epoch {TRAIN_EPOCHS} to step {resumed.step}; launches {resume_counts}")
        check(resumed.step == steps + steps_per_epoch and resume_counts == expected,
              f"resume: step {resumed.step}, launches {resume_counts}, expected {expected}")
        check(CheckpointManager(os.path.join(base, "ckpt")).latest_epoch() == TRAIN_EPOCHS, "resume saved no epoch")
        del resumed

        with uncounted(fa):
            set_counts(fa, (0, 0, 0))
            trained_pred = os.path.join(tmp, "pred_trained")
            results, _ = serve(data_args + ["--exp_dir", train_exp, "--eval_info_csv", eval_csv, "--dtype", "bf16",
                                            "--batch_size", str(SERVING_BATCH)], trained_pred)
            check(counts(fa) == (6, 0, 0), f"serving the trained checkpoint: launches {counts(fa)}")
        check_served(results, trained_pred, N_EVAL)
        print(f"training: the trained checkpoint served {N_EVAL} subjects, metrics {results.summary()}")

        phase("7 train step")
        step_fn = unet_synthesis.make_train_step(train_cfg)
        batch = synthetic_batch(CROP, TRAIN_BATCH, "cuda", seed=3)
        with uncounted(fa):
            g_bf16, d_bf16, _ = unet_synthesis.build_models(cfg, FLAGSHIP_K, dtype=torch.bfloat16, device="cuda")
            gan = unet_synthesis.init_state(g_bf16, d_bf16, train_cfg)
            torch.cuda.reset_peak_memory_stats()
            recs_loss = [step_fn(gan, batch)["rec_loss"] for _ in range(2)]  # warm-up
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            timed = [step_fn(gan, batch) for _ in range(STEPS_TIMED)]
            end.record()
            torch.cuda.synchronize()
            step_ms = start.elapsed_time(end) / STEPS_TIMED
            peak = torch.cuda.max_memory_allocated() / 2**30
            losses = [float(r) for r in recs_loss + [m["rec_loss"] for m in timed]]
            print(f"train step: {step_ms:.3f} ms at batch {TRAIN_BATCH} bf16 = {1e3 / step_ms:.3f} steps/s "
                  f"= {TRAIN_BATCH * 1e3 / step_ms:.3f} vol/s (CUDA events over {STEPS_TIMED} steps after 2 "
                  f"warm-up, one fixed batch, no data loading); peak memory {peak:.2f} GiB of 80, no remat; {card}")
            print(f"train step: rec loss over {len(losses)} steps on one batch: {[round(v, 6) for v in losses]}; "
                  f"last metrics {({k: float(v) for k, v in timed[-1].items()})}")
            check(all(np.isfinite(float(v)) for m in timed for v in m.values()), "non-finite train-step metrics")
            check(losses[-1] < losses[0], "the rec loss did not fall on a fixed batch")
            profile_window(lambda: step_fn(gan, batch), "train step")
            del gan, g_bf16, d_bf16, timed

        phase("8 grads (card vs CPU, fp32 train step)")
        got = {}
        small = synthetic_batch(PARITY_CROP, 1, "cpu", seed=4)
        for dev in ("cuda", "cpu"):
            g32, d32, _ = unet_synthesis.build_models(cfg, FLAGSHIP_K, dtype=torch.float32, device=dev)
            g32.load_state_dict(state)
            d32.load_state_dict(d_state)
            gan = unet_synthesis.init_state(g32, d32, train_cfg)
            before = counts(fa)
            with uncounted(fa):
                step_metrics = step_fn(gan, {k: v.to(dev) for k, v in small.items()})
                launched = tuple(a - b for a, b in zip(counts(fa), before))
            check(launched == ((6, 6, 6) if dev == "cuda" else (0, 0, 0)), f"{dev} step launches {launched}")
            got[dev] = ({k: float(v) for k, v in step_metrics.items()},
                        {n: p.grad.cpu() for n, p in g32.named_parameters()},
                        {n: p.grad.cpu() for n, p in d32.named_parameters()})
        print(f"grads: step metrics card {got['cuda'][0]} vs CPU {got['cpu'][0]}")
        for key, want in got["cpu"][0].items():
            rel = abs(got["cuda"][0][key] - want) / max(abs(want), 1e-12)
            check(rel <= TOL_STEP_METRIC_REL, f"train-step {key} card vs CPU: {rel:.3e} > {TOL_STEP_METRIC_REL:g}")
        compare_grads("generator", got["cuda"][1], got["cpu"][1])
        compare_grads("discriminator", got["cuda"][2], got["cpu"][2])

    phase("9 phase conv")
    with uncounted(fa):
        t0 = time.perf_counter()
        phase_err = phase_conv_checks(pc)
        phase_err["full"] = max(phase_err["full"], phase_conv_flagship(cfg, state))
        phase_timing = {shape: phase_conv_timing(pc, shape) for shape in PHASE_SHAPES}
        print(f"phase conv checks and timing in {time.perf_counter() - t0:.1f} s")
        entry_launches = phase_conv_entry(pc)

    phase("10 summary")
    kernels = []
    for name, replaces, launches, err, timing in (
        ("flash_attention_fwd", "cips_tpu/ops/pallas/flash_attention.py:44", train_counts[0], fwd_err, fwd_timing),
        ("flash_attention_bwd_dq", "cips_tpu/ops/pallas/flash_attention.py:123", train_counts[1], bwd_err["dq"],
         bwd_timing["dq"]),
        ("flash_attention_bwd_dkv", "cips_tpu/ops/pallas/flash_attention.py:164", train_counts[2], bwd_err["dkv"],
         bwd_timing["dkv"]),
    ):
        source = "cips_tpu_torch/csrc/" + ("flash_attention_fwd.cu" if name.endswith("fwd") else "flash_attention_bwd.cu")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches, "max_abs_err": err, **timing})
    probe = PHASE_SHAPES[0]
    for name, replaces, _, variants in PHASE_ROWS:
        head = phase_timing[probe][variants[0]]  # the row's first variant at the probe shape
        kernels.append({
            "name": name, "route": "cuda", "source": "cips_tpu_torch/csrc/phase_conv.cu", "replaces": replaces,
            "launches": sum(entry_launches[name].values()), "max_abs_err": max(phase_err[v] for v in variants),
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "dense_bound_ms")
               if k in head},
            "variants": {v: {"launches": entry_launches[name][v], "max_abs_err": phase_err[v],
                             "at": {"x".join(map(str, shape)): {k: round(t, 6) if isinstance(t, float) else t
                                                               for k, t in phase_timing[shape][v].items()}
                                    for shape in PHASE_SHAPES}}
                         for v in variants},
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
