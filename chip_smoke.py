"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device   — the card's name and power limit; TF32 off for the fp32 checks;
  2. build    — nvcc builds the flash-attention kernel from cips_tpu_torch/csrc/;
  3. kernel   — the kernel against its plain PyTorch version at the serving
                path's shapes, a ragged L and Dh 64; then its time beside its
                bound, the plain version's time and SDPA's (library yardstick);
  4. serving  — cips_tpu_torch.cli.output_predict at the flagship's full width
                and the full (96, 128, 96) volume in bf16 on a synthetic NIfTI
                tree, with seeded random weights; checks outputs, metrics and
                that the kernel ran 6 times per generator forward; then the
                the same CLI run twice more with each stage of the real path
                clocked, set-up apart; the forward's time and its device time
                by kernel kind (torch.profiler);
  5. parity   — the same fp32 weights on the card (kernel) and on the CPU
                (plain version) at a reduced crop;
  6. summary  — a JSON line of kernels, the card line, and the result line.

Imports nothing of JAX or of the JAX package. Exits non-zero without CUDA.
"""

from __future__ import annotations

import contextlib
import csv
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
STAGED_RUNS = 2  # serving runs after the main path's, each stage clocked
SETUP = ("build model", "restore checkpoint")
CROP = (96, 128, 96)
PARITY_CROP = (32, 64, 32)

# Kernel output limits, relative to max|out| of the plain version (about 0.16
# at L 4608, larger at shorter L, for unit-normal inputs). bf16 rounds P before
# P.V and the output, 2^-9 relative each; the worst measured is about 0.4 %.
# fp32 differs in summation order only.
TOL_BF16_OUT_REL = 1e-2
TOL_F32_OUT_REL = 1e-5
TOL_LSE = 1e-4  # fp32 scores and sums in both dtypes, absolute
# Card vs CPU, full model in fp32: different conv/matmul algorithms and
# summation orders; the JAX package's full-model gate calibrates f32 noise
# at about 1e-3 relative (tests/test_halo_full_model.py).
TOL_MODEL_REL = 1e-3
TOL_METRIC = 1e-3


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


def flash_bound_ms(b: int, h: int, l: int, d: int, elem_bytes: int) -> tuple:
    flops = 4.0 * b * h * l * l * d
    nbytes = 4.0 * b * h * l * d * elem_bytes + b * h * l * 4  # q, k, v, out + lse
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
    counted = fa.flash_attention_forward.launches
    ms = cuda_ms(lambda: fa.flash_attention_forward(q, k, v, scale), 200, warmup=20)
    fa.flash_attention_forward.launches = counted  # timing launches are not the main path's
    plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v, scale), 20)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 200, warmup=20)
    bound, bound_by = flash_bound_ms(*shape, elem_bytes=2)
    print(f"flash {shape} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, "
          f"bound {bound:.5f} ms ({bound_by}); {bound / ms:.1%} of bound")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound, "bound_by": bound_by}


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
    ("flash attention (this port)", ("flash_fwd",)),
    ("convolution (cuDNN)", ("fprop", "conv", "xmma", "implicit_gemm", "cudnn")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "sm90")),
    ("reductions", ("reduce",)),
    ("elementwise, copies, casts", ("elementwise", "copy", "vectorized", "cat", "index")),
)


def profile_forward(generator, x, ctx) -> None:
    """Device time by kernel over one warm generator forward, grouped by kind,
    and the device's busy share of that forward (a second profiled window, so
    the profiler's start-up is outside it)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        torch.cuda.synchronize()
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            generator(x, ctx)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [
        (e.self_device_time_total / 1e3, e.count, e.key)
        for e in prof.key_averages()
        if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
    ]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile: one forward, kernel time {busy:.3f} ms in {wall_ms:.3f} ms wall (profiler on); "
          f"device busy {busy / wall_ms:.1%}; {sum(r[1] for r in rows)} kernel launches")
    kinds = {}
    for ms, count, name in rows:
        kind = next((k for k, keys in KERNEL_KINDS if any(key in name for key in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"profile: {ms:9.3f} ms {ms / busy:6.1%}  {kind}")
    for ms, count, name in rows[:10]:
        print(f"profile: {ms:9.3f} ms {ms / busy:6.1%} x{count:<4d} {name[:110]}")


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
    from cips_tpu_torch.cli import output_predict
    from cips_tpu_torch.cli.common import load_config
    from cips_tpu_torch.data import nifti
    from cips_tpu_torch.ops import flash_attention as fa
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
    fa.build(verbose=True)
    print(f"kernel library built in {time.perf_counter() - t0:.1f} s")

    phase("3 kernel")
    serving_err = kernel_checks(fa)
    kernel_timing(fa, (1, 4, 2304, 32))
    timing = kernel_timing(fa, (SERVING_BATCH, 4, 2304, 32))

    cfg = load_config(None, "training.json")
    with tempfile.TemporaryDirectory() as tmp:
        phase("4 serving")
        tree = write_tree(os.path.join(tmp, "data"), seed=0)
        exp_dir = os.path.join(tmp, "exp")
        generator, _, _ = unet_synthesis.build_models(cfg, FLAGSHIP_K, dtype=torch.float32, device="cpu")
        state = random_state_dict(generator, seed=0)
        ckpt_dir = os.path.join(exp_dir, "conditional", "AV45", "ckpt")
        CheckpointManager(ckpt_dir).save({"unet": state, "discriminator": {}, "epoch": 0}, epoch=0)
        pred_dir = os.path.join(tmp, "pred")
        data_args = [
            "--exp_dir", exp_dir, "--eval_info_csv", tree["csv"], "--PET_dir", tree["pet"],
            "--T1_dir", tree["t1"], "--min_and_max", tree["stats"], "--use_condition",
        ]
        forwards = -(-N_SUBJECTS // SERVING_BATCH)
        serve_args = data_args + ["--dtype", "bf16", "--batch_size", str(SERVING_BATCH), "--device", "cuda"]

        def serve(out_dir: str):
            t0 = time.perf_counter()
            results = output_predict.main(serve_args + ["--output_dir", out_dir])
            torch.cuda.synchronize()
            return results, time.perf_counter() - t0

        fa.flash_attention_forward.launches = 0
        results, elapsed = serve(pred_dir)  # the main path's run
        launches = fa.flash_attention_forward.launches
        summary = results.summary()
        print(f"serving: flash launches {launches} over {forwards} generator forwards; metrics {summary}")
        check(launches == 6 * forwards, f"expected {6 * forwards} flash launches, got {launches}")
        check(all(np.isfinite(v) for v in summary.values()), "non-finite metrics")
        recs = [os.path.join(dp, f) for dp, _, fs in os.walk(pred_dir) for f in fs if f == "rec.nii.gz"]
        check(len(recs) == N_SUBJECTS, f"expected {N_SUBJECTS} rec.nii.gz, found {len(recs)}")
        for path in recs:
            rec = nifti.read_array(path)
            check(rec.shape == CROP and np.isfinite(rec).all() and np.abs(rec).max() > 0,
                  f"{path}: bad output")

        print(f"serving run 1: {N_SUBJECTS} volumes in {elapsed:.3f} s = {N_SUBJECTS / elapsed:.3f} vol/s "
              f"end to end, set-up and the process's first forward included; batch {SERVING_BATCH}, bf16, {card}")
        # The same CLI run again, each stage clocked; set-up (model build and
        # checkpoint restore) is reported apart from the per-volume work.
        for run in range(2, 2 + STAGED_RUNS):
            times = {}
            with stage_clock(times):
                results, elapsed = serve(os.path.join(tmp, f"pred{run}"))
            again = results.summary()
            check(all(np.isclose(again[k], summary[k], rtol=1e-4, atol=0) for k in summary),
                  f"a repeated serving run gave other metrics: {again}")
            setup = sum(sum(times[name]) for name in SETUP) / 1e3
            steady = elapsed - setup
            print(f"serving run {run}: {N_SUBJECTS} volumes in {elapsed:.3f} s = {N_SUBJECTS / elapsed:.3f} vol/s "
                  f"end to end; set-up {setup:.3f} s; without set-up {steady:.3f} s = "
                  f"{N_SUBJECTS / steady:.3f} vol/s; {card}")
            for name, ms in sorted(times.items(), key=lambda kv: -sum(kv[1])):
                print(f"serving run {run} stage: {sum(ms):10.3f} ms total, {len(ms):3d} calls, "
                      f"{sum(ms) / len(ms):9.3f} ms mean, first {ms[0]:9.3f}  {name}")
            print(f"serving run {run} stage: {elapsed * 1e3 - sum(map(sum, times.values())):10.3f} ms total"
                  f"  rest (stacking, host to device, device to host, loop)")
        fa.flash_attention_forward.launches = launches  # the main path's count, as read above

        generator_bf16, _, _ = unet_synthesis.build_models(cfg, FLAGSHIP_K, dtype=torch.bfloat16, device="cuda")
        generator_bf16.load_state_dict(state)
        x = torch.rand((SERVING_BATCH, *CROP, 1), device="cuda")
        ctx = torch.rand((SERVING_BATCH, 1, FLAGSHIP_K), device="cuda")
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: generator_bf16(x, ctx), 5, warmup=2)
        print(f"serving: generator forward {fwd_ms:.3f} ms at batch {SERVING_BATCH} bf16 "
              f"= {SERVING_BATCH / fwd_ms * 1e3:.2f} vol/s (forward only), "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, {card}")
        profile_forward(generator_bf16, x, ctx)
        fa.flash_attention_forward.launches = launches

        phase("5 parity (card vs CPU, fp32)")
        models = {}
        for dev in ("cuda", "cpu"):
            models[dev], _, _ = unet_synthesis.build_models(cfg, FLAGSHIP_K, dtype=torch.float32, device=dev)
            models[dev].load_state_dict(state)
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.random((1, *PARITY_CROP, 1), dtype=np.float32))
        ctx = torch.from_numpy(rng.random((1, 1, FLAGSHIP_K), dtype=np.float32))
        counted = fa.flash_attention_forward.launches
        with torch.inference_mode():
            out_gpu = models["cuda"](x.cuda(), ctx.cuda()).cpu()
            out_cpu = models["cpu"](x, ctx)
        check(fa.flash_attention_forward.launches - counted == 6, "card forward did not run the kernel 6 times")
        fa.flash_attention_forward.launches = counted
        rel = ((out_gpu - out_cpu).abs().max() / out_cpu.abs().max()).item()
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

    phase("6 summary")
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "cips_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "cips_tpu/ops/pallas/flash_attention.py:44",
        "launches": launches,
        "max_abs_err": serving_err,
        **timing,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
