"""Where BMGAN's fp32 train step on the card parts from fp64, under each choice of
convolution back end (the question behind `chip_smoke.py`'s per-network limits
on BMGAN's fp32 gradients):

    python -m cips_tpu_torch.scripts.probe_bmgan_grads [--crop 64 64 64]

One train step (`training/bmgan_task.py`) from random weights, one batch and one
latent, as `chip_smoke.py` phase 12 takes it, runs on the card in fp64 (the
reference), on the CPU in fp32, and on the card in fp32 under each of CONFIGS:
cuDNN as the port runs it, cuDNN restricted to deterministic algorithms, cuDNN
autotuned, and cuDNN off (PyTorch's own im2col + GEMM convolutions). TF32 is off
throughout. For each run it prints every network's whole gradient against the
reference, relative in the 2-norm, and the discriminator's four worst tensors
relative to their max|grad| (leaving out tensors that are 0 in exact math). Two
isolating runs follow: the generator's forward alone (the fake, 2-norm), and the
discriminator's step alone on one fixed input (the reference's fake rounded to
fp32, and the real PET), so that its own rounding is told apart from what
reaches it through the fake.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from cips_tpu_torch.losses import lsgan_discriminator_loss
from cips_tpu_torch.models import bmgan
from cips_tpu_torch.training import bmgan_task

CONFIGS = {
    "cudnn": dict(enabled=True, benchmark=False, deterministic=False),
    "cudnn deterministic": dict(enabled=True, benchmark=False, deterministic=True),
    "cudnn autotuned": dict(enabled=True, benchmark=True, deterministic=False),
    "no cudnn": dict(enabled=False, benchmark=False, deterministic=False),
}
PARTS = {"g": "generator", "e": "encoder", "d": "discriminator"}


def random_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """`chip_smoke.py`'s draw: LeCun-scaled kernels, small biases, norm scales near 1."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, p in model.state_dict().items():
        if name.endswith("weight") and p.ndim >= 2:
            arr = rng.standard_normal(p.shape) / np.sqrt(p[0].numel())
        elif name.endswith("weight"):
            arr = 1.0 + 0.1 * rng.standard_normal(p.shape)
        else:
            arr = 0.1 * rng.standard_normal(p.shape)
        state[name] = torch.from_numpy(arr.astype(np.float32))
    return state


def batch_of(crop, seed: int = 14) -> Dict[str, torch.Tensor]:
    """`chip_smoke.synthetic_batch` at batch 1 without covariates."""
    rng = np.random.default_rng(seed)
    t1 = rng.random((1, *crop, 1), dtype=np.float32)
    pet = np.clip(t1 * 0.8 + 0.1 * rng.random((1, *crop, 1), dtype=np.float32), 0, 1)
    return {"t1": torch.from_numpy(t1), "pet": torch.from_numpy(pet)}


@contextlib.contextmanager
def backend(config: str):
    flags = CONFIGS.get(config, CONFIGS["cudnn"])
    with torch.backends.cudnn.flags(allow_tf32=False, **flags):
        yield


def models_on(weights, crop, device: str, dtype: torch.dtype) -> tuple:
    models = bmgan_task.build_models(dtype=dtype, input_shape=crop, device=device)
    for model, state_dict in zip(models, weights):
        model.load_state_dict(state_dict)
    return models


def latent(dtype, device) -> torch.Tensor:
    return torch.randn((1, bmgan.LATENT_DIM), generator=torch.Generator().manual_seed(5)).to(device, dtype)


def step_grads(weights, batch, crop, device: str, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Every parameter's gradient after one train step, as fp64 CPU tensors."""
    sample_latent = bmgan_task.sample_latent
    bmgan_task.sample_latent = lambda shape, dtype, device, generator: latent(dtype, device)
    try:
        state = bmgan_task.init_state(*models_on(weights, crop, device, dtype))
        bmgan_task.make_train_step()(state, {k: v.to(device) for k, v in batch.items()}, torch.Generator())
    finally:
        bmgan_task.sample_latent = sample_latent
    return {f"{part}.{k}": p.grad.double().cpu() for part in PARTS
            for k, p in getattr(state, part).named_parameters()}


def fake_of(weights, batch, crop, device: str, dtype: torch.dtype) -> torch.Tensor:
    g = models_on(weights, crop, device, dtype)[0]
    with torch.no_grad():
        return g(batch["t1"].to(device, dtype), latent(dtype, device)).double().cpu()


def d_grads(weights, x: torch.Tensor, crop, device: str, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The discriminator's gradients from its LSGAN loss on ``x`` = [fake; real]."""
    d = models_on(weights, crop, device, dtype)[2]
    logits_fake, logits_real = d(x.to(device, dtype)).chunk(2, dim=0)
    lsgan_discriminator_loss(logits_fake, logits_real).backward()
    return {f"d.{k}": p.grad.double().cpu() for k, p in d.named_parameters()}


def distance(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], part: str) -> float:
    keys = [k for k in ref if k.startswith(part + ".")]
    want = torch.cat([ref[k].flatten() for k in keys])
    return ((torch.cat([got[k].flatten() for k in keys]) - want).norm() / want.norm()).item()


def worst(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], part: str, n: int = 4) -> List[Tuple]:
    """The ``n`` tensors furthest from the reference relative to their max|grad|, leaving out
    those under 1e-3 of the network's largest (a conv bias ahead of a norm: 0 in exact math)."""
    keys = [k for k in ref if k.startswith(part + ".")]
    tiny = 1e-3 * max(ref[k].abs().max().item() for k in keys)
    rows = [((got[k] - ref[k]).abs().max().item() / ref[k].abs().max().item(), k)
            for k in keys if ref[k].abs().max().item() >= tiny]
    return sorted(rows, reverse=True)[:n]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--crop", type=int, nargs=3, default=(64, 64, 64))
    crop = tuple(parser.parse_args().crop)
    if not torch.cuda.is_available():
        raise SystemExit("probe_bmgan_grads needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    built = bmgan_task.build_models(dtype=torch.float32, input_shape=crop, device="cpu", seed=4)
    weights = [random_state_dict(model, seed=40 + i) for i, model in enumerate(built[:3])] + [built[3].state_dict()]
    del built
    batch = batch_of(crop)
    runs = [("reference: card fp64", "cuda", torch.float64)] + [(c, "cuda", torch.float32) for c in CONFIGS]
    runs.append(("CPU fp32", "cpu", torch.float32))

    print(f"== train step at {crop}, each network's gradient against the card's fp64 step (2-norm)")
    ref = None
    for name, device, dtype in runs:
        t0 = time.perf_counter()
        with backend(name):
            got = step_grads(weights, batch, crop, device, dtype)
        if ref is None:
            ref = got
            print(f"{name}: {time.perf_counter() - t0:.1f} s")
            continue
        dists = ", ".join(f"{PARTS[p]} {distance(got, ref, p):.3e}" for p in PARTS)
        tops = "; ".join(f"{k} {r:.3e}" for r, k in worst(got, ref, "d"))
        print(f"{name}: {dists} ({time.perf_counter() - t0:.1f} s); discriminator's worst tensors: {tops}")

    print("== generator forward alone: the fake against the card's fp64 fake (2-norm)")
    fake64 = None
    for name, device, dtype in runs:
        with backend(name):
            fake = fake_of(weights, batch, crop, device, dtype)
        if fake64 is None:
            fake64 = fake
            continue
        print(f"{name}: {((fake - fake64).norm() / fake64.norm()).item():.3e}")

    print("== discriminator step alone on one input ([card fp64 fake in fp32; real PET]), against fp64 on it (2-norm)")
    x = torch.cat([fake64.float(), batch["pet"]], dim=0)
    ref = None
    for name, device, dtype in runs:
        with backend(name):
            got = d_grads(weights, x, crop, device, dtype)
        if ref is None:
            ref = got
            continue
        tops = "; ".join(f"{k} {r:.3e}" for r, k in worst(got, ref, "d"))
        print(f"{name}: discriminator {distance(got, ref, 'd'):.3e}; worst tensors: {tops}")


if __name__ == "__main__":
    main()
