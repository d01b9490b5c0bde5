"""The benchmark's inputs from ``--seed``: the training store a traffic file
describes, the order in which a shuffled loader must serve it, and the weights
of every network.

A traffic file (``portbench/traffic/<name>.json``) holds:
  feed       the module of `portbench.feeds` that serves the store to the program;
  subjects   pairs in the store;
  batch      the node batch (every rank's rows of it together);
  pet_gain, pet_noise
             PET = clip(pet_gain * T1 + pet_noise * U(0, 1), 0, 1), T1 ~ U(0, 1) a voxel,
             as the port's smoke test draws its pairs; a gain [lo, hi] draws each
             subject's from U(lo, hi) (uptake that differs from subject to subject);
the volume and the covariate count come from the configuration.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from portbench.reference import lpips as ref_lpips


def make_store(traffic: Mapping, volume: Sequence[int], covariates: int, seed: int,
               device: torch.device) -> Dict[str, np.ndarray]:
    """{"volumes": (N, 2, D, H, W) float16, T1 then PET; "covariates": (N, K) float32},
    drawn on ``device`` from a generator seeded with ``seed``, one modality at a time."""
    n = int(traffic["subjects"])
    g = torch.Generator(device).manual_seed(seed)
    vols = torch.empty((n, 2, *volume), dtype=torch.float16, device=device)
    t1 = torch.rand((n, *volume), generator=g, device=device)
    vols[:, 0] = t1
    gain = traffic["pet_gain"]
    if isinstance(gain, list):
        lo, hi = gain
        gain = (lo + (hi - lo) * torch.rand((n,), generator=g, device=device)).view(n, *(1,) * len(volume))
    t1.mul_(gain).add_(torch.rand((n, *volume), generator=g, device=device),
                       alpha=float(traffic["pet_noise"])).clamp_(0, 1)
    vols[:, 1] = t1
    del t1
    info = torch.rand((n, covariates), generator=g, device=device)
    return {"volumes": vols.cpu().numpy(), "covariates": info.cpu().numpy()}


def batch_rows(seed: int, epoch: int, subjects: int, batch: int) -> List[np.ndarray]:
    """The store rows of each batch of ``epoch`` as a shuffled loader over the
    store must serve them: a permutation by ``np.random.default_rng(seed + epoch)``,
    whole batches of it, each sorted."""
    order = np.arange(subjects)
    np.random.default_rng(seed + epoch).shuffle(order)
    return [np.sort(order[b * batch:(b + 1) * batch]) for b in range(subjects // batch)]


def samples(store: Mapping[str, np.ndarray], rows: Sequence[int], device: torch.device) -> List[Dict[str, torch.Tensor]]:
    """One fp32 sample {"t1", "pet": (1, D, H, W, 1), "info": (1, 1, K)} a row."""
    out = []
    for r in rows:
        vol = torch.from_numpy(store["volumes"][r].astype(np.float32)).to(device)
        out.append({"t1": vol[0][None, ..., None], "pet": vol[1][None, ..., None],
                    "info": torch.from_numpy(store["covariates"][r]).to(device)[None, None]})
    return out


def make_weights(model: nn.Module, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """fp32 weights for every parameter of ``model`` (a reference built on the
    meta device), keyed by its names: conv and dense kernels normal with
    standard deviation fan_in ** -0.5, all drawn in one call from a generator
    seeded with ``seed``; zero biases, unit norm scales, LPIPS lin weights 1/C."""
    kernels, out = [], {}
    for mname, mod in model.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(mod, (nn.Conv3d, nn.Conv2d, nn.Linear)):
            kernels.append((prefix + "weight", tuple(mod.weight.shape)))
            if mod.bias is not None:
                out[prefix + "bias"] = torch.zeros(mod.bias.shape, device=device)
        elif isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
            out[prefix + "weight"] = torch.ones(mod.weight.shape, device=device)
            out[prefix + "bias"] = torch.zeros(mod.bias.shape, device=device)
        elif isinstance(mod, ref_lpips.LPIPS):
            for i, c in enumerate(ref_lpips.TAP_CHANNELS):
                out[f"{prefix}lin{i}"] = torch.full((c, 1), 1.0 / c, device=device)
    g = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for _, s in kernels), generator=g, device=device)
    at = 0
    for name, shape in kernels:
        size = math.prod(shape)
        out[name] = flat[at:at + size].view(shape).mul_(math.prod(shape[1:]) ** -0.5)
        at += size
    missing = {n for n, _ in model.named_parameters()} ^ set(out)
    if missing:
        raise ValueError(f"weights made and parameters differ: {sorted(missing)[:5]}")
    return out


def prefixed(weights: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The weights under ``prefix.``, the prefix removed."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in weights.items() if k.startswith(prefix + ".")}

