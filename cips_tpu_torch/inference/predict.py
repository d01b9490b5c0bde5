"""Volume synthesis inference + per-volume metrics (port of cips_tpu/inference/predict.py).

Runs the generator over a test manifest, brain-masks each synthesized volume
with the mask of the REAL PET (reference output_predict.py:118-119), computes
MAE / MS-SSIM (kernel 5, sigma 0.5) / PSNR, writes ``rec.nii.gz`` and
(``write_ori``) ``ori.nii.gz`` per subject/date and reports mean ± std. ``mask_mode="self"``
is the causal path's post-processing: min-max renormalise, then mask with
the synthesized volume's own mask.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from cips_tpu_torch.data import nifti
from cips_tpu_torch.ops.masking import get_mask
from cips_tpu_torch.ops.metrics import mae, ms_ssim, psnr

MASK_MODES = ("real", "self", "none")


@dataclass
class VolumeMetrics:
    mae: List[float] = field(default_factory=list)
    ms_ssim: List[float] = field(default_factory=list)
    psnr: List[float] = field(default_factory=list)

    def add(self, m: Mapping[str, float]) -> None:
        self.mae.append(m["mae"])
        self.ms_ssim.append(m["ms_ssim"])
        self.psnr.append(m["psnr"])

    def summary(self) -> Dict[str, float]:
        out = {}
        for name, vals in (("mae", self.mae), ("ms_ssim", self.ms_ssim), ("psnr", self.psnr)):
            arr = np.asarray(vals, np.float64)
            out[f"{name}_mean"] = float(arr.mean()) if arr.size else float("nan")
            out[f"{name}_std"] = float(arr.std()) if arr.size else float("nan")
        return out

    def __str__(self) -> str:
        s = self.summary()
        return (
            f"MAE {s['mae_mean']:.5f}±{s['mae_std']:.5f}  "
            f"MS-SSIM {s['ms_ssim_mean']:.5f}±{s['ms_ssim_std']:.5f}  "
            f"PSNR {s['psnr_mean']:.3f}±{s['psnr_std']:.3f}"
        )


def _renorm_and_self_mask(rec: torch.Tensor) -> torch.Tensor:
    lo, hi = rec.min(), rec.max()
    rec = (rec - lo) / (hi - lo).clamp_min(1e-12)
    return rec * get_mask(rec).to(rec.dtype)


def predict_dataset(
    predict_fn: Callable[[Mapping[str, torch.Tensor]], torch.Tensor],
    dataset,
    device: Union[str, torch.device],
    output_dir: Optional[str] = None,
    mask_mode: str = "real",
    batch_size: int = 1,
    write_ori: bool = True,
) -> VolumeMetrics:
    """Run inference over a PairedVolumeDataset on ``device``; returns the metrics.

    ``predict_fn`` maps a {"t1", "pet", "info"} batch (channels-last tensors
    on ``device``) to the synthesized volume batch. With ``output_dir``, each
    subject's ``rec.nii.gz`` is written, and its real PET as ``ori.nii.gz``
    unless ``write_ori`` is False (the causal generation CLI's choice).
    """
    if mask_mode not in MASK_MODES:
        raise ValueError(f"mask_mode must be one of {MASK_MODES}, got {mask_mode!r}")
    results = VolumeMetrics()
    n = len(dataset)
    for start in range(0, n, batch_size):
        samples = [dataset[i] for i in range(start, min(start + batch_size, n))]
        batch = {
            "t1": torch.from_numpy(np.stack([s.t1 for s in samples])[..., None]).to(device),
            "pet": torch.from_numpy(np.stack([s.pet for s in samples])[..., None]).to(device),
            "info": torch.from_numpy(np.stack([s.info for s in samples])[:, None, :]).to(device),
        }
        recs = predict_fn(batch)
        for j, s in enumerate(samples):
            rec = recs[j, ..., 0].float()
            real = batch["pet"][j, ..., 0].float()
            if mask_mode == "self":
                rec = _renorm_and_self_mask(rec)
            masked = rec * get_mask(real).to(real.dtype) if mask_mode == "real" else rec
            results.add({
                "mae": mae(masked, real).item(),
                "ms_ssim": ms_ssim(masked, real, kernel_size=5, sigma=0.5).item(),
                "psnr": psnr(masked, real).item(),
            })
            if output_dir is not None:
                out_dir = os.path.join(output_dir, s.subject, s.pet_date)
                nifti.write(os.path.join(out_dir, "rec.nii.gz"), masked.cpu().numpy())
                if write_ori:
                    nifti.write(os.path.join(out_dir, "ori.nii.gz"), real.cpu().numpy())
    return results
