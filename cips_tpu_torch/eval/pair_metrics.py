"""Folder-pair metric tool: synthesized against real volume trees (port of
cips_tpu/eval/pair_metrics.py, the reference's unet/scripts/metrics.py):

  * two-tree mode walks the SYNTHESIZED tree {sys_root}/{subject}/{date}/ and
    pairs the first file of each session with the first file of the same
    session in the real tree, skipping sessions with no real counterpart
    (:24-46); one-tree mode pairs (real_name, rec_name) inside each session of
    one tree (what `cli.output_predict` writes);
  * the real volume is max-normalised (:48); the synthesized one is scaled to
    the real mean, ``sys / mean(sys) * mean(real)`` (:51-52, on by default);
  * both padded/cropped to the metric shape (192, 224, 192) (:55-60);
  * MAE, MS-SSIM as torchmetrics computes it on the reference's 4-D input
    (`ms_ssim_2d_slicewise`, kernel 11, sigma 1.5; NaN values skipped,
    :64-66) and PSNR = 10 log10(1 / MSE), each as mean and std over the cohort.

Decoding and padding run on the host; the metrics on ``device`` (the card
unless "cpu" is asked for), in fp32.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from cips_tpu_torch import default_device
from cips_tpu_torch.data import nifti
from cips_tpu_torch.data.dataset import pad_crop_np
from cips_tpu_torch.ops.metrics import mae, ms_ssim_2d_slicewise, psnr

METRIC_SHAPE = (192, 224, 192)


def iter_volume_pairs(
    root: str, real_name: str = "ori.nii.gz", rec_name: str = "rec.nii.gz"
) -> Iterable[Tuple[str, str, str, str]]:
    """One-tree mode: (subject, date, real_path, rec_path) for each session dir holding both files."""
    for subject in sorted(os.listdir(root)):
        subj_dir = os.path.join(root, subject)
        if not os.path.isdir(subj_dir):
            continue
        for date in sorted(os.listdir(subj_dir)):
            real_p = os.path.join(subj_dir, date, real_name)
            rec_p = os.path.join(subj_dir, date, rec_name)
            if os.path.isfile(real_p) and os.path.isfile(rec_p):
                yield subject, date, real_p, rec_p


def iter_two_root_pairs(sys_root: str, real_root: str) -> Iterable[Tuple[str, str, str, str]]:
    """Two-tree mode (metrics.py:24-46): the FIRST file of each synthesized
    session with the first file of the same {subject}/{date} in the real tree."""
    for subject in sorted(os.listdir(sys_root)):
        subj_dir = os.path.join(sys_root, subject)
        if not os.path.isdir(subj_dir):
            continue
        for date in sorted(os.listdir(subj_dir)):
            d = os.path.join(subj_dir, date)
            sys_files = sorted(os.listdir(d)) if os.path.isdir(d) else []
            real_d = os.path.join(real_root, subject, date)
            if not sys_files or not os.path.isdir(real_d):
                continue
            real_files = sorted(os.listdir(real_d))
            if real_files:
                yield subject, date, os.path.join(real_d, real_files[0]), os.path.join(d, sys_files[0])


def folder_pair_metrics(
    root: str,
    real_name: str = "ori.nii.gz",
    rec_name: str = "rec.nii.gz",
    real_root: Optional[str] = None,
    metric_shape: Tuple[int, int, int] = METRIC_SHAPE,
    intensity_match: bool = True,
    device=None,
) -> Dict[str, float]:
    device = default_device(device)
    pairs = iter_two_root_pairs(root, real_root) if real_root is not None else iter_volume_pairs(root, real_name, rec_name)
    maes: List[float] = []
    ssims: List[float] = []
    psnrs: List[float] = []
    for _subject, _date, real_p, rec_p in pairs:
        real = nifti.read_array(real_p).astype(np.float32)
        rec = nifti.read_array(rec_p).astype(np.float32)
        real = real / max(real.max(), 1e-12)  # metrics.py:48
        if intensity_match:
            rec = rec / max(rec.mean(), 1e-12) * real.mean()
        real_t = torch.from_numpy(pad_crop_np(real, metric_shape)).to(device)
        rec_t = torch.from_numpy(pad_crop_np(rec, metric_shape)).to(device)
        maes.append(float(mae(rec_t, real_t)))
        s = float(ms_ssim_2d_slicewise(rec_t, real_t))
        if not np.isnan(s):  # metrics.py:64-66 skips a NaN MS-SSIM
            ssims.append(s)
        psnrs.append(float(psnr(rec_t, real_t)))

    def stats(v):
        a = np.asarray(v, np.float64)
        return (float(a.mean()), float(a.std())) if a.size else (float("nan"), float("nan"))

    (mm, ms_), (sm, ss_), (pm, ps_) = stats(maes), stats(ssims), stats(psnrs)
    return {"count": len(maes), "mae_mean": mm, "mae_std": ms_, "ms_ssim_mean": sm, "ms_ssim_std": ss_,
            "psnr_mean": pm, "psnr_std": ps_}
