"""Offline preprocessing: registration chain, masking, downsampling (port of
cips_tpu/data/preprocess.py), over {root}/{Subject}/{date}/ NIfTI trees:

  * `register_pet_to_t1` (reference preprocess/reg_to_T1.py `reg_to_t1`,
    :62-99): rigid PET->subject-T1, the resampled PET written; sessions whose
    output exists are skipped (:84-86);
  * `create_t1_downsample` (reg_to_T1.py:25-60, pair_reg.py:48): N4 bias
    correction, resample to a mm spacing, center pad/crop to the working shape;
  * `mask_pet_by_t1` (preprocess/masked_PET_by_T1.py:26-43): PET zeroed outside
    the subject's baseline skull-stripped T1;
  * `joint_register` (proprocess/reg_processed_mask_and_brain.py:8-35): one
    rigid transform applied to a brain (trilinear) and its label mask (nearest).

Registration, bias correction and resampling run on ``device`` (the card
unless "cpu" is asked for); decoding, masking and writing stay on the host.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from cips_tpu_torch import default_device
from cips_tpu_torch.data import nifti
from cips_tpu_torch.data.dataset import _first_file, pad_crop_np
from cips_tpu_torch.data.manifest import days_between, scan_session_dirs
from cips_tpu_torch.ops.registration import (
    apply_transform,
    n4_bias_correct,
    register_rigid,
    register_rigid_physical,
)
from cips_tpu_torch.ops.resample import resample_spacing


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, np.float32)).to(device)


def register_pet_to_t1(
    pet_root: str,
    t1_root: str,
    out_root: str,
    metric: str = "ncc",
    overwrite: bool = False,
    verbose: bool = True,
    device=None,
) -> int:
    """Rigid-register every PET session onto its subject's nearest T1; returns
    the number of sessions written to {out_root}/{Subject}/{pet_date}/pet_reg.nii.gz.

    Scanner geometry (anisotropic, oblique, shifted FOV) needs the physical-space
    rigid stage initialised from the headers, as ANTs does; when both affines
    are the identity, plain voxel-space registration is used.
    """
    device = default_device(device)
    n_done = 0
    t1_sessions = scan_session_dirs(t1_root)
    for subject, pet_dates in scan_session_dirs(pet_root).items():
        t1_dates = t1_sessions.get(subject)
        if not t1_dates:
            continue
        for pet_date in pet_dates:
            out_path = os.path.join(out_root, subject, pet_date, "pet_reg.nii.gz")
            if os.path.exists(out_path) and not overwrite:
                continue
            t1_date = min(t1_dates, key=lambda d: days_between(d, pet_date))
            pet_path = _first_file(os.path.join(pet_root, subject, pet_date))
            t1_path = _first_file(os.path.join(t1_root, subject, t1_date))
            if pet_path is None or t1_path is None:
                continue
            pet_img, t1_img = nifti.read(pet_path), nifti.read(t1_path)
            pet, t1 = _tensor(pet_img.data, device), _tensor(t1_img.data, device)
            if np.allclose(pet_img.affine, np.eye(4)) and np.allclose(t1_img.affine, np.eye(4)):
                result = register_rigid(pet, t1, metric=metric)
            else:
                result = register_rigid_physical(pet, t1, pet_img.affine, t1_img.affine, metric=metric)
            warped = apply_transform(pet, result.matrix, out_shape=t1_img.data.shape)
            nifti.write(out_path, nifti.NiftiImage(data=warped.cpu().numpy().astype(np.float32),
                                                   affine=t1_img.affine, spacing=t1_img.spacing))
            n_done += 1
            if verbose:
                print(f"[reg] {subject}/{pet_date} -> T1 {t1_date} loss={result.loss:.4f}")
    return n_done


def create_t1_downsample(
    t1_root: str,
    out_root: str,
    new_spacing: Tuple[float, float, float] = (1.5, 1.5, 1.5),
    crop_size: Tuple[int, int, int] = (96, 128, 96),
    bias_correct: bool = True,
    overwrite: bool = False,
    template_path: Optional[str] = None,
    metric: str = "ncc",
    device=None,
) -> int:
    """N4, resample to ``new_spacing`` mm and center pad/crop to ``crop_size`` for
    every T1 session; writes {out_root}/{Subject}/{date}/t1_ds.nii.gz.

    ``template_path`` takes the reference's ``reg_to_mni_first`` branch
    (reg_to_T1.py:27,51-52): each T1 is first rigid-registered onto the
    template and goes on from the template's grid and spacing. (The reference
    computes a template mask there but never applies it; none is applied here.)
    """
    device = default_device(device)
    template = nifti.read(template_path) if template_path else None
    n_done = 0
    for subject, dates in scan_session_dirs(t1_root).items():
        for date in dates:
            out_path = os.path.join(out_root, subject, date, "t1_ds.nii.gz")
            if os.path.exists(out_path) and not overwrite:
                continue
            t1_path = _first_file(os.path.join(t1_root, subject, date))
            if t1_path is None:
                continue
            img = nifti.read(t1_path)
            vol = _tensor(img.data, device)
            spacing = img.spacing
            if template is not None:
                result = register_rigid(vol, _tensor(template.data, device), metric=metric)
                vol = apply_transform(vol, result.matrix, out_shape=template.data.shape)
                spacing = template.spacing
            if bias_correct:
                vol = n4_bias_correct(vol)
            vol = resample_spacing(vol, spacing[::-1], new_spacing[::-1])
            arr = pad_crop_np(vol.cpu().numpy().astype(np.float32), crop_size)
            nifti.write(out_path, nifti.NiftiImage(data=arr, spacing=new_spacing))
            n_done += 1
    return n_done


def mask_pet_by_t1(pet_root: str, t1_root: str, out_root: str, overwrite: bool = False) -> int:
    """PET := PET * (baseline skull-stripped T1 > 0), on the host
    (masked_PET_by_T1.py:26-43: the subject's FIRST T1 date is the mask)."""
    n_done = 0
    t1_sessions = scan_session_dirs(t1_root)
    for subject, pet_dates in scan_session_dirs(pet_root).items():
        t1_dates = t1_sessions.get(subject)
        if not t1_dates:
            continue
        t1_path = _first_file(os.path.join(t1_root, subject, t1_dates[0]))
        if t1_path is None:
            continue
        t1 = nifti.read_array(t1_path).astype(np.float32)
        for pet_date in pet_dates:
            out_path = os.path.join(out_root, subject, pet_date, "pet_masked.nii.gz")
            if os.path.exists(out_path) and not overwrite:
                continue
            pet_path = _first_file(os.path.join(pet_root, subject, pet_date))
            if pet_path is None:
                continue
            pet_img = nifti.read(pet_path)
            pet = pet_img.data.astype(np.float32)
            if pet.shape != t1.shape:
                continue
            nifti.write(out_path, nifti.NiftiImage(data=pet * (t1 > 0), affine=pet_img.affine,
                                                   spacing=pet_img.spacing))
            n_done += 1
    return n_done


def joint_register(
    brain: np.ndarray, mask: np.ndarray, target_t1: np.ndarray, metric: str = "ncc", device=None
) -> Tuple[np.ndarray, np.ndarray]:
    """Register a processed brain onto a target T1 and carry its segmentation
    mask along by nearest neighbour (reg_processed_mask_and_brain.py:8-35)."""
    device = default_device(device)
    moving = _tensor(brain, device)
    res = register_rigid(moving, _tensor(target_t1, device), metric=metric)
    warped_brain = apply_transform(moving, res.matrix, out_shape=target_t1.shape)
    warped_mask = apply_transform(_tensor(mask, device), res.matrix, out_shape=target_t1.shape, nearest=True)
    return warped_brain.cpu().numpy().astype(np.float32), warped_mask.cpu().numpy().astype(mask.dtype)
