"""SUVR, the standardised uptake value ratio on segmentation label maps (port
of cips_tpu/ops/suvr.py), the reference's clinical-validation math
(proprocess/apply_surfurseg_to_PET.py, proprocess/appy_iBEAT.py):

  * `resize_and_pad_pet_to_seg`: 1.5x linear upsample, pad to the
    segmentation's cube, then the axis swap and flips into its orientation
    (apply_surfurseg_to_PET.py:10-26);
  * `compute_suvr` = mean(PET over ROI voxels) / mean(PET over REF voxels);
  * label sets: FastSurfer aseg ROI [3, 42] (cerebral cortex), REF
    [7, 8, 46, 47] (cerebellum); iBEAT ROI 36-45, 48-113, 116-131, REF [10, 11].
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from cips_tpu_torch.ops.resample import resize_trilinear
from cips_tpu_torch.ops.volume import pad_crop_to

FASTSURFER_ROI = (3, 42)
FASTSURFER_REF = (7, 8, 46, 47)
IBEAT_ROI = tuple(range(36, 46)) + tuple(range(48, 114)) + tuple(range(116, 132))
IBEAT_REF = (10, 11)


def label_mask(seg: torch.Tensor, labels: Sequence[int]) -> torch.Tensor:
    """Boolean mask of voxels whose label is in ``labels``."""
    return torch.isin(seg, torch.tensor(labels, dtype=seg.dtype, device=seg.device))


def compute_suvr(
    pet: torch.Tensor, seg: torch.Tensor, roi_labels: Sequence[int], ref_labels: Sequence[int]
) -> torch.Tensor:
    """mean(PET over ROI voxels) / mean(PET over REF voxels), in fp32."""
    pet = pet.float()
    roi = label_mask(seg, roi_labels).float()
    ref = label_mask(seg, ref_labels).float()
    roi_mean = (pet * roi).sum() / torch.clamp_min(roi.sum(), 1.0)
    ref_mean = (pet * ref).sum() / torch.clamp_min(ref.sum(), 1.0)
    return roi_mean / torch.clamp_min(ref_mean, 1e-12)


def resize_and_pad_pet_to_seg(
    pet: torch.Tensor,
    seg_shape: Tuple[int, int, int] = (256, 256, 256),
    scale: float = 1.5,
    reorient: bool = True,
) -> torch.Tensor:
    """Push a (z, y, x) PET into FastSurfer's conformed space: linear
    ``scale`` upsample, pad to ``seg_shape``, then into the segmentation's
    axis order. The reference pads its (x, y, z) ants array to the cube and
    then takes ``swapaxes(a, 1, 2)[:, ::-1, ::-1]``; in (z, y, x) order that is
    ``swapaxes(a, 0, 1)[::-1, ::-1, :]``, after the pad, so an odd pad's extra
    voxel lands on the reference's side."""
    pet = resize_trilinear(pet, tuple(int(s * scale) for s in pet.shape))
    pet = pad_crop_to(pet, seg_shape, spatial_axes=(0, 1, 2))
    if reorient:
        pet = torch.flip(pet.transpose(0, 1), dims=(0, 1))
    return pet


def suvr_abs_error(suvr_gt: torch.Tensor, suvr_synth: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """mean and (population) std of |SUVR_gt - SUVR_synth| over matched sessions
    (proprocess/compute_suvr_error.py:21-32)."""
    err = (torch.as_tensor(suvr_gt) - torch.as_tensor(suvr_synth)).abs()
    return err.mean(), err.std(correction=0)
