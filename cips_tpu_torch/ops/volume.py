"""Pad-and-crop on tensors (port of cips_tpu/ops/volume.py's `pad_crop_to`).

The reference's MONAI chain (`unet/utils/dataset.py:70-103`): SpatialPad then
CenterSpatialCrop to the working shape. Tensors run on the device they lie on;
batched inputs are handled natively. The loaders pad, crop and normalise on the
host (`data/dataset.py`'s numpy `pad_crop_np` and `max_normalize_np`), so only
the SUVR chain needs this tensor form.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def pad_crop_to(x: torch.Tensor, target: Sequence[int], spatial_axes: Sequence[int]) -> torch.Tensor:
    """Symmetrically pad, then center-crop ``spatial_axes`` of ``x`` to ``target``.

    MONAI's rule: the extra voxel of an odd pad goes at the end, and an odd
    crop drops it from the end.
    """
    assert len(target) == len(spatial_axes)
    axes = [a % x.ndim for a in spatial_axes]
    pads = [0] * (2 * x.ndim)  # F.pad's order: last axis first, (before, after) each
    for axis, tgt in zip(axes, target):
        total = max(tgt - x.shape[axis], 0)
        slot = 2 * (x.ndim - 1 - axis)
        pads[slot], pads[slot + 1] = total // 2, total - total // 2
    if any(pads):
        x = F.pad(x, pads)
    for axis, tgt in zip(axes, target):
        cur = x.shape[axis]
        if cur > tgt:
            x = x.narrow(axis, (cur - tgt) // 2, tgt)
    return x
