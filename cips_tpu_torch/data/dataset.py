"""Paired T1/PET volume dataset (port of the NIfTI-backed dataset in
cips_tpu/data/dataset.py).

Decoding is the pure-numpy NIfTI reader; the JAX package's C++ decode
runtime is not ported yet, and there is no fallback between the two.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np

from cips_tpu_torch.data import nifti
from cips_tpu_torch.data.covariates import covariate_vector
from cips_tpu_torch.data.manifest import PairRow, read_manifest

CROP_SIZE = (96, 128, 96)  # the working volume (reference train_unet.py:111)


def pad_crop_np(img: np.ndarray, target: Sequence[int]) -> np.ndarray:
    """Symmetric pad then center crop (MONAI SpatialPad + CenterSpatialCrop)."""
    pads = []
    for cur, tgt in zip(img.shape, target):
        total = max(tgt - cur, 0)
        pads.append((total // 2, total - total // 2))
    img = np.pad(img, pads)
    slices = []
    for cur, tgt in zip(img.shape, target):
        start = (cur - tgt) // 2
        slices.append(slice(start, start + tgt))
    return img[tuple(slices)]


def max_normalize_np(img: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    return img / max(float(img.max()), eps)


def _first_file(folder: str) -> Optional[str]:
    if not os.path.isdir(folder):
        return None
    for e in sorted(os.listdir(folder)):
        p = os.path.join(folder, e)
        if os.path.isfile(p):
            return p
    return None


@dataclass
class Sample:
    t1: np.ndarray  # (D, H, W) float32, max-normalised
    pet: np.ndarray  # (D, H, W) float32, max-normalised
    info: np.ndarray  # (K,) float32 covariates (possibly empty)
    subject: str
    t1_date: str
    pet_date: str


class PairedVolumeDataset:
    """CSV-driven paired T1/PET dataset (the reference's pair_PET_T1dataset contract).

    Scans {dir}/{Subject}/{date}/ and takes the first file of each; skips
    rows whose directories are missing. Volumes are padded/center-cropped to
    ``crop_size`` and max-normalised.
    """

    def __init__(
        self,
        info_csv: str,
        pet_dir: str,
        t1_dir: str,
        crop_size: Sequence[int] = CROP_SIZE,
        need_values: Sequence[str] = (),
        min_and_max: Optional[Mapping[str, Tuple[float, float]]] = None,
        resize_size: Optional[Sequence[int]] = None,
    ):
        if resize_size:
            raise NotImplementedError("resize_size needs ops/resample.py, which is not ported yet")
        self.crop_size = tuple(crop_size)
        self.need_values = list(need_values)
        self.min_and_max = dict(min_and_max or {})
        self.rows: List[PairRow] = []
        self.paths: List[Tuple[str, str]] = []
        for row in read_manifest(info_csv):
            t1_path = _first_file(os.path.join(t1_dir, row.subject, row.t1_date))
            pet_path = _first_file(os.path.join(pet_dir, row.subject, row.pet_date))
            if t1_path is None or pet_path is None:
                continue
            self.rows.append(row)
            self.paths.append((t1_path, pet_path))

    def __len__(self) -> int:
        return len(self.rows)

    def _load(self, path: str) -> np.ndarray:
        return max_normalize_np(pad_crop_np(nifti.read_array(path).astype(np.float32), self.crop_size))

    def __getitem__(self, index: int) -> Sample:
        row = self.rows[index]
        t1_path, pet_path = self.paths[index]
        if self.need_values:
            info = covariate_vector(row, self.need_values, self.min_and_max)
        else:
            info = np.zeros((0,), np.float32)
        return Sample(self._load(t1_path), self._load(pet_path), info, row.subject, row.t1_date, row.pet_date)
