"""Tabular covariates: encoding and min-max normalisation (the port's copy of
the parts of cips_tpu/data/covariates.py that the port's datasets need).

Covariate sets per tracer (reference `unet/scripts/train_unet.py:64`):
  AV1451 -> TAU, PTAU, Age, Sex, APOE4, PTEDUCAT
  AV45   -> ABETA, Age, Sex, APOE4, PTEDUCAT
"""

from __future__ import annotations

import json
import pickle
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from cips_tpu_torch.data.manifest import PairRow

COVARIATES_BY_TRACER = {
    "AV1451": ["TAU", "PTAU", "Age", "Sex", "APOE4", "PTEDUCAT"],
    "AV45": ["ABETA", "Age", "Sex", "APOE4", "PTEDUCAT"],
}

CENSOR_LOW_VALUE = 0.0
CENSOR_HIGH_VALUE = 2000.0


def encode_value(key: str, raw: str) -> Optional[float]:
    """Encode one raw covariate cell: Female/Male -> 0/1, '<x' -> 0, '>x' -> 2000."""
    if raw is None:
        return None
    s = str(raw).strip()
    if not s or s.lower() in ("nan", "na"):
        return None
    if key == "Sex":
        if s in ("Female", "F"):
            return 0.0
        if s in ("Male", "M"):
            return 1.0
    if s.startswith("<"):
        return CENSOR_LOW_VALUE
    if s.startswith(">"):
        return CENSOR_HIGH_VALUE
    try:
        return float(s)
    except ValueError:
        return None


def load_min_and_max(path: str) -> Dict[str, Tuple[float, float]]:
    """Load stats from JSON or from a reference-format pickle (.pkl, written by this
    project's own tools: unpickling runs code, so load only trusted files)."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            raw = pickle.load(f)
    else:
        with open(path, "r", encoding="utf-8") as f:
            raw = json.load(f)
    return {k: (float(v[0]), float(v[1])) for k, v in raw.items()}


def covariate_vector(
    row: PairRow,
    keys: Sequence[str],
    min_and_max: Mapping[str, Tuple[float, float]],
    invert_abeta: bool = False,
) -> np.ndarray:
    """Encode + min-max normalise a row's covariates. ``invert_abeta``: the
    classifier's datasets flip ABETA after normalisation, ``v = 1 - v``."""
    vec = []
    for k in keys:
        v = encode_value(k, row.values.get(k, ""))
        if v is None:
            raise ValueError(f"{row.subject} {row.pet_date}: missing covariate {k}")
        if k in min_and_max:
            lo, hi = min_and_max[k]
            v = (v - lo) / (hi - lo)
        if invert_abeta and k == "ABETA":
            v = 1.0 - v
        vec.append(v)
    return np.asarray(vec, dtype=np.float32)
