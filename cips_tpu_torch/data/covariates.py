"""Tabular covariates: merge, encoding, normalisation stats (the port's copy of
cips_tpu/data/covariates.py).

  * `merge_covariates` (reference `preprocess/merge_csf.py`): covariates joined
    onto pair manifests from the nearest exam date (:60-84), Female/Male ->
    0/1, censored '<x' -> 0 and '>x' -> 2000 (:34-50), Age += the exam-to-scan
    gap in years (:84). The reference's scalar-argmin bug (:77-79) is fixed:
    the true nearest exam date is used.
  * `compute_min_and_max` (`preprocess/compute_max_and_min.py`): per-covariate
    (min, max) over the training manifest (:10-17), saved as JSON;
    `load_min_and_max` also reads the reference's pickles.

Covariate sets per tracer (reference `unet/scripts/train_unet.py:64`):
  AV1451 -> TAU, PTAU, Age, Sex, APOE4, PTEDUCAT
  AV45   -> ABETA, Age, Sex, APOE4, PTEDUCAT
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from cips_tpu_torch.data.manifest import PairRow, days_between

COVARIATES_BY_TRACER = {
    "AV1451": ["TAU", "PTAU", "Age", "Sex", "APOE4", "PTEDUCAT"],
    "AV45": ["ABETA", "Age", "Sex", "APOE4", "PTEDUCAT"],
}

# continuous covariates get min-max stats; Sex and APOE4 are already small codes
# (compute_max_and_min.py:8)
CONTINUOUS_COVARIATES = ("ABETA", "TAU", "PTAU", "Age", "PTEDUCAT")

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


def merge_covariates(
    rows: Sequence[PairRow],
    exam_records: Mapping[str, List[Dict[str, str]]],
    keys: Sequence[str],
    exam_date_key: str = "EXAMDATE",
    max_days: Optional[int] = None,
) -> List[PairRow]:
    """Attach covariates from each subject's exam records ({subject: [{EXAMDATE:
    ..., ABETA: ..., ...}, ...]}) by the exam nearest the PET date. Age is
    moved on by the exam-to-scan gap; rows with no usable exam or a missing
    value are dropped."""
    out: List[PairRow] = []
    for row in rows:
        dated = [r for r in exam_records.get(row.subject) or () if r.get(exam_date_key)]
        if not dated:
            continue
        nearest = min(dated, key=lambda r: days_between(r[exam_date_key], row.pet_date))
        gap_days = days_between(nearest[exam_date_key], row.pet_date)
        if max_days is not None and gap_days > max_days:
            continue
        values: Dict[str, str] = dict(row.values)
        for k in keys:
            v = encode_value(k, nearest.get(k, ""))
            if v is None:
                break
            if k == "Age":
                v = v + gap_days / 365.0
            values[k] = repr(v)
        else:
            out.append(PairRow(row.subject, row.t1_date, row.pet_date, values))
    return out


def compute_min_and_max(
    rows: Sequence[PairRow], keys: Iterable[str] = CONTINUOUS_COVARIATES
) -> Dict[str, Tuple[float, float]]:
    """(min, max) of each covariate over the rows that hold a value for it."""
    stats: Dict[str, Tuple[float, float]] = {}
    for k in keys:
        vals = [v for v in (encode_value(k, r.values[k]) for r in rows if k in r.values) if v is not None]
        if vals:
            stats[k] = (float(min(vals)), float(max(vals)))
    return stats


def save_min_and_max(path: str, stats: Mapping[str, Tuple[float, float]]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({k: list(v) for k, v in stats.items()}, f, indent=2)


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
