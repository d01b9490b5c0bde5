"""Cohort demographics and longitudinal SUVR analysis (the port's copy of
cips_tpu/eval/cohort.py, pure numpy).

Re-implements the reference's cohort tooling:
  * `unet/scripts/summary.py` — nearest-exam-date diagnosis assignment
    (:23-52) and per-group (CN/MCI/AD) session/subject counts, sex ratio,
    age mean ± std (:78-84);
  * `proprocess/analyse_suvr.py` — subject grouping sCN/pCN/sMCI/pMCI/AD
    from longitudinal DX trajectories (:45-75), SUVR>2 outlier filtering
    (:111-114), per-group scatter (:129-143);
  * `proprocess/compute_suvr_error.py` — gt-vs-synth SUVR MAE over matched
    (subject, date) (:21-32).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from cips_tpu_torch.data.manifest import days_between

DX_CN = ("CN", "SMC")
DX_MCI = ("MCI", "EMCI", "LMCI")
DX_AD = ("AD", "Dementia")


def _norm_dx(dx: str) -> Optional[str]:
    dx = (dx or "").strip()
    if dx in DX_CN or dx.upper() == "CN":
        return "CN"
    if dx in DX_MCI or "MCI" in dx.upper():
        return "MCI"
    if dx in DX_AD or dx.upper() in ("AD", "DEMENTIA"):
        return "AD"
    return None


def nearest_diagnosis(
    exam_records: Sequence[Mapping[str, str]], scan_date: str, dx_key: str = "DX", date_key: str = "EXAMDATE"
) -> Optional[str]:
    """Diagnosis of the exam nearest to the scan (summary.py:23-52)."""
    dated = [r for r in exam_records if r.get(date_key) and _norm_dx(r.get(dx_key, ""))]
    if not dated:
        return None
    rec = min(dated, key=lambda r: days_between(r[date_key], scan_date))
    return _norm_dx(rec[dx_key])


def cohort_summary(
    sessions: Sequence[Tuple[str, str]],
    exam_records: Mapping[str, Sequence[Mapping[str, str]]],
    demographics: Mapping[str, Mapping[str, str]],
) -> Dict[str, Dict[str, float]]:
    """Per-diagnosis-group session/subject counts, sex ratio, age mean±std.

    ``sessions``: [(subject, scan_date)]; ``demographics``:
    {subject: {"Sex": ..., "Age": ...}}.
    """
    groups: Dict[str, Dict[str, list]] = defaultdict(lambda: {"sessions": [], "subjects": set(), "ages": [], "sexes": []})
    for subject, date in sessions:
        dx = nearest_diagnosis(exam_records.get(subject, []), date)
        if dx is None:
            continue
        g = groups[dx]
        g["sessions"].append((subject, date))
        g["subjects"].add(subject)
        demo = demographics.get(subject, {})
        try:
            g["ages"].append(float(demo.get("Age", "")))
        except ValueError:
            pass
        sex = demo.get("Sex", "")
        if sex:
            g["sexes"].append(sex)
    out = {}
    for dx, g in groups.items():
        ages = np.asarray(g["ages"], np.float64)
        n_female = sum(1 for s in g["sexes"] if s in ("Female", "F"))
        out[dx] = {
            "n_sessions": len(g["sessions"]),
            "n_subjects": len(g["subjects"]),
            "female_ratio": n_female / max(len(g["sexes"]), 1),
            "age_mean": float(ages.mean()) if ages.size else float("nan"),
            "age_std": float(ages.std()) if ages.size else float("nan"),
        }
    return out


def longitudinal_group(dx_trajectory: Sequence[str]) -> Optional[str]:
    """sCN/pCN/sMCI/pMCI/AD from a subject's time-ordered diagnoses
    (analyse_suvr.py:45-75): stable vs progressing baseline status."""
    dxs = [_norm_dx(d) for d in dx_trajectory if _norm_dx(d)]
    if not dxs:
        return None
    first = dxs[0]
    if first == "AD":
        return "AD"
    progressed = any(
        (first == "CN" and later in ("MCI", "AD")) or (first == "MCI" and later == "AD")
        for later in dxs[1:]
    )
    return ("p" if progressed else "s") + first


def filter_suvr_outliers(
    records: Sequence[Tuple[str, str, float]], max_suvr: float = 2.0
) -> List[Tuple[str, str, float]]:
    """Drop SUVR > 2 outliers (analyse_suvr.py:111-114)."""
    return [r for r in records if r[2] <= max_suvr]


def suvr_error_table(
    gt: Mapping[Tuple[str, str], float], synth: Mapping[Tuple[str, str], float]
) -> Dict[str, float]:
    """mean ± std |SUVR_gt - SUVR_synth| over matched sessions
    (compute_suvr_error.py:21-32)."""
    keys = sorted(set(gt) & set(synth))
    errs = np.asarray([abs(gt[k] - synth[k]) for k in keys], np.float64)
    return {
        "n_matched": len(keys),
        "abs_err_mean": float(errs.mean()) if errs.size else float("nan"),
        "abs_err_std": float(errs.std()) if errs.size else float("nan"),
    }


def group_scatter_figure(
    records: Sequence[Tuple[str, str, float]],
    groups: Mapping[str, str],
    path: str,
) -> Optional[str]:
    """Per-group SUVR scatter (analyse_suvr.py:129-143)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    by_group: Dict[str, List[float]] = defaultdict(list)
    for subject, _date, suvr in records:
        g = groups.get(subject)
        if g:
            by_group[g].append(suvr)
    fig, ax = plt.subplots(figsize=(6, 4))
    for i, (g, vals) in enumerate(sorted(by_group.items())):
        ax.scatter([i] * len(vals), vals, label=f"{g} (n={len(vals)})", s=12)
    ax.set_xticks(range(len(by_group)), sorted(by_group))
    ax.set_ylabel("SUVR")
    ax.legend(fontsize=7)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
