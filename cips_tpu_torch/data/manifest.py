"""CSV manifests: T1/PET pairing and subject-level splits (the port's copy of
cips_tpu/data/manifest.py).

The reference's manifest tools:
  * `preprocess/create_pair_csv.py`: each PET session paired with the nearest
    T1 within 180 days (:44-63); a subject-level 80/20 split, seed 100 (:18-21);
  * `preprocess/create_csv.py`: Subject/AcqDate manifests (its bug of test rows
    that hold training rows, :35-48, is not copied);
  * `preprocess/pair_PET_and_T1.py`: the PET sessions with no T1 within 180 days.

Schema, as in the reference CSVs: ``Subject,T1_date,PET_date[,<covariate columns>]``;
dates are YYYY-MM-DD strings.
"""

from __future__ import annotations

import csv
import os
import random
from dataclasses import dataclass, field
from datetime import datetime
from typing import Dict, List, Optional, Sequence, Tuple

DATE_FMT = "%Y-%m-%d"
MAX_PAIR_DAYS = 180


def parse_date(s: str) -> datetime:
    s = s.strip()
    for fmt in (DATE_FMT, "%Y/%m/%d", "%m/%d/%Y"):
        try:
            return datetime.strptime(s, fmt)
        except ValueError:
            continue
    raise ValueError(f"unparseable date: {s!r}")


def days_between(a: str, b: str) -> int:
    return abs((parse_date(a) - parse_date(b)).days)


@dataclass
class PairRow:
    subject: str
    t1_date: str
    pet_date: str
    values: Dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, str]:
        return {"Subject": self.subject, "T1_date": self.t1_date, "PET_date": self.pet_date, **self.values}


def scan_session_dirs(root: str) -> Dict[str, List[str]]:
    """{subject: sorted [date, ...]} for a {root}/{Subject}/{date}/ tree."""
    out: Dict[str, List[str]] = {}
    if not os.path.isdir(root):
        return out
    for subject in sorted(os.listdir(root)):
        subj_dir = os.path.join(root, subject)
        if not os.path.isdir(subj_dir):
            continue
        dates = sorted(d for d in os.listdir(subj_dir) if os.path.isdir(os.path.join(subj_dir, d)))
        if dates:
            out[subject] = dates
    return out


def pair_sessions(
    pet_sessions: Dict[str, List[str]], t1_sessions: Dict[str, List[str]], max_days: int = MAX_PAIR_DAYS
) -> List[PairRow]:
    """Each PET session with its nearest T1 within ``max_days`` (create_pair_csv.py:44-63)."""
    rows: List[PairRow] = []
    for subject, pet_dates in pet_sessions.items():
        t1_dates = t1_sessions.get(subject)
        if not t1_dates:
            continue
        for pet_date in pet_dates:
            best = min(t1_dates, key=lambda d: days_between(d, pet_date))
            if days_between(best, pet_date) <= max_days:
                rows.append(PairRow(subject=subject, t1_date=best, pet_date=pet_date))
    return rows


def unpaired_pet_sessions(
    pet_sessions: Dict[str, List[str]], t1_sessions: Dict[str, List[str]], max_days: int = MAX_PAIR_DAYS
) -> List[Tuple[str, str]]:
    """PET sessions with no T1 within the window (pair_PET_and_T1.py:43-89)."""
    missing = []
    for subject, pet_dates in pet_sessions.items():
        t1_dates = t1_sessions.get(subject, [])
        for pet_date in pet_dates:
            if not t1_dates or min(days_between(d, pet_date) for d in t1_dates) > max_days:
                missing.append((subject, pet_date))
    return missing


def subject_split(
    rows: Sequence[PairRow], train_frac: float = 0.8, seed: int = 100
) -> Tuple[List[PairRow], List[PairRow]]:
    """Subject-level split: all sessions of a subject land on one side
    (create_pair_csv.py:18-21); the sorted subjects shuffled by ``random.Random(seed)``."""
    subjects = sorted({r.subject for r in rows})
    random.Random(seed).shuffle(subjects)
    train_subjects = set(subjects[: int(len(subjects) * train_frac)])
    train = [r for r in rows if r.subject in train_subjects]
    test = [r for r in rows if r.subject not in train_subjects]
    return train, test


def read_manifest(path: str) -> List[PairRow]:
    rows = []
    with open(path, newline="", encoding="utf-8") as f:
        for rec in csv.DictReader(f):
            values = {k: v for k, v in rec.items() if k not in ("Subject", "T1_date", "PET_date")}
            rows.append(
                PairRow(subject=rec["Subject"], t1_date=rec["T1_date"], pet_date=rec["PET_date"], values=values)
            )
    return rows


def write_manifest(path: str, rows: Sequence[PairRow], columns: Optional[Sequence[str]] = None) -> None:
    """Write ``rows``; the columns default to the schema's three, then every value key, sorted."""
    if columns is None:
        columns = ["Subject", "T1_date", "PET_date"] + sorted({k for r in rows for k in r.values})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=list(columns))
        w.writeheader()
        for r in rows:
            w.writerow({k: r.to_dict().get(k, "") for k in columns})
