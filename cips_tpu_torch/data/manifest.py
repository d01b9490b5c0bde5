"""CSV pair manifests (the port's copy of the reader in cips_tpu/data/manifest.py).

Schema, as in the reference CSVs: ``Subject,T1_date,PET_date[,<covariate columns>]``.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class PairRow:
    subject: str
    t1_date: str
    pet_date: str
    values: Dict[str, str] = field(default_factory=dict)


def read_manifest(path: str) -> List[PairRow]:
    rows = []
    with open(path, newline="", encoding="utf-8") as f:
        for rec in csv.DictReader(f):
            values = {k: v for k, v in rec.items() if k not in ("Subject", "T1_date", "PET_date")}
            rows.append(
                PairRow(subject=rec["Subject"], t1_date=rec["T1_date"], pet_date=rec["PET_date"], values=values)
            )
    return rows
