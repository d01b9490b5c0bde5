"""Shared CLI plumbing: configs, experiment dirs, covariate sets, device and dtype
flags (port of cips_tpu/cli/common.py).

The flags are the JAX package's, so a command line works against either
package, plus ``--device {cuda,cpu}`` (default cuda).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional

import torch

from cips_tpu_torch.data.covariates import COVARIATES_BY_TRACER, load_min_and_max

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def load_config(path: Optional[str], default_name: str) -> Dict[str, Any]:
    if path is None:
        path = os.path.join(CONFIG_DIR, default_name)
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def covariates_for(pet_kind: str, use_condition: bool) -> list:
    return list(COVARIATES_BY_TRACER.get(pet_kind, [])) if use_condition else []


def experiment_dirs(exp_dir: str, use_condition: bool, pet_kind: str) -> Dict[str, str]:
    base = os.path.join(exp_dir, "conditional" if use_condition else "unconditional", pet_kind)
    dirs = {
        "base": base,
        "log": os.path.join(base, "log"),
        "ckpt": os.path.join(base, "ckpt"),
        "visual": os.path.join(base, "visual"),
    }
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    return dirs


def add_common_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--training_info_csv", help="training pair manifest CSV")
    p.add_argument("--eval_info_csv", help="eval/test pair manifest CSV")
    p.add_argument("--PET_dir", help="PET volume tree {dir}/{Subject}/{date}/")
    p.add_argument("--T1_dir", help="T1 volume tree {dir}/{Subject}/{date}/")
    p.add_argument("--packed_dir", help="packed-array dataset dir (not read by the port yet)")
    p.add_argument("--eval_packed_dir", help="packed eval dataset dir (not read by the port yet)")
    p.add_argument("--min_and_max", help="covariate stats JSON/pkl")
    p.add_argument("--pet_kind", default="AV45", choices=["AV45", "AV1451"])
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--crop_size", type=int, nargs=3, default=[96, 128, 96],
                   help="working volume shape (train_unet.py:111)")
    p.add_argument("--random_crop_size", type=int, nargs=3, default=None,
                   help="training-time joint random crop; eval stays center-cropped")
    p.add_argument("--streaming", action="store_true",
                   help="decode NIfTIs on the fly (the port always does)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run; cuda is required unless cpu is asked for")


def load_stats(path: Optional[str]) -> Dict:
    return load_min_and_max(path) if path else {}


def dtype_arg(name: str) -> torch.dtype:
    return {"bf16": torch.bfloat16, "f32": torch.float32}[name]
