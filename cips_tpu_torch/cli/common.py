"""Shared CLI plumbing: configs, experiment dirs, covariate sets, loaders, device
and dtype flags (port of cips_tpu/cli/common.py).

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
from cips_tpu_torch.data.dataset import BatchLoader, PackedDataset, PairedVolumeDataset, StreamingLoader, pack_pairs
from cips_tpu_torch.parallel.mesh import Mesh, barrier

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
    p.add_argument("--packed_dir", help="packed-array dataset dir: reused when it holds volumes.npy, "
                                        "else the training pairs are packed there (trainers only)")
    p.add_argument("--eval_packed_dir", help="packed eval dataset dir, as --packed_dir (trainers only)")
    p.add_argument("--min_and_max", help="covariate stats JSON/pkl")
    p.add_argument("--pet_kind", default="AV45", choices=["AV45", "AV1451"])
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--crop_size", type=int, nargs=3, default=[96, 128, 96],
                   help="working volume shape (train_unet.py:111)")
    p.add_argument("--random_crop_size", type=int, nargs=3, default=None,
                   help="training-time joint random crop, re-max-normalised; eval stays center-cropped")
    p.add_argument("--streaming", action="store_true",
                   help="decode NIfTIs on the fly in fp32 instead of packing them to a float16 store")
    add_device_arg(p)


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run; cuda is required unless cpu is asked for")


def load_stats(path: Optional[str]) -> Dict:
    return load_min_and_max(path) if path else {}


def dtype_arg(name: str) -> torch.dtype:
    return {"bf16": torch.bfloat16, "f32": torch.float32}[name]


def make_loaders(args, need_values, mesh: Optional[Mesh] = None, split_eval: bool = True) -> tuple:
    """(train, eval) loaders: the training manifest shuffled at ``--batch_size``,
    dropping a short last batch; the eval manifest at batch 1, in order, keeping
    every subject.

    By default both manifests are packed once to float16 stores and served by
    `BatchLoader` (the JAX package's default): ``--packed_dir`` and
    ``--eval_packed_dir`` are reused when they hold a store, else the pairs are
    packed there, or into ``{exp_dir}/packed_{train,eval}`` when not given.
    ``--random_crop_size`` crops the training batches. ``--streaming`` decodes
    the NIfTIs in fp32 as it goes, through the native prefetch pool
    (`StreamingLoader`), instead; its training
    dataset crops each sample, corners drawn from a generator seeded with
    ``--seed``.

    Across ranks (``mesh``) the training loader yields node ``mesh.node_index``'s
    batches, as JAX's loader of that process index and count, and this rank's
    data group's rows of them (the ranks of a space group take the same rows,
    and cut their depth slabs later: `parallel.mesh.device_prefetch`); the eval subjects are dealt out over all ranks
    (``split_eval``: each rank's mean is then summed with the others') or all
    go to every rank. Rank 0 packs while the others wait, so across nodes the
    stores' directory must be shared (or packed beforehand: ``--packed_dir``)."""
    mesh = mesh or Mesh()
    shard = dict(shard_index=mesh.local_data_index, shard_count=mesh.local_data_count)
    train_place = dict(process_index=mesh.node_index, process_count=mesh.node_count, **shard)
    eval_place = dict(process_index=mesh.rank, process_count=mesh.world_size) if split_eval else {}

    def dataset(info_csv: str, **crop) -> PairedVolumeDataset:
        return PairedVolumeDataset(
            info_csv, pet_dir=args.PET_dir, t1_dir=args.T1_dir, crop_size=tuple(args.crop_size),
            need_values=need_values, min_and_max=load_stats(args.min_and_max), **crop,
        )

    if args.streaming:
        train = StreamingLoader(dataset(args.training_info_csv, random_crop_size=args.random_crop_size, seed=args.seed),
                                args.batch_size, seed=args.seed, **train_place)
        evaluate = StreamingLoader(dataset(args.eval_info_csv), 1, shuffle=False, drop_last=False, **eval_place)
        return train, evaluate

    def ensure_packed(info_csv: str, packed_dir: Optional[str], tag: str) -> PackedDataset:
        reuse = bool(packed_dir) and os.path.exists(os.path.join(packed_dir, "volumes.npy"))
        out = packed_dir or os.path.join(args.exp_dir, f"packed_{tag}")
        barrier(mesh)  # every rank has looked before rank 0 writes
        if not reuse and mesh.is_lead:
            pack_pairs(dataset(info_csv), out)
        barrier(mesh)
        return PackedDataset(out)

    train = BatchLoader(ensure_packed(args.training_info_csv, args.packed_dir, "train"), args.batch_size,
                        seed=args.seed, random_crop_size=args.random_crop_size, **train_place)
    evaluate = BatchLoader(ensure_packed(args.eval_info_csv, args.eval_packed_dir, "eval"), 1, shuffle=False,
                           drop_last=False, **eval_place)
    return train, evaluate
