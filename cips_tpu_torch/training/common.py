"""Checkpoints (port of CheckpointManager in cips_tpu/training/common.py).

Same directory contract as the JAX package: ``{ckpt_dir}/epoch_{n}``,
``{ckpt_dir}/best`` and ``{ckpt_dir}/meta.json`` with ``last_epoch``,
``best_epoch`` and ``best_metric``. Each checkpoint is one ``torch.save``
file holding the reference's dict layout,
``{"unet": state_dict, "discriminator": state_dict, "epoch": n}``.
Orbax checkpoints of the JAX package are not read.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import torch


def strip_ddp_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop DistributedDataParallel's ``module.`` key prefix."""
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in state_dict.items()}


class CheckpointManager:
    """torch.save checkpoints with best-metric tracking."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._best_path = os.path.join(self.ckpt_dir, "best")
        self._meta_path = os.path.join(self.ckpt_dir, "meta.json")

    def _meta(self) -> Dict[str, Any]:
        if os.path.exists(self._meta_path):
            with open(self._meta_path, encoding="utf-8") as f:
                return json.load(f)
        return {}

    def _write_meta(self, meta: Dict[str, Any]) -> None:
        with open(self._meta_path, "w", encoding="utf-8") as f:
            json.dump(meta, f)

    def save(self, payload: Mapping[str, Any], epoch: int, eval_metric: Optional[float] = None) -> None:
        """Save ``payload`` (the reference dict layout) as epoch ``epoch``; it also
        becomes ``best`` when ``eval_metric`` is the lowest seen."""
        torch.save(dict(payload), os.path.join(self.ckpt_dir, f"epoch_{epoch}"))
        meta = self._meta()
        meta["last_epoch"] = epoch
        if eval_metric is not None and eval_metric < meta.get("best_metric", float("inf")):
            meta["best_metric"] = eval_metric
            meta["best_epoch"] = epoch
            torch.save(dict(payload), self._best_path)
        self._write_meta(meta)

    def latest_epoch(self) -> Optional[int]:
        return self._meta().get("last_epoch")

    def restore(self, epoch: Optional[int] = None, best: bool = False) -> Dict[str, Any]:
        """The saved payload (tensors on the CPU), with any ``module.`` prefix
        stripped from its state dicts."""
        if best:
            path = self._best_path
        else:
            if epoch is None:
                epoch = self.latest_epoch()
            if epoch is None:
                raise FileNotFoundError(f"no checkpoints in {self.ckpt_dir}")
            path = os.path.join(self.ckpt_dir, f"epoch_{epoch}")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        for key in ("unet", "discriminator"):
            if key in payload:
                payload[key] = strip_ddp_prefix(payload[key])
        return payload
