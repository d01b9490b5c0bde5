"""Shared trainer machinery: optimisers, checkpoints, metric logs, step timing
(port of cips_tpu/training/common.py).

Checkpoints keep the JAX package's directory contract: ``{ckpt_dir}/epoch_{n}``,
``{ckpt_dir}/best`` and ``{ckpt_dir}/meta.json`` with ``last_epoch``,
``best_epoch`` and ``best_metric``. Each checkpoint is one ``torch.save``
file of a dict in the reference's layout, extended for resuming:
``{"unet", "discriminator", "optimizer_g", "optimizer_d", "step", "epoch"}``
(state dicts; a serving checkpoint may hold ``unet`` alone; ``perceptual``
when the flagship trains with LPIPS); the causal generator's holds
``encoder``, ``t1_decoder``, ``pet_decoder`` and ``perceptual`` in place of
``unet``; the classifier's ``model`` and ``optimizer``; BMGAN's
``generator``, ``encoder``, ``discriminator``, ``perceptual`` and an
``optimizer_{g,e,d}`` each. Orbax
checkpoints of the JAX package are not read.

Metrics are written as ``metrics.jsonl`` records in the JAX package's format;
there is no TensorBoard writer. Across ranks only rank 0 writes, and the
metrics are means over the ranks (`mean_over_ranks`).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint
from torch import nn

from cips_tpu_torch import default_device
from cips_tpu_torch.models import perceptual as lpips
from cips_tpu_torch.parallel.mesh import Mesh
from cips_tpu_torch.profiling import span


def rematted(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, remat: bool) -> torch.Tensor:
    """``fn(x)``, with ``remat`` through ``torch.utils.checkpoint`` (recomputed in the backward)."""
    return torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False) if remat else fn(x)


def d_remat_from(train_cfg: Mapping[str, Any]) -> bool:
    """``d_remat`` from the training config, else ``CIPS_D_REMAT=1``, as JAX reads it."""
    return bool(train_cfg.get("d_remat", os.environ.get("CIPS_D_REMAT", "") == "1"))


def adam(params: Iterable[torch.nn.Parameter], lr: float) -> torch.optim.Adam:
    """Adam with betas (0.9, 0.999) and eps 1e-8, the reference's torch defaults.
    Its update m_hat / (sqrt(v_hat) + eps) is optax.adam's."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def init_models(
    models: Sequence[nn.Module],
    init_params: Callable[[nn.Module, torch.Generator], None],
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
) -> tuple:
    """Materialise meta-built models on the CPU, draw their weights in order from
    one generator seeded with ``seed`` (``init_params``, or `lpips.init_params`
    for the perceptual network), and move them to ``device``."""
    rng = torch.Generator().manual_seed(seed)
    device = default_device(device)
    for model in models:
        model.to_empty(device="cpu")
        (lpips.init_params if isinstance(model, lpips.PerceptualLoss) else init_params)(model, rng)
    return tuple(model.to(device) for model in models)


@contextlib.contextmanager
def frozen(model: nn.Module):
    """The model's parameters take no gradient inside the block."""
    model.requires_grad_(False)
    try:
        yield
    finally:
        model.requires_grad_(True)


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
        """Save ``payload`` (the dict layout above) as epoch ``epoch``; it also
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
        stripped from its model state dicts."""
        if best:
            path = self._best_path
        else:
            if epoch is None:
                epoch = self.latest_epoch()
            if epoch is None:
                raise FileNotFoundError(f"no checkpoints in {self.ckpt_dir}")
            path = os.path.join(self.ckpt_dir, f"epoch_{epoch}")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        for key in ("unet", "discriminator", "encoder", "t1_decoder", "pet_decoder", "perceptual", "model",
                    "generator"):
            if key in payload:
                payload[key] = strip_ddp_prefix(payload[key])
        return payload


class MetricWriter:
    """Appends ``{"step", "prefix", **metrics}`` records to ``{log_dir}/metrics.jsonl``;
    writes nothing when not ``enabled`` (every rank but rank 0)."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self.enabled = enabled
        self._jsonl = None
        if enabled:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a", encoding="utf-8")

    def scalars(self, prefix: str, metrics: Mapping[str, float], step: int) -> None:
        if self._jsonl is None:
            return
        clean = {k: float(v) for k, v in metrics.items()}
        self._jsonl.write(json.dumps({"step": step, "prefix": prefix, **clean}) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()


def mean_over_ranks(metrics: Mapping[str, torch.Tensor], mesh: Optional[Mesh] = None) -> Dict[str, float]:
    """Each 0-d metric as a float, averaged over the data groups: every group's
    batch is the same size, so this is the mean over the global batch that the
    JAX step returns. The ranks of a space group hold one value (their losses are
    the whole volume's), so the mean is taken over the ranks at this rank's space
    index (``mesh.data_group``; the world without a space axis). Every rank must
    call it at the same step (one all-reduce). Span ``train.metric_read``."""
    with span("train.metric_read"):
        if mesh is None or not mesh.distributed:
            return {k: float(v) for k, v in metrics.items()}
        stacked = torch.stack([torch.as_tensor(v, dtype=torch.float32).to(mesh.device).reshape(())
                               for v in metrics.values()])
        dist.all_reduce(stacked, group=mesh.data_group)
        return dict(zip(metrics, (stacked / mesh.data_count).tolist()))


def global_mean(values: Sequence[float], mesh: Optional[Mesh] = None) -> float:
    """The mean of every rank's ``values`` (sums and counts all-reduced); NaN when
    there are none."""
    if mesh is None or not mesh.distributed:
        return float(np.mean(values)) if len(values) else float("nan")
    sums = torch.tensor([sum(values), len(values)], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(sums)
    total, count = sums.tolist()
    return total / count if count else float("nan")


def guard_nonfinite(loss: torch.Tensor, mesh: Optional[Mesh] = None) -> bool:
    """Failure detection for a train step (the reference has none): True when
    ``loss`` is finite on every rank. A guarded step asks before any optimiser
    step and, on False, skips the generator's and the discriminator's updates
    together, as the JAX package discards both; across ranks the decision is
    taken on the all-reduced count of non-finite losses, so every rank skips
    together (JAX tests the global loss), and replicas never part; a space
    group's ranks hold one loss, a non-finite one on all of them. It costs one
    device-to-host read per step, and one all-reduce across ranks."""
    bad = (~torch.isfinite(loss.detach())).float().reshape(())
    if mesh is not None and mesh.distributed:
        bad = bad.to(mesh.device)
        dist.all_reduce(bad)
    return bad.item() == 0


class StepTimer:
    """Per-step wall-clock laps (host clock; a lap that should include the
    device's work must end in a synchronize or a host read), kept in ``history``."""

    def __init__(self):
        self._last = time.perf_counter()
        self.history: List[float] = []

    def lap(self) -> float:
        """Seconds since the previous lap (or since construction)."""
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.history.append(dt)
        return dt

    def mean(self, skip: int = 1) -> float:
        """The mean lap after the first ``skip`` (all of them when there are no more)."""
        laps = self.history[skip:] or self.history
        return sum(laps) / max(len(laps), 1)
