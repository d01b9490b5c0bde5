"""The sMCI/pMCI converter classifier, the downstream check of synthesized PET
(port of cips_tpu/training/classifier_task.py).

A DiffusionModelEncoder with the mlp head over the PET and/or T1 channels
(``in_channels`` 1 or 2), cross-attending to the covariate row when there is
one (``--use_tabular_info``), trained with the class-weighted cross entropy
(weights 1 and 4 for sMCI and pMCI, the weighted mean, as torch's
``CrossEntropyLoss(weight=...)``) under Adam. The JAX package packs level 0
space-to-depth by default; that is a TPU layout of the same function and is
not ported. Dropout follows the JAX step's ``dropout`` flag: on, the head's
dropout draws from torch's generator (JAX's draws from its key, so a step with
dropout matches JAX only in distribution); off, the step is deterministic.

Across ranks (``mesh``) the classifier trains under DDP, which averages the
ranks' gradients. The weighted mean's denominator is then the mean over the
ranks of their weight sums (one all-reduce), so that the average of the ranks'
losses is the global batch's weighted mean: a rank's own denominator would
weight its samples by its batch's mix of classes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from cips_tpu_torch import default_device
from cips_tpu_torch.models.atten_unet import init_params
from cips_tpu_torch.models.encoder import DiffusionModelEncoder
from cips_tpu_torch.parallel.mesh import Mesh, data_parallel
from cips_tpu_torch.training.common import adam

CLASS_WEIGHTS = (1.0, 4.0)  # sMCI, pMCI


@dataclass
class ClassifierState:
    """The classifier, its Adam optimiser and the count of applied steps;
    ``model_dp`` is the classifier as the step trains it: its DDP wrapper across
    ranks, else itself."""

    model: DiffusionModelEncoder
    opt: torch.optim.Adam
    step: int = 0
    model_dp: Optional[nn.Module] = field(default=None, repr=False)

    def __post_init__(self):
        self.model_dp = self.model if self.model_dp is None else self.model_dp


def build_model(
    model_cfg: Mapping[str, Any],
    in_channels: int,
    input_shape: Sequence[int],
    n_covariates: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
) -> DiffusionModelEncoder:
    """The classifier from a reference-schema config (``atten_encoder_def``) for
    (D, H, W) = ``input_shape`` volumes of ``in_channels`` channels; with
    covariates it cross-attends to them. Weights from a generator seeded with ``seed``."""
    cfg = dict(model_cfg["atten_encoder_def"])
    cfg["in_channels"] = in_channels
    cfg["with_conditioning"] = n_covariates > 0
    cfg["cross_attention_dim"] = n_covariates if n_covariates > 0 else None
    with torch.device("meta"):
        model = DiffusionModelEncoder(head="mlp", input_shape=tuple(input_shape), dtype=dtype, **cfg)
    model.to_empty(device="cpu")
    init_params(model, torch.Generator().manual_seed(seed))
    return model.to(default_device(device))


def init_state(model: DiffusionModelEncoder, lr: float = 1e-4, mesh: Optional[Mesh] = None) -> ClassifierState:
    return ClassifierState(model=model, opt=adam(model.parameters(), lr), model_dp=data_parallel(model, mesh))


def weighted_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, weights: Sequence[float] = CLASS_WEIGHTS,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Mean cross entropy with per-class weights, the weighted mean (sum of w_i
    nll_i over sum of w_i), in fp32. Across ranks the denominator is the mean
    of the ranks' weight sums (see the module's docstring)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    w = torch.tensor(weights, dtype=torch.float32, device=logits.device)[labels]
    nll = -logp.gather(-1, labels[:, None].long())[:, 0]
    total = w.sum()
    if mesh is not None and mesh.distributed:
        dist.all_reduce(total)
        total = total / mesh.world_size
    return (w * nll).sum() / total.clamp_min(1e-12)


def _forward(model: nn.Module, batch: Mapping[str, torch.Tensor], use_tabular: bool) -> torch.Tensor:
    return model(batch["imgs"], batch["info"] if use_tabular else None)


def make_train_step(
    use_tabular: bool, dropout: bool = True, mesh: Optional[Mesh] = None
) -> Callable[[ClassifierState, Mapping[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """One Adam step on a batch {"imgs", "info", "labels"} of device tensors
    (this rank's rows of it across ranks); returns ce_loss, accuracy (0-d) and
    the step's logits (fp32)."""

    def train_step(state: ClassifierState, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        labels = batch["labels"].long()
        state.model_dp.train(dropout)
        state.opt.zero_grad(set_to_none=True)
        logits = _forward(state.model_dp, batch, use_tabular)
        loss = weighted_cross_entropy(logits, labels, mesh=mesh)
        loss.backward()
        state.opt.step()
        state.step += 1
        logits = logits.detach().float()
        return {"ce_loss": loss.detach(), "accuracy": (logits.argmax(-1) == labels).float().mean(),
                "logits": logits}

    return train_step


def make_predict_fn(
    model: DiffusionModelEncoder, use_tabular: bool
) -> Callable[[Mapping[str, torch.Tensor]], torch.Tensor]:
    """Inference forward (dropout off): a {"imgs", "info"} batch -> (N, 2) fp32 logits."""

    def predict(batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return _forward(model, batch, use_tabular).float()

    return predict
