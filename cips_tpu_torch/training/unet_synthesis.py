"""Conditional AttenUNet T1->PET synthesis, the flagship workload (port of the
serving half of cips_tpu/training/unet_synthesis.py).

The condition is the covariate row as (B, 1, K), or zeros when unconditional.
The discriminator, the perceptual network and the train/eval steps belong to
the training slice and are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Tuple, Union

import torch

from cips_tpu_torch import default_device
from cips_tpu_torch.models.atten_unet import AttenUNet, init_params

VOLUME_SHAPE = (96, 128, 96)


def build_models(
    model_cfg: Mapping[str, Any],
    n_covariates: int,
    dtype: torch.dtype = torch.bfloat16,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[AttenUNet, None, None]:
    """(generator, discriminator, perceptual) from a reference-schema config dict,
    with cross_attention_dim := max(number of covariates, 1). The generator's
    weights are drawn from a generator seeded with 0; the two other networks
    are not ported yet and are returned as None."""
    unet_def = dict(model_cfg["atten_unet_def"])
    unet_def["cross_attention_dim"] = max(n_covariates, 1)
    unet_def["with_conditioning"] = True
    with torch.device("meta"):
        generator = AttenUNet(dtype=dtype, **unet_def)
    generator.to_empty(device="cpu")
    init_params(generator, torch.Generator().manual_seed(0))
    return generator.to(default_device(device)), None, None


def _condition(batch: Mapping[str, torch.Tensor], use_condition: bool) -> torch.Tensor:
    info = batch["info"]
    if info.shape[-1] == 0:
        info = torch.zeros(info.shape[:-1] + (1,), dtype=torch.float32, device=info.device)
    return info if use_condition else torch.zeros_like(info)


def make_predict_fn(generator: AttenUNet, use_condition: bool = True) -> Callable:
    """Inference forward: {"t1", "info"} batch -> synthesized (N, D, H, W, 1) volume."""

    def predict(batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
            return generator(batch["t1"], _condition(batch, use_condition))

    return predict
