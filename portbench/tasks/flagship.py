"""The flagship conditional AttenUNet GAN through the port's own train step
(`cips_tpu_torch.training.unet_synthesis`), on the benchmark's weights."""

from __future__ import annotations

from typing import Mapping

import torch

from portbench.data import prefixed
from portbench.program import Program, materialise
from portbench.reference.train import Flagship as REFERENCE  # noqa: F401  (the harness reads it)


def build(cfg: Mapping, weights: Mapping[str, torch.Tensor], mesh, seed: int, dtype: torch.dtype) -> Program:
    from cips_tpu_torch.models import perceptual as lpips
    from cips_tpu_torch.models.atten_unet import AttenUNet
    from cips_tpu_torch.models.discriminator import PatchDiscriminator
    from cips_tpu_torch.training import unet_synthesis

    if not cfg["atten_unet_def"].get("resblock_updown"):
        raise ValueError("the reference resamples with resnets: resblock_updown must be true")
    train = cfg["training"]
    unet_def = dict(cfg["atten_unet_def"], cross_attention_dim=cfg["covariates"], with_conditioning=True)
    with torch.device("meta"):
        g = AttenUNet(dtype=dtype, **unet_def)
        d = PatchDiscriminator(dtype=dtype, **cfg["discriminator"])
        p = (lpips.PerceptualLoss(dtype=dtype, **cfg.get("perceptual_network", {}))
             if float(train.get("perceptual_weight", 0)) > 0 else None)
    for name, net in (("g", g), ("d", d), ("p", p)):
        if net is not None:
            materialise(net, prefixed(weights, name), mesh.device)
    state = unet_synthesis.init_state(g, d, train, p, mesh=mesh)
    step_fn = unet_synthesis.make_train_step(train, use_condition=True, mesh=mesh, volume_depth=cfg["volume"][0])
    return Program(state=state, step=lambda batch: step_fn(state, batch), nets={"g": g, "d": d},
                   opts={"g": state.opt_g, "d": state.opt_d}, outputs={"fake": g})


def reference_noise(cfg: Mapping, batch: int, steps: int, seed: int, device) -> None:
    """The flagship's step draws no noise."""
    return None
