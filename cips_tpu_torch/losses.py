"""Training losses of the flagship GAN and the causal generator (port of cips_tpu/losses.py).

  * L1 — mean absolute error (the reference's ``nn.L1Loss()``);
  * `kl_divergence(mu, logvar)` — -0.5 * sum(1 + logvar - mu^2 - exp(logvar))
    per sample, then the mean over the batch (the causal and BMGAN form);
  * `patch_adversarial_loss` — MONAI PatchAdversarialLoss(criterion=
    "least_squares", no_activation_leastsq=True): MSE of the raw patch logits
    against 1 (real) or 0 (fake); the generator's form targets real on fakes;
  * `lsgan_discriminator_loss` — 0.5 * (MSE(fake, 0) + MSE(real, 1)).

All reductions are in fp32. Every loss takes a ``space`` group when its
inputs are depth slabs (the mesh's ``space`` axis): a mean is then the whole
volume's, the global sum over the global count (`spatial.space_mean`), and
the KL's per-sample sums are summed over the group before the batch mean.
"""

from __future__ import annotations

from typing import Optional

import torch

from cips_tpu_torch.parallel.spatial import SpaceGroup, space_mean, space_sum


def _mean(x: torch.Tensor, space: Optional[SpaceGroup]) -> torch.Tensor:
    return x.mean() if space is None else space_mean(x, space)


def l1_loss(pred: torch.Tensor, target: torch.Tensor, space: Optional[SpaceGroup] = None) -> torch.Tensor:
    return _mean((pred.float() - target.float()).abs(), space)


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor, space: Optional[SpaceGroup] = None) -> torch.Tensor:
    """KL(N(mu, exp(logvar)) || N(0, 1)), summed per sample, mean over the batch."""
    mu, logvar = mu.float(), logvar.float()
    per_sample = -0.5 * (1.0 + logvar - mu * mu - logvar.exp()).flatten(1).sum(dim=1)
    if space is not None:
        per_sample = space_sum(per_sample, space, "mean")
    return per_sample.mean()


def patch_adversarial_loss(logits: torch.Tensor, *, target_is_real: bool, for_discriminator: bool,
                           space: Optional[SpaceGroup] = None) -> torch.Tensor:
    """LSGAN loss on patch logits. The generator's form (for_discriminator=False)
    is only valid with target_is_real=True."""
    if not for_discriminator and not target_is_real:
        raise ValueError("generator adversarial loss targets the real label")
    diff = logits.float() - (1.0 if target_is_real else 0.0)
    return _mean(diff * diff, space)


def lsgan_discriminator_loss(logits_fake: torch.Tensor, logits_real: torch.Tensor,
                             space: Optional[SpaceGroup] = None) -> torch.Tensor:
    loss_fake = patch_adversarial_loss(logits_fake, target_is_real=False, for_discriminator=True, space=space)
    loss_real = patch_adversarial_loss(logits_real, target_is_real=True, for_discriminator=True, space=space)
    return 0.5 * (loss_fake + loss_real)
