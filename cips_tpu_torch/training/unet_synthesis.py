"""Conditional AttenUNet T1->PET synthesis, the flagship workload (port of
cips_tpu/training/unet_synthesis.py).

  * G loss = L1 + perceptual_weight * LPIPS + adv_weight * LSGAN, computed
    with the pre-update D and the frozen perceptual network (built only when
    its weight is above 0);
  * D loss = 0.5 * (MSE(fake -> 0) + MSE(real -> 1)) on cat([fake, pet]), or
    in two passes with ``split_d`` (the same math: PatchGAN is per-sample);
  * the JAX package's two gradient computations become the reference's
    ``requires_grad`` gating: D's parameters take no gradient in the G backward;
  * D trains on the pre-update generator's fake, detached, by default (the
    JAX package's one-step-stale choice, which saves a generator forward);
    ``exact_d_fake`` regenerates it with the updated G under no_grad, as the
    reference does;
  * the condition is the covariate row as (B, 1, K), or zeros when unconditional.

The train step updates G, D and their Adam optimisers in place and returns the
JAX package's metrics. Across ranks (``mesh``) G and D train under DDP
(`GANState.g_dp`, `d_dp`); the critic's forward in the G step, frozen, and the
``exact_d_fake`` regeneration go to the networks themselves, so that every
forward through a wrapper is followed by the one backward that reaches all of
its parameters; the non-finite guard is decided over all ranks. With the
mesh's ``space`` axis (`GANState.space`) the train step runs G, D and the
losses on depth slabs over the space group (`parallel.spatial`): every loss is
the whole volume's on each rank of the group, and with the backward's sums over
the group and DDP's mean over the world, every rank's gradient is the
one-process gradient of the global batch. A batch whose depth the group does
not divide reaches its ranks whole (the mesh's rule, JAX's `shard_batch`) and
runs unsharded on each (`spatial.space_for`): each rank's gradient is then the
sample's whole one, and DDP's mean gives the same. The eval step and serving
take whole volumes.

Remat, as in the JAX package: ``remat`` in ``atten_unet_def`` (or
`build_models`' argument) recomputes G's blocks in the backward (`AttenUNet`),
and ``d_remat`` (the training config's key, or ``CIPS_D_REMAT=1``) recomputes
the frozen D tower and the LPIPS call inside the G step's backward
(``torch.utils.checkpoint``, as JAX's ``jax.checkpoint(d_apply)`` and
``jax.checkpoint(p_apply)``). Both trade a forward for activation memory and
leave the result as it is. Both are off by default: JAX turns remat on because
the full backward does not fit a TPU's 16 GB of HBM at the working volume; the
port's batch-2 step peaks at 9.39 GiB of the H100's 80 (PERF.md §5).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from cips_tpu_torch.losses import l1_loss, lsgan_discriminator_loss, patch_adversarial_loss
from cips_tpu_torch.models import perceptual as lpips
from cips_tpu_torch.models.atten_unet import AttenUNet, init_params
from cips_tpu_torch.models.discriminator import PatchDiscriminator
from cips_tpu_torch.parallel import spatial
from cips_tpu_torch.parallel.mesh import Mesh, data_parallel
from cips_tpu_torch.training.common import adam, d_remat_from, frozen, guard_nonfinite, init_models, rematted

VOLUME_SHAPE = (96, 128, 96)


@dataclass
class GANState:
    """The two networks, their Adam optimisers, the count of applied steps and
    the frozen perceptual network (None when its weight is 0). ``g_dp`` and
    ``d_dp`` are the networks as the step trains them: their DDP wrappers
    across ranks, else the networks themselves. ``space``: the space group
    whose ranks hold depth slabs of this rank's rows (None: whole volumes)."""

    g: AttenUNet
    d: PatchDiscriminator
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    step: int = 0
    perceptual: Optional[lpips.PerceptualLoss] = None
    g_dp: Optional[nn.Module] = field(default=None, repr=False)
    d_dp: Optional[nn.Module] = field(default=None, repr=False)
    space: Optional[spatial.SpaceGroup] = field(default=None, repr=False)

    def __post_init__(self):
        self.g_dp = self.g if self.g_dp is None else self.g_dp
        self.d_dp = self.d if self.d_dp is None else self.d_dp


def build_models(
    model_cfg: Mapping[str, Any],
    n_covariates: int,
    dtype: torch.dtype = torch.bfloat16,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
    remat: bool = False,
    remat_policy: Optional[str] = None,
) -> Tuple[AttenUNet, PatchDiscriminator, Optional[lpips.PerceptualLoss]]:
    """(generator, discriminator, perceptual) from a reference-schema config dict,
    with cross_attention_dim := max(number of covariates, 1). The perceptual
    network (``perceptual_network``: LPIPS squeeze in the bundled config) is
    built only when ``training.perceptual_weight`` is above 0, else None.
    Weights are drawn from one generator seeded with ``seed``: G's, D's, then
    the perceptual network's fallback (load real LPIPS weights with
    `lpips.params_from_npz`). ``remat`` and ``remat_policy`` are the defaults
    of the config's ``atten_unet_def`` keys of those names, as in JAX (off here)."""
    unet_def = dict(model_cfg["atten_unet_def"])
    unet_def["cross_attention_dim"] = max(n_covariates, 1)
    unet_def["with_conditioning"] = True
    unet_def.setdefault("remat", remat)
    unet_def.setdefault("remat_policy", remat_policy if unet_def["remat"] else None)
    with_perceptual = float(model_cfg.get("training", {}).get("perceptual_weight", 0.0)) > 0
    with torch.device("meta"):
        models = [AttenUNet(dtype=dtype, **unet_def),
                  PatchDiscriminator(dtype=dtype, **model_cfg.get("discriminator", {}))]
        if with_perceptual:
            models.append(lpips.PerceptualLoss(dtype=dtype, **model_cfg.get("perceptual_network", {})))
    generator, discriminator, *perceptual = init_models(models, init_params, device, seed)
    return generator, discriminator, (perceptual[0] if perceptual else None)


def init_state(
    generator: AttenUNet,
    discriminator: PatchDiscriminator,
    train_cfg: Mapping[str, Any],
    perceptual: Optional[lpips.PerceptualLoss] = None,
    mesh: Optional[Mesh] = None,
) -> GANState:
    """The state; ``perceptual`` is kept only when ``perceptual_weight`` is above 0,
    and is then required (a ValueError without it). Across ranks G and D are
    wrapped for data-parallel training (rank 0's weights broadcast); the
    mesh's space group, if any, shards the train step's volumes."""
    with_perceptual = _weights(train_cfg)[0] > 0
    if with_perceptual and perceptual is None:
        raise ValueError("perceptual_weight is above 0 but no perceptual network was given")
    return GANState(
        g=generator,
        d=discriminator,
        opt_g=adam(generator.parameters(), train_cfg.get("base_lr", 5e-4)),
        opt_d=adam(discriminator.parameters(), train_cfg.get("disc_lr", 1e-4)),
        perceptual=perceptual if with_perceptual else None,
        g_dp=data_parallel(generator, mesh),
        d_dp=data_parallel(discriminator, mesh),
        space=mesh.space if mesh is not None else None,
    )


def _condition(batch: Mapping[str, torch.Tensor], use_condition: bool) -> torch.Tensor:
    info = batch["info"]
    if info.shape[-1] == 0:
        info = torch.zeros(info.shape[:-1] + (1,), dtype=torch.float32, device=info.device)
    return info if use_condition else torch.zeros_like(info)


def _weights(train_cfg: Mapping[str, Any]) -> Tuple[float, float]:
    """(perceptual_weight, adv_weight), the JAX package's defaults 0 and 0.1."""
    return float(train_cfg.get("perceptual_weight", 0.0)), float(train_cfg.get("adv_weight", 0.1))


def _perceptual(state: GANState, pw: float, fake: torch.Tensor, pet: torch.Tensor,
                space: Optional[spatial.SpaceGroup] = None, remat: bool = False) -> torch.Tensor:
    """The LPIPS term (unweighted), or 0 without a weight; recomputed in the backward with ``remat``."""
    if pw > 0:
        return rematted(lambda f: state.perceptual(f, pet, space=space), fake, remat)
    return torch.zeros((), device=fake.device)


def make_train_step(
    train_cfg: Mapping[str, Any],
    use_condition: bool = True,
    exact_d_fake: Optional[bool] = None,
    split_d: Optional[bool] = None,
    nan_guard: bool = False,
    mesh: Optional[Mesh] = None,
    volume_depth: Optional[int] = None,
) -> Callable[[GANState, Mapping[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """One G step then one D step on a batch {"t1", "pet", "info"} of device
    tensors (this rank's rows of it across ranks; over ``state.space``, depth
    slabs of volumes of depth ``volume_depth`` (None: always slabs), or whole
    volumes where the group does not divide it). Metrics (0-d tensors): g_loss, rec_loss, p_loss (unweighted, as
    JAX reports it), adv_loss and d_loss, the last two times adv_weight. With
    ``nan_guard``, a non-finite g_loss skips both optimiser steps (the step
    count stays) and the metrics gain ``skipped_nonfinite``. ``d_remat``
    (`common.d_remat_from`) recomputes D and LPIPS in the G step's backward."""
    pw, aw = _weights(train_cfg)
    d_remat = d_remat_from(train_cfg)
    if exact_d_fake is None:
        exact_d_fake = bool(train_cfg.get("exact_d_fake", False))
    if split_d is None:
        split_d = bool(train_cfg.get("split_d", False))

    def train_step(state: GANState, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        space = spatial.space_for(state.space, batch["t1"].shape[1], volume_depth)
        with spatial.sharded((state.g, state.d), space):
            return sharded_step(state, batch, space)

    def sharded_step(state: GANState, batch: Mapping[str, torch.Tensor],
                     space: Optional[spatial.SpaceGroup]) -> Dict[str, torch.Tensor]:
        t1, pet = batch["t1"], batch["pet"]
        cond = _condition(batch, use_condition)
        zero = torch.zeros((), device=t1.device)

        state.opt_g.zero_grad(set_to_none=True)
        with frozen(state.d):
            fake = state.g_dp(t1, cond)
            rec = l1_loss(fake, pet, space)
            p = _perceptual(state, pw, fake, pet, space, d_remat)
            adv = (patch_adversarial_loss(rematted(lambda f: state.d(f)[-1], fake, d_remat), target_is_real=True,
                                          for_discriminator=False, space=space) if aw > 0 else zero)
            g_loss = rec + pw * p + aw * adv
            g_loss.backward()
        metrics = {"g_loss": g_loss.detach(), "rec_loss": rec.detach(), "p_loss": p.detach(),
                   "adv_loss": adv.detach() * aw}
        if nan_guard:
            ok = guard_nonfinite(g_loss, mesh)
            metrics["skipped_nonfinite"] = torch.tensor(0.0 if ok else 1.0)
            if not ok:
                metrics["d_loss"] = torch.tensor(float("nan"))
                return metrics
        state.opt_g.step()

        if aw > 0:
            if exact_d_fake:
                with torch.no_grad():
                    fake = state.g(t1, cond)
            fake = fake.detach()
            state.opt_d.zero_grad(set_to_none=True)
            if split_d:
                logits_fake, logits_real = state.d_dp(fake)[-1], state.d_dp(pet)[-1]
            else:
                logits_fake, logits_real = state.d_dp(torch.cat([fake, pet], dim=0))[-1].chunk(2, dim=0)
            d_loss = lsgan_discriminator_loss(logits_fake, logits_real, space)
            d_loss.backward()
            state.opt_d.step()
            metrics["d_loss"] = d_loss.detach() * aw
        else:
            metrics["d_loss"] = zero
        state.step += 1
        return metrics

    return train_step


def make_eval_step(
    train_cfg: Mapping[str, Any], use_condition: bool = True
) -> Callable[[GANState, Mapping[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Per-epoch eval losses and the synthesized volume (``fake``); no updates."""
    pw, aw = _weights(train_cfg)

    def eval_step(state: GANState, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            fake = state.g(batch["t1"], _condition(batch, use_condition))
            rec = l1_loss(fake, batch["pet"])
            p = _perceptual(state, pw, fake, batch["pet"])
            adv = (patch_adversarial_loss(state.d(fake)[-1], target_is_real=True, for_discriminator=False)
                   if aw > 0 else torch.zeros((), device=fake.device))
            return {"rec_loss": rec, "p_loss": p, "adv_loss": adv * aw, "g_loss": rec + pw * p + aw * adv,
                    "fake": fake}

    return eval_step


def make_predict_fn(generator: AttenUNet, use_condition: bool = True) -> Callable:
    """Inference forward: {"t1", "info"} batch -> synthesized (N, D, H, W, 1) volume."""

    def predict(batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
            return generator(batch["t1"], _condition(batch, use_condition))

    return predict
