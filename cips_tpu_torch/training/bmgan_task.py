"""BMGAN training, the bidirectional-mapping GAN baseline (port of
cips_tpu/training/bmgan_task.py).

Each step updates three networks with three Adams, in the JAX package's order:
  G: adv(D(G(t1, z)) -> real) + lamda_l1 * L1 + lamda_perceptual * LPIPS
     (alex, the reference's MONAI default), D's parameters taking no gradient;
  E: KL(E(real pet)) + KL(E(fake)) in one batched pass over [pet; fake];
  D: LSGAN 0.5 * (MSE(fake -> 0) + MSE(real -> 1)) over [fake; pet].
E and D see the pre-update generator's fake, detached, by default (the JAX
package's one-step-stale choice, which saves two generator forwards);
``exact_d_fake`` regenerates it with the updated G under no_grad, as the
reference does. No covariates.

The latent z ~ N(0, 1) of shape (B, latent_dim) is drawn by `sample_latent`
from the caller's ``torch.Generator``; tests replace it to feed the latent
that the JAX package draws. Across ranks (``mesh``) G, E and D train under DDP,
each through its wrapper in its own step only (the frozen critic in the G
step and the ``exact_d_fake`` regeneration go to the networks themselves),
and z is drawn for the global batch and cut to this rank's rows.

Remat, as in the JAX package: `build_models`' ``remat`` recomputes the
generator's dense blocks in the backward, and ``d_remat`` (`make_train_step`'s
argument, else ``CIPS_D_REMAT=1``) recomputes the frozen D and the LPIPS call
inside the G step's backward. Neither changes the result; both are off by
default (the batch-2 step peaks at 18.39 GiB of the H100's 80, PERF.md §5).
"""

from __future__ import annotations

from dataclasses import dataclass, field
import os
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from cips_tpu_torch.losses import kl_divergence, l1_loss, lsgan_discriminator_loss, patch_adversarial_loss
from cips_tpu_torch.models import bmgan
from cips_tpu_torch.models import perceptual as lpips
from cips_tpu_torch.parallel.mesh import Mesh, data_parallel
from cips_tpu_torch.training.common import adam, frozen, init_models, rematted


@dataclass
class BMGANState:
    """G, E, D, the frozen perceptual network (None when its weight is 0), their
    three Adams and the count of applied steps. ``g_dp``, ``e_dp`` and ``d_dp``
    are the networks as their steps train them: DDP wrappers across ranks,
    else the networks themselves."""

    g: bmgan.DenseUNetGenerator
    e: bmgan.ResNetEncoder
    d: bmgan.BMGANDiscriminator
    perceptual: Optional[lpips.PerceptualLoss]
    opt_g: torch.optim.Adam
    opt_e: torch.optim.Adam
    opt_d: torch.optim.Adam
    step: int = 0
    g_dp: Optional[nn.Module] = field(default=None, repr=False)
    e_dp: Optional[nn.Module] = field(default=None, repr=False)
    d_dp: Optional[nn.Module] = field(default=None, repr=False)

    def __post_init__(self):
        for name in "ged":
            if getattr(self, f"{name}_dp") is None:
                setattr(self, f"{name}_dp", getattr(self, name))


def build_models(
    dtype: torch.dtype = torch.bfloat16,
    latent_dim: int = bmgan.LATENT_DIM,
    input_shape: Sequence[int] = bmgan.VOLUME_SHAPE,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
    remat: bool = False,
    remat_policy: str = "conv_all",
) -> Tuple[bmgan.DenseUNetGenerator, bmgan.ResNetEncoder, bmgan.BMGANDiscriminator, lpips.PerceptualLoss]:
    """(generator, encoder, discriminator, perceptual) at the reference's widths,
    the encoder's heads sized for ``input_shape`` volumes; the perceptual net is
    LPIPS alex. Weights from one generator seeded with ``seed``, in that order
    (load real LPIPS weights with `lpips.params_from_npz`). ``remat`` recomputes
    the generator's dense blocks in the backward (``remat_policy``: JAX's names)."""
    with torch.device("meta"):
        models = (bmgan.DenseUNetGenerator(latent_dim=latent_dim, remat=remat, remat_policy=remat_policy, dtype=dtype),
                  bmgan.ResNetEncoder(latent_dim=latent_dim, input_shape=input_shape, dtype=dtype),
                  bmgan.BMGANDiscriminator(dtype=dtype),
                  lpips.PerceptualLoss(spatial_dims=3, network_type="alex", dtype=dtype))
    return init_models(models, bmgan.init_params, device, seed)


def init_state(
    generator: bmgan.DenseUNetGenerator,
    encoder: bmgan.ResNetEncoder,
    discriminator: bmgan.BMGANDiscriminator,
    perceptual: Optional[lpips.PerceptualLoss],
    lr: float = 2e-4,
    perceptual_weight: float = 8.0,
    mesh: Optional[Mesh] = None,
) -> BMGANState:
    return BMGANState(
        g=generator, e=encoder, d=discriminator, perceptual=perceptual if perceptual_weight > 0 else None,
        opt_g=adam(generator.parameters(), lr), opt_e=adam(encoder.parameters(), lr),
        opt_d=adam(discriminator.parameters(), lr),
        g_dp=data_parallel(generator, mesh), e_dp=data_parallel(encoder, mesh), d_dp=data_parallel(discriminator, mesh),
    )


def sample_latent(
    shape: Tuple[int, ...], dtype: torch.dtype, device: torch.device, generator: torch.Generator
) -> torch.Tensor:
    """Standard normal latents of ``shape`` from ``generator`` (on ``device``), in ``dtype``."""
    return torch.randn(shape, generator=generator, device=device).to(dtype)


def _latent(t1: torch.Tensor, latent_dim: int, generator: torch.Generator,
            rows: Optional[Tuple[int, slice]] = None) -> torch.Tensor:
    """One latent a row of ``t1``; with ``rows`` = (n, s), drawn for n rows and cut to rows s."""
    if rows is None:
        return sample_latent((t1.shape[0], latent_dim), t1.dtype, t1.device, generator)
    n, s = rows
    return sample_latent((n, latent_dim), t1.dtype, t1.device, generator)[s]


def make_train_step(
    lamda_l1: float = 20.0,
    lamda_perceptual: float = 8.0,
    latent_dim: int = bmgan.LATENT_DIM,
    exact_d_fake: bool = False,
    mesh: Optional[Mesh] = None,
    batch_size: Optional[int] = None,
    d_remat: Optional[bool] = None,
) -> Callable[[BMGANState, Mapping[str, torch.Tensor], torch.Generator], Dict[str, torch.Tensor]]:
    """One G, one E and one D step on a batch {"t1", "pet"} of device tensors,
    z drawn from the given generator (across ranks, ``mesh`` and ``batch_size``
    the batch of one node: this rank's rows, z the global batch's cut to them). Updates the state in place and returns
    the JAX package's metrics (0-d tensors): g_loss, l1_loss, adv_loss, p_loss
    (the last three unweighted), e_loss and d_loss. ``d_remat`` (None: ``CIPS_D_REMAT=1``)
    recomputes D and LPIPS in the G step's backward."""
    if d_remat is None:
        d_remat = os.environ.get("CIPS_D_REMAT", "") == "1"

    rows = mesh.global_rows(batch_size) if mesh is not None and mesh.distributed and batch_size else None

    def train_step(state: BMGANState, batch: Mapping[str, torch.Tensor], generator: torch.Generator):
        t1, pet = batch["t1"], batch["pet"]
        z = _latent(t1, latent_dim, generator, rows)

        state.opt_g.zero_grad(set_to_none=True)
        with frozen(state.d):
            fake = state.g_dp(t1, z)
            adv = patch_adversarial_loss(rematted(state.d, fake, d_remat), target_is_real=True,
                                         for_discriminator=False)
            rec = l1_loss(fake, pet)
            p = (rematted(lambda f: state.perceptual(f, pet), fake, d_remat)
                 if lamda_perceptual > 0 and state.perceptual is not None else torch.zeros((), device=t1.device))
            g_loss = adv + lamda_l1 * rec + lamda_perceptual * p
            g_loss.backward()
        state.opt_g.step()
        if exact_d_fake:  # the updated generator's fake, with the step's z
            with torch.no_grad():
                fake = state.g(t1, z)
        fake = fake.detach()

        state.opt_e.zero_grad(set_to_none=True)
        mu, logvar = state.e_dp(torch.cat([pet, fake], dim=0))
        (mu_r, mu_f), (lv_r, lv_f) = mu.chunk(2, dim=0), logvar.chunk(2, dim=0)
        e_loss = kl_divergence(mu_r, lv_r) + kl_divergence(mu_f, lv_f)
        e_loss.backward()
        state.opt_e.step()

        state.opt_d.zero_grad(set_to_none=True)
        logits_fake, logits_real = state.d_dp(torch.cat([fake, pet], dim=0)).chunk(2, dim=0)
        d_loss = lsgan_discriminator_loss(logits_fake, logits_real)
        d_loss.backward()
        state.opt_d.step()
        state.step += 1
        return {"g_loss": g_loss.detach(), "l1_loss": rec.detach(), "adv_loss": adv.detach(), "p_loss": p.detach(),
                "e_loss": e_loss.detach(), "d_loss": d_loss.detach()}

    return train_step


def make_eval_step(
    latent_dim: int = bmgan.LATENT_DIM,
) -> Callable[[BMGANState, Mapping[str, torch.Tensor], torch.Generator], Dict[str, torch.Tensor]]:
    """Eval: the L1 of a generation from a sampled latent, and the volume (``fake``)."""

    def eval_step(state: BMGANState, batch: Mapping[str, torch.Tensor], generator: torch.Generator):
        with torch.inference_mode():
            fake = state.g(batch["t1"], _latent(batch["t1"], latent_dim, generator))
            return {"l1_loss": l1_loss(fake, batch["pet"]), "fake": fake}

    return eval_step


def make_generate_fn(
    generator: bmgan.DenseUNetGenerator, latent_dim: int = bmgan.LATENT_DIM
) -> Callable[[Mapping[str, torch.Tensor], torch.Generator], torch.Tensor]:
    """Inference: a {"t1"} batch and a latent drawn from the generator -> synthesized PET."""

    def generate(batch: Mapping[str, torch.Tensor], rng: torch.Generator) -> torch.Tensor:
        with torch.inference_mode():
            return generator(batch["t1"], _latent(batch["t1"], latent_dim, rng))

    return generate
