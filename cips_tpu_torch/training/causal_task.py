"""The causal unified generator, the paper's core model (port of
cips_tpu/training/causal_task.py).

T1 -> spatial DiffusionModelEncoder -> a 2z-channel latent split into
(z_mu, z_sigma); reparameterised samples z_mu + eps * z_sigma feed (a) the VAE
Decoder, which reconstructs T1, and (b) the DiffusionModelDecoder, which
cross-attends to the covariate row and synthesizes PET. Anatomy lives in the
KL-constrained latent; the covariates enter only through the PET decoder's
cross-attention.

Losses (config training_causal.json):
  g_loss  = L1(PET) + perceptual_weight * LPIPS + adv_weight * LSGAN
  t1_loss = L1(T1) + kl_weight * KL(z_mu, z_sigma), z_sigma fed as the logvar,
            exactly as the JAX package and the reference do;
  one Adam over encoder + T1 decoder + PET decoder on g_loss + t1_loss, D's
  parameters taking no gradient; then a D step on the detached fake. By
  default the fake is the pre-update one (the JAX package's one-step-stale
  choice); ``exact_d_fake`` regenerates it with the updated encoder and PET
  decoder under no_grad, with the PET step's noise, as JAX does.

The noise eps is drawn by `sample_noise` from the caller's ``torch.Generator``:
eps_t1 first, then eps_pet. Across ranks (``mesh``) the trio and D train under
DDP, the trio as one module (`CausalGenerator`); each noise is drawn for the
global batch and the global latent depth and sliced to this rank's rows and
depth slab, so W ranks draw what one process draws for the whole batch; the
frozen critic and the ``exact_d_fake`` regeneration go to the networks
themselves, and the non-finite guard is decided over all ranks. With the
mesh's ``space`` axis (`CausalState.space`) the train step runs the trio, D
and every loss on depth slabs over the space group (`parallel.spatial`), as
the flagship's does: the encoder's and the PET decoder's self-attentions
gather K and V, the perceptual term gathers both volumes, and each loss is
the whole volume's on every rank of the group; a batch whose depth the group
does not divide reaches its ranks whole and runs unsharded on each
(`spatial.space_for`). Tests replace `sample_noise` to feed the noise
that the JAX package draws. The unpacked function: the JAX package's
space-to-depth packing is a TPU layout device that does not change the
result, and is not ported.

Remat, as in the JAX package: ``remat`` (and ``remat_policy``) in the
encoder's, the T1 decoder's and the PET decoder's defs, or `build_models`'
argument, recomputes their resnets in the backward, the attentions staying
outside it; ``d_remat`` (the training config's key, or ``CIPS_D_REMAT=1``)
recomputes the frozen D and the LPIPS call inside the generator step's
backward. Neither changes the result. Off by default: JAX turns remat on
because the trio's backward does not fit a TPU's 16 GB at the working volume;
the port's batch-2 step peaks at 22.80 GiB of the H100's 80 (PERF.md §5).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from cips_tpu_torch.losses import kl_divergence, l1_loss, lsgan_discriminator_loss, patch_adversarial_loss
from cips_tpu_torch.models import perceptual as lpips
from cips_tpu_torch.models.atten_unet import init_params
from cips_tpu_torch.models.autoencoder_kl import Decoder
from cips_tpu_torch.models.decoder import DiffusionModelDecoder
from cips_tpu_torch.models.discriminator import PatchDiscriminator
from cips_tpu_torch.models.encoder import DiffusionModelEncoder
from cips_tpu_torch.parallel import spatial
from cips_tpu_torch.parallel.mesh import Mesh, data_parallel
from cips_tpu_torch.training.common import adam, d_remat_from, frozen, guard_nonfinite, init_models, rematted
from cips_tpu_torch.profiling import span

GENERATOR_PARTS = ("encoder", "t1_decoder", "pet_decoder")


class CausalGenerator(nn.ModuleDict):
    """The trio (encoder, t1_decoder, pet_decoder) as one module, whose forward is
    the generator step's: DDP wraps the three together."""

    space: Optional[spatial.SpaceGroup] = None

    def forward(self, t1: torch.Tensor, info: torch.Tensor,
                noise: Callable[[torch.Tensor, Optional[int]], torch.Tensor]):
        """(z_mu, z_sigma, the T1 reconstruction, the PET synthesis, eps_pet):
        ``noise(z_sigma, depth)`` draws eps_t1, then eps_pet, ``depth`` being the
        latent's global depth over a space group (None without one)."""
        z_mu, z_sigma, depth = _encode(self, t1)
        eps_t1 = noise(z_sigma, depth)
        t1_rec = self["t1_decoder"](z_mu + eps_t1 * z_sigma, depth=depth)
        eps_pet = noise(z_sigma, depth)
        rec_pet = self["pet_decoder"](z_mu + eps_pet * z_sigma, info, depth=depth)
        return z_mu, z_sigma, t1_rec, rec_pet, eps_pet


@dataclass
class CausalState:
    """The trio (``gen``: encoder, t1_decoder, pet_decoder), D, the frozen
    perceptual net (None when its weight is 0), the two Adams and the step count.
    ``gen_dp`` and ``d_dp`` are the trio and D as the step trains them: their
    DDP wrappers across ranks, else themselves. ``space``: the space group whose
    ranks hold depth slabs of this rank's rows (None: whole volumes)."""

    gen: CausalGenerator
    d: PatchDiscriminator
    perceptual: Optional[lpips.PerceptualLoss]
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    step: int = 0
    gen_dp: Optional[nn.Module] = field(default=None, repr=False)
    d_dp: Optional[nn.Module] = field(default=None, repr=False)
    space: Optional[spatial.SpaceGroup] = field(default=None, repr=False)

    def __post_init__(self):
        self.gen_dp = self.gen if self.gen_dp is None else self.gen_dp
        self.d_dp = self.d if self.d_dp is None else self.d_dp


def build_models(
    model_cfg: Mapping[str, Any],
    n_covariates: int,
    dtype: torch.dtype = torch.bfloat16,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
    remat: bool = False,
) -> Tuple[DiffusionModelEncoder, Decoder, DiffusionModelDecoder, PatchDiscriminator, lpips.PerceptualLoss]:
    """(encoder, t1_decoder, pet_decoder, discriminator, perceptual) from a
    reference-schema config dict. The PET decoder cross-attends to
    max(n_covariates, 1) features; the encoder gets no context, so its
    transformers attend to their own tokens in both attentions. Weights are
    drawn in that order from one generator seeded with ``seed``. ``remat`` is the
    default of each def's ``remat`` key, as in JAX (off here)."""
    enc_def = dict(model_cfg["t1_autoencoder_def"]["atten_encoder"])
    enc_def.pop("cross_attention_dim", None)
    t1_def = dict(model_cfg["t1_autoencoder_def"]["decoder"])
    pet_def = dict(model_cfg["pet_decoder_def"])
    pet_def["cross_attention_dim"] = max(n_covariates, 1)
    for part in (enc_def, t1_def, pet_def):
        part.setdefault("remat", remat)
    with torch.device("meta"):
        models = (
            DiffusionModelEncoder(head="spatial", dtype=dtype, **enc_def),
            Decoder(dtype=dtype, **t1_def),
            DiffusionModelDecoder(dtype=dtype, **pet_def),
            PatchDiscriminator(dtype=dtype, **model_cfg.get("discriminator", {})),
            lpips.PerceptualLoss(dtype=dtype, **model_cfg.get("perceptual_network", {})),
        )
    return init_models(models, init_params, device, seed)


def init_state(
    encoder: DiffusionModelEncoder,
    t1_decoder: Decoder,
    pet_decoder: DiffusionModelDecoder,
    discriminator: PatchDiscriminator,
    perceptual: lpips.PerceptualLoss,
    train_cfg: Mapping[str, Any],
    mesh: Optional[Mesh] = None,
) -> CausalState:
    """The state; across ranks the trio and D are wrapped for data-parallel
    training, and the mesh's space group, if any, shards the train step's volumes."""
    gen = CausalGenerator(dict(zip(GENERATOR_PARTS, (encoder, t1_decoder, pet_decoder))))
    return CausalState(
        gen=gen,
        d=discriminator,
        perceptual=perceptual if float(train_cfg.get("perceptual_weight", 0.02)) > 0 else None,
        opt_g=adam(gen.parameters(), train_cfg.get("base_lr", 1e-4)),
        opt_d=adam(discriminator.parameters(), train_cfg.get("disc_lr", 1e-3)),
        gen_dp=data_parallel(gen, mesh),
        d_dp=data_parallel(discriminator, mesh),
        space=mesh.space if mesh is not None else None,
    )


def sample_noise(
    shape: torch.Size, dtype: torch.dtype, device: torch.device, generator: torch.Generator
) -> torch.Tensor:
    """Standard normal noise of ``shape`` from ``generator`` (on ``device``), in ``dtype``."""
    return torch.randn(shape, generator=generator, device=device).to(dtype)


def split_latent(latent: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z_mu, z_sigma): the first and second halves of the latent's channels (last axis)."""
    return latent.chunk(2, dim=-1)


def _encode(gen: nn.ModuleDict, t1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, Optional[int]]:
    """(z_mu, z_sigma, the latent's global depth over the encoder's space group, None without one)."""
    encoder = gen["encoder"]
    depth = None if encoder.space is None else encoder.output_depth(t1.shape[1] * encoder.space.size)
    return (*split_latent(encoder(t1)), depth)


def _noise_like(z: torch.Tensor, generator: torch.Generator, rows: Optional[Tuple[int, slice]] = None,
                space: Optional[spatial.SpaceGroup] = None, depth: Optional[int] = None) -> torch.Tensor:
    """Noise shaped like ``z``; with ``rows`` = (n, s), drawn for n rows and cut to
    rows s; over ``space``, drawn for the global depth ``depth`` and cut to this
    rank's slab of it."""
    n, s = rows if rows is not None else (z.shape[0], slice(None))
    if space is None:
        return sample_noise((n, *z.shape[1:]), z.dtype, z.device, generator)[s]
    eps = sample_noise((n, depth, *z.shape[2:]), z.dtype, z.device, generator)[s]
    return eps[:, slice(*spatial.slab(depth, space.index, space.size))]


def make_train_step(
    train_cfg: Mapping[str, Any], exact_d_fake: Optional[bool] = None, nan_guard: bool = False,
    mesh: Optional[Mesh] = None, batch_size: Optional[int] = None, volume_depth: Optional[int] = None,
) -> Callable[[CausalState, Mapping[str, torch.Tensor], torch.Generator], Dict[str, torch.Tensor]]:
    """One generator step then one D step on a batch {"t1", "pet", "info"} of
    device tensors, the noise drawn from the given generator. Across ranks
    (``mesh``, and ``batch_size`` the batch of one node) the batch is this
    rank's rows and the noise is the global batch's, cut to them; over the
    state's space group, depth slabs of volumes of depth ``volume_depth`` (None:
    always slabs), or whole volumes where the group does not divide it. Updates the
    state in place and returns the JAX package's metrics (0-d tensors):
    g_loss (g_loss + t1_loss), rec_pet_loss, rec_t1_loss, kl_loss, p_loss and
    adv_loss (each times its weight) and d_loss. With ``nan_guard``, a
    non-finite total skips both optimiser steps (the step count stays) and the
    metrics gain ``skipped_nonfinite``. ``d_remat`` (`common.d_remat_from`)
    recomputes D and LPIPS in the generator step's backward. Spans
    (`cips_tpu_torch.profiling`) as the flagship's: ``step`` and its phases
    ``step.{g,d}_{forward,backward,optimizer}`` and ``step.guard``, G the trio."""
    pw = float(train_cfg.get("perceptual_weight", 0.02))
    d_remat = d_remat_from(train_cfg)
    aw = float(train_cfg.get("adv_weight", 0.005))
    kw = float(train_cfg.get("kl_weight", 0.001))
    if exact_d_fake is None:
        exact_d_fake = bool(train_cfg.get("exact_d_fake", False))
    rows = mesh.global_rows(batch_size) if mesh is not None and mesh.distributed and batch_size else None

    def train_step(state: CausalState, batch: Mapping[str, torch.Tensor], generator: torch.Generator):
        with span("step", state.step):
            space = spatial.space_for(state.space, batch["t1"].shape[1], volume_depth)
            with spatial.sharded((state.gen, state.d), space):
                return sharded_step(state, batch, generator, space)

    def sharded_step(state: CausalState, batch: Mapping[str, torch.Tensor], generator: torch.Generator,
                     space: Optional[spatial.SpaceGroup]):
        t1, pet, info = batch["t1"], batch["pet"], batch["info"]
        dev = t1.device
        zero = torch.zeros((), device=dev)
        gen = state.gen

        def noise(z: torch.Tensor, depth: Optional[int]) -> torch.Tensor:
            return _noise_like(z, generator, rows, space, depth)

        with frozen(state.d):
            with span("step.g_forward", device=dev):
                state.opt_g.zero_grad(set_to_none=True)
                z_mu, z_sigma, t1_rec, rec_pet, eps_pet = state.gen_dp(t1, info, noise)
                rec_pet_loss = l1_loss(rec_pet, pet, space)
                rec_t1_loss = l1_loss(t1_rec, t1, space)
                kl = kl_divergence(z_mu, z_sigma, space)
                p = (rematted(lambda f: state.perceptual(f, pet, space=space), rec_pet, d_remat)
                     if pw > 0 and state.perceptual is not None else zero)
                adv = (patch_adversarial_loss(rematted(lambda f: state.d(f)[-1], rec_pet, d_remat),
                                              target_is_real=True, for_discriminator=False, space=space)
                       if aw > 0 else zero)
                total = rec_pet_loss + pw * p + aw * adv + rec_t1_loss + kw * kl
            with span("step.g_backward", device=dev):
                total.backward()
        metrics = {"g_loss": total.detach(), "rec_pet_loss": rec_pet_loss.detach(),
                   "rec_t1_loss": rec_t1_loss.detach(), "kl_loss": kl.detach(), "p_loss": p.detach() * pw,
                   "adv_loss": adv.detach() * aw}
        if nan_guard:
            with span("step.guard"):
                ok = guard_nonfinite(total, mesh)
            metrics["skipped_nonfinite"] = torch.tensor(0.0 if ok else 1.0)
            if not ok:
                metrics["d_loss"] = torch.tensor(float("nan"))
                return metrics
        with span("step.g_optimizer", device=dev):
            state.opt_g.step()

        if aw > 0:
            with span("step.d_forward", device=dev):
                fake = rec_pet
                if exact_d_fake:  # the updated generator's fake, with the PET step's noise (JAX's r_pet)
                    with torch.no_grad():
                        z_mu, z_sigma, depth = _encode(gen, t1)
                        fake = gen["pet_decoder"](z_mu + eps_pet * z_sigma, info, depth=depth)
                fake = fake.detach()
                state.opt_d.zero_grad(set_to_none=True)
                logits_fake, logits_real = state.d_dp(torch.cat([fake, pet], dim=0))[-1].chunk(2, dim=0)
                d_loss = lsgan_discriminator_loss(logits_fake, logits_real, space)
            with span("step.d_backward", device=dev):
                d_loss.backward()
            with span("step.d_optimizer", device=dev):
                state.opt_d.step()
            metrics["d_loss"] = d_loss.detach()
        else:
            metrics["d_loss"] = zero
        state.step += 1
        return metrics

    return train_step


def make_eval_step() -> Callable[[CausalState, Mapping[str, torch.Tensor], torch.Generator], Dict[str, torch.Tensor]]:
    """Eval losses with fresh reconstructions (one eps for both decoders), no
    updates: rec_pet_loss, rec_t1_loss, and the volumes ``fake`` and ``t1_rec``."""

    def eval_step(state: CausalState, batch: Mapping[str, torch.Tensor], generator: torch.Generator):
        gen = state.gen
        with torch.inference_mode():
            z_mu, z_sigma, _ = _encode(gen, batch["t1"])
            z = z_mu + _noise_like(z_sigma, generator) * z_sigma
            t1_rec = gen["t1_decoder"](z)
            fake = gen["pet_decoder"](z, batch["info"])
            return {"rec_pet_loss": l1_loss(fake, batch["pet"]), "rec_t1_loss": l1_loss(t1_rec, batch["t1"]),
                    "fake": fake, "t1_rec": t1_rec}

    return eval_step


def make_generate_fn(
    encoder: DiffusionModelEncoder, pet_decoder: DiffusionModelDecoder
) -> Callable[[Mapping[str, torch.Tensor], torch.Generator], torch.Tensor]:
    """Inference: encode T1, sample the latent, decode PET conditioned on the covariates."""

    def generate(batch: Mapping[str, torch.Tensor], generator: torch.Generator) -> torch.Tensor:
        with torch.inference_mode():
            z_mu, z_sigma = split_latent(encoder(batch["t1"]))
            return pet_decoder(z_mu + _noise_like(z_sigma, generator) * z_sigma, batch["info"])

    return generate
