"""The causal unified generator (T1 encoder, T1 and PET decoders, D, LPIPS)
through the port's own train step (`cips_tpu_torch.training.causal_task`), on
the benchmark's weights, its noise drawn from a generator the benchmark seeds."""

from __future__ import annotations

from typing import Mapping

import torch

from portbench.data import prefixed
from portbench.program import Program, materialise
from portbench.reference.train import Causal as REFERENCE  # noqa: F401  (the harness reads it)
from portbench.reference.train import latent_shape

NOISE_SEED_OFFSET = 1  # the noise generator's seed is the run's seed plus this, as train_causal seeds it


def build(cfg: Mapping, weights: Mapping[str, torch.Tensor], mesh, seed: int, dtype: torch.dtype) -> Program:
    from cips_tpu_torch.models import perceptual as lpips
    from cips_tpu_torch.models.autoencoder_kl import Decoder
    from cips_tpu_torch.models.decoder import DiffusionModelDecoder
    from cips_tpu_torch.models.discriminator import PatchDiscriminator
    from cips_tpu_torch.models.encoder import DiffusionModelEncoder
    from cips_tpu_torch.training import causal_task

    enc_def = dict(cfg["t1_autoencoder_def"]["atten_encoder"])
    enc_def.pop("cross_attention_dim", None)
    if not enc_def.get("resblock_updown") or cfg["pet_decoder_def"].get("resblock_updown"):
        raise ValueError("the reference's encoder resamples with resnets and its PET decoder with convs")
    pet_def = dict(cfg["pet_decoder_def"], cross_attention_dim=cfg["covariates"])
    train = cfg["training"]
    with torch.device("meta"):
        nets = {"encoder": DiffusionModelEncoder(head="spatial", dtype=dtype, **enc_def),
                "t1_decoder": Decoder(dtype=dtype, **cfg["t1_autoencoder_def"]["decoder"]),
                "pet_decoder": DiffusionModelDecoder(dtype=dtype, **pet_def)}
        d = PatchDiscriminator(dtype=dtype, **cfg["discriminator"])
        p = lpips.PerceptualLoss(dtype=dtype, **cfg.get("perceptual_network", {}))
    for name, net in nets.items():
        materialise(net, prefixed(weights, f"g.{name}"), mesh.device)
    materialise(d, prefixed(weights, "d"), mesh.device)
    if float(train.get("perceptual_weight", 0)) > 0:
        materialise(p, prefixed(weights, "p"), mesh.device)
    state = causal_task.init_state(nets["encoder"], nets["t1_decoder"], nets["pet_decoder"], d, p, train, mesh=mesh)
    step_fn = causal_task.make_train_step(train, mesh=mesh, batch_size=cfg["batch"], volume_depth=cfg["volume"][0])
    rng = torch.Generator(mesh.device).manual_seed(seed + NOISE_SEED_OFFSET)
    return Program(state=state, step=lambda batch: step_fn(state, batch, rng), nets={"g": state.gen, "d": d},
                   opts={"g": state.opt_g, "d": state.opt_d},
                   outputs={"fake": nets["pet_decoder"], "t1_rec": nets["t1_decoder"]})


def reference_noise(cfg: Mapping, batch: int, steps: int, seed: int, device) -> list:
    """Each step's noise as the program's step draws it for the node batch: eps
    for the T1 decoder, then for the PET decoder, from a generator seeded as
    `build` seeds the program's; zeros on the meta device, where work is only
    counted."""
    shape = (batch, *latent_shape(cfg, cfg["volume"]))
    if torch.device(device).type == "meta":
        return [[torch.zeros(shape, device=device) for _ in range(2)] for _ in range(steps)]
    g = torch.Generator(device).manual_seed(seed + NOISE_SEED_OFFSET)
    return [[torch.randn(shape, generator=g, device=device) for _ in range(2)] for _ in range(steps)]
