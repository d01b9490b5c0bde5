"""The plain fp32 training steps of the two GAN families, one sample at a time.

A step is the program's: the generator's losses with the discriminator
frozen, one Adam step of the generator, then the discriminator's LSGAN loss on
the detached pre-update fake and the real PET, one Adam step of D. Every norm
in both families is per sample (group and instance norms), and every loss is
a mean of per-sample terms over equal-sized samples (the KL a mean of
per-sample sums), so the batch's gradient is the sum of each sample's
gradient of its term over the batch size: the reference takes the samples one
after another and sums.

`Reference.train` returns the record the check compares (`portbench.check`):
every step's loss terms, each leaf's first gradient (whole, and its norm) and
the norm of its change after the steps, and the first step's generator outputs.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import torch
from torch import nn

from portbench.reference import lpips as ref_lpips
from portbench.reference import models as ref


def _weights(train: Mapping) -> Dict[str, float]:
    return {k: float(train.get(k, 0.0)) for k in ("perceptual_weight", "adv_weight", "kl_weight")}


def _number(v: torch.Tensor) -> float:
    """A 0-d tensor's value; 0 on the meta device, where work is only counted."""
    return 0.0 if v.device.type == "meta" else float(v.detach())


def l1(a, b):
    return (a - b).abs().mean()


def lsgan(logits, target: float):
    return (logits - target).square().mean()


class Reference:
    """The networks of one family under ``nets`` ("g", "d", and "p" for the
    perceptual network where its weight is above 0), in fp32 (or the control's
    ``precision``), and their Adams."""

    family = ""

    def __init__(self, cfg: Mapping, precision: ref.Precision = ref.PLAIN):
        self.cfg, self.p = cfg, precision
        self.w = _weights(cfg["training"])
        nets = {"g": self.generator(cfg, precision), "d": ref.PatchDiscriminator(p=precision, **cfg["discriminator"])}
        if self.w["perceptual_weight"] > 0:
            nets["p"] = ref_lpips.PerceptualLoss(precision)
        self.nets = nn.ModuleDict(nets)

    def generator(self, cfg: Mapping, p: ref.Precision) -> nn.Module:
        raise NotImplementedError

    def g_losses(self, x: Mapping[str, torch.Tensor], noise) -> tuple:
        """(loss terms as the program names them, the total to differentiate,
        the fake D is trained on, the outputs compared) of one sample."""
        raise NotImplementedError

    def d_weight(self) -> float:
        """The factor the program reports the D loss with."""
        return 1.0

    def load(self, weights: Mapping[str, torch.Tensor], device) -> "Reference":
        self.nets.to_empty(device=device)
        self.nets.load_state_dict(dict(weights))
        train = self.cfg["training"]
        self.opt_g = torch.optim.Adam(self.nets["g"].parameters(), lr=train["base_lr"], betas=(0.9, 0.999), eps=1e-8)
        self.opt_d = torch.optim.Adam(self.nets["d"].parameters(), lr=train["disc_lr"], betas=(0.9, 0.999), eps=1e-8)
        return self

    def step(self, samples: Sequence[Mapping[str, torch.Tensor]], noise=None, keep: Optional[dict] = None,
             grads: Optional[dict] = None) -> Dict[str, float]:
        """One training step over ``samples``; the first step's generator outputs
        go to ``keep`` and the gradients Adam gets to ``grads`` (by leaf)."""
        b = len(samples)
        nets, aw = self.nets, self.w["adv_weight"]
        terms: Dict[str, float] = {}
        self.opt_g.zero_grad(set_to_none=True)
        nets["d"].requires_grad_(False)
        fakes = []
        for i, x in enumerate(samples):
            parts, total, fake, outs = self.g_losses(x, None if noise is None else [e[i:i + 1] for e in noise])
            (total / b).backward()
            for k, v in parts.items():
                terms[k] = terms.get(k, 0.0) + _number(v) / b
            fakes.append(fake.detach())
            if keep is not None:
                for k, v in outs.items():
                    keep.setdefault(k, []).append(v.detach().float().cpu())
        nets["d"].requires_grad_(True)
        if grads is not None:
            grads.update(leaf_grads(nets["g"], "g"))
        self.opt_g.step()
        if aw > 0:
            self.opt_d.zero_grad(set_to_none=True)
            d_loss = 0.0
            for fake, x in zip(fakes, samples):
                loss = 0.5 * (lsgan(nets["d"](fake), 0.0) + lsgan(nets["d"](x["pet"]), 1.0))
                (loss / b).backward()
                d_loss += _number(loss) / b
            if grads is not None:
                grads.update(leaf_grads(nets["d"], "d"))
            self.opt_d.step()
            terms["d_loss"] = d_loss * self.d_weight()
        return terms

    def train(self, batches: Sequence[Sequence[Mapping[str, torch.Tensor]]], noises=None) -> dict:
        """The record of ``len(batches)`` steps from the loaded weights."""
        start = {k: v.detach().clone() for k, v in self.trained().items()}
        keep: dict = {}
        grads: dict = {}
        losses = []
        for s, batch in enumerate(batches):
            losses.append(self.step(batch, None if noises is None else noises[s], keep if s == 0 else None,
                                    grads if s == 0 else None))
        changes = norms({k: v.detach() - start[k] for k, v in self.trained().items()})
        return {"losses": losses, "grads": norms(grads), "changes": changes, "grad_tensors": grads,
                "outputs": {k: torch.cat(v) for k, v in keep.items()}}

    def trained(self) -> Dict[str, torch.Tensor]:
        return {f"{net}.{k}": v for net in ("g", "d") for k, v in self.nets[net].named_parameters()}


class Flagship(Reference):
    family = "flagship"

    def generator(self, cfg, p):
        return ref.AttenUNet(cross_attention_dim=cfg["covariates"], p=p, **cfg["atten_unet_def"])

    def g_losses(self, x, noise):
        pw, aw = self.w["perceptual_weight"], self.w["adv_weight"]
        fake = self.nets["g"](x["t1"], x["info"])
        rec = l1(fake, x["pet"])
        perc = self.nets["p"](fake, x["pet"]) if pw > 0 else fake.new_zeros(())
        adv = lsgan(self.nets["d"](fake), 1.0) if aw > 0 else fake.new_zeros(())
        total = rec + pw * perc + aw * adv
        parts = {"g_loss": total, "rec_loss": rec, "p_loss": perc, "adv_loss": adv * aw}
        return parts, total, fake, {"fake": fake}

    def d_weight(self):
        return self.w["adv_weight"]


class Causal(Reference):
    family = "causal"

    def generator(self, cfg, p):
        enc = dict(cfg["t1_autoencoder_def"]["atten_encoder"])
        return nn.ModuleDict({
            "encoder": ref.SpatialEncoder(p=p, **enc),
            "t1_decoder": ref.VAEDecoder(p=p, **cfg["t1_autoencoder_def"]["decoder"]),
            "pet_decoder": ref.PETDecoder(cross_attention_dim=cfg["covariates"], p=p, **cfg["pet_decoder_def"]),
        })

    def g_losses(self, x, noise):
        pw, aw, kw = self.w["perceptual_weight"], self.w["adv_weight"], self.w["kl_weight"]
        g = self.nets["g"]
        z_mu, z_sigma = g["encoder"](x["t1"]).chunk(2, dim=-1)
        eps_t1, eps_pet = noise
        t1_rec = g["t1_decoder"](z_mu + eps_t1 * z_sigma)
        fake = g["pet_decoder"](z_mu + eps_pet * z_sigma, x["info"])
        rec_pet, rec_t1 = l1(fake, x["pet"]), l1(t1_rec, x["t1"])
        kl = (-0.5 * (1.0 + z_sigma - z_mu.square() - z_sigma.exp())).sum()
        perc = self.nets["p"](fake, x["pet"]) if pw > 0 else fake.new_zeros(())
        adv = lsgan(self.nets["d"](fake), 1.0) if aw > 0 else fake.new_zeros(())
        total = rec_pet + pw * perc + aw * adv + rec_t1 + kw * kl
        parts = {"g_loss": total, "rec_pet_loss": rec_pet, "rec_t1_loss": rec_t1, "kl_loss": kl,
                 "p_loss": perc * pw, "adv_loss": adv * aw}
        return parts, total, fake, {"fake": fake, "t1_rec": t1_rec}


FAMILIES = {"flagship": Flagship, "causal": Causal}


def norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    values = torch.stack([tensors[k].float().norm() for k in names]).tolist()
    return dict(zip(names, values))


def leaf_grads(module: nn.Module, prefix: str) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient (zeros where it got none), a copy."""
    return {f"{prefix}.{k}": torch.zeros_like(v) if v.grad is None else v.grad.detach().clone()
            for k, v in module.named_parameters()}


def latent_shape(cfg: Mapping, volume: Sequence[int]) -> List[int]:
    """The causal latent's channels-last shape a sample: the volume over
    2 ** (levels - 1), half the encoder's output channels."""
    enc = cfg["t1_autoencoder_def"]["atten_encoder"]
    f = 2 ** (len(enc["num_channels"]) - 1)
    return [s // f for s in volume] + [enc["out_channels"] // 2]

