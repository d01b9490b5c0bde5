"""Import the reference's (torch) checkpoints into the port's models (port of
cips_tpu/data/torch_import.py).

The reference saves ``torch.save({"unet": ddp.state_dict(), "discriminator":
..., "epoch": ..., ...})`` (train_unet.py:295-302), its keys prefixed with
DDP's ``module.``. The port's models keep the reference's ``state_dict``
names, so an import strips the prefix and loads each network strictly; the
JAX package's reshaping of every tensor has no counterpart here. Where the
names differ, the importer maps them:

  * the reference's AttenUNet and DiffusionModelEncoder carry a timestep
    embedding (``time_embed.*``) whose path is dead (SURVEY.md §2.3); the
    port's models have none, and the importer drops those keys, as the JAX
    importer ignores them;
  * MONAI-generative's PatchDiscriminator (``initial_conv``, ``0`` ...,
    ``final_conv``, each a Convolution with ``conv`` and ``adn.N``) is not
    vendored in the reference; as the JAX importer does, its convs map in
    ``state_dict`` order onto ``conv_0`` ... ``conv_penultimate``,
    ``conv_out`` and its 1-D affine pairs onto ``norm_1`` ...
    ``norm_penultimate``; a conv without a bias gets a zero one, and
    BatchNorm running statistics are dropped;
  * BMGAN's instance norms have no affine in the reference: the port's norm
    parameters the file lacks are set to the identity (scale 1, bias 0), as
    the JAX importer fills them;
  * the causal encoder's spatial head (``out_norm``, ``conv_out``) is not
    read by JAX's `import_diffusion_encoder` either: when the file lacks it,
    the model's own stays.

Every other missing, unexpected or misshapen tensor raises ValueError.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping

import torch
from torch import nn

from cips_tpu_torch.models.discriminator import InstanceNorm, PatchDiscriminator
from cips_tpu_torch.training.common import strip_ddp_prefix

DEAD_PREFIXES = ("time_embed.",)


def load_reference(path: str) -> Dict[str, Any]:
    """A reference ``.ckpt``: the pickled dict of state dicts, epoch and losses (on the CPU)."""
    return torch.load(path, map_location="cpu", weights_only=False)


def _tensors(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v) for k, v in strip_ddp_prefix(state_dict).items() if not k.startswith(DEAD_PREFIXES)}


def _load(model: nn.Module, state: Mapping[str, torch.Tensor], name: str, may_lack: Iterable[str] = ()) -> None:
    """``state`` into ``model`` with every name and shape checked; the model's
    own tensors stay for the names in ``may_lack`` that ``state`` lacks."""
    own = model.state_dict()
    may_lack = set(may_lack)
    missing = sorted(set(own) - set(state) - may_lack)
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise ValueError(f"{name}: the checkpoint does not fit the model: missing {missing[:5]} "
                         f"({len(missing)}), unexpected {unexpected[:5]} ({len(unexpected)})")
    wrong = [(k, tuple(v.shape), tuple(own[k].shape)) for k, v in state.items() if v.shape != own[k].shape]
    if wrong:
        raise ValueError(f"{name}: parameter shapes do not match the model: {wrong[:5]} ({len(wrong)})")
    full = dict(own)
    full.update({k: v.to(own[k].dtype) for k, v in state.items()})
    model.load_state_dict(full, strict=True)


def import_atten_unet(state_dict: Mapping[str, Any], model: nn.Module) -> None:
    """The reference AttenUNet's ``state_dict`` into the port's `AttenUNet`."""
    _load(model, _tensors(state_dict), "unet")


def import_diffusion_encoder(state_dict: Mapping[str, Any], model: nn.Module) -> None:
    """The reference DiffusionModelEncoder's ``state_dict`` into the port's
    (either head; a spatial head the file lacks keeps the model's weights)."""
    head = [k for k in model.state_dict() if k.startswith(("out_norm.", "conv_out."))]
    _load(model, _tensors(state_dict), "encoder", may_lack=head)


def import_vae_decoder(state_dict: Mapping[str, Any], model: nn.Module) -> None:
    """MONAI-generative's AutoencoderKL ``Decoder`` ``state_dict`` (flat ``blocks``) into the port's `Decoder`."""
    _load(model, _tensors(state_dict), "t1_decoder")


def import_diffusion_decoder(state_dict: Mapping[str, Any], model: nn.Module) -> None:
    """The DiffusionModelDecoder's ``state_dict`` into the port's."""
    _load(model, _tensors(state_dict), "pet_decoder")


def _identity_norms(model: nn.Module, state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``state`` with the identity for every InstanceNorm parameter it lacks."""
    state = dict(state)
    for prefix, module in model.named_modules():
        if isinstance(module, InstanceNorm):
            for leaf, fill in (("weight", torch.ones_like), ("bias", torch.zeros_like)):
                key = f"{prefix}.{leaf}"
                state.setdefault(key, fill(getattr(module, leaf).detach(), device="cpu"))
    return state


def import_bmgan_generator(state_dict: Mapping[str, Any], model: nn.Module) -> None:
    """The reference dense_unet_generator's ``state_dict`` into the port's
    `DenseUNetGenerator` (affine-free norms as the identity)."""
    _load(model, _identity_norms(model, _tensors(state_dict)), "generator")


def import_bmgan_encoder(state_dict: Mapping[str, Any], model: nn.Module) -> None:
    """The reference ResNet_encoder's ``state_dict`` into the port's `ResNetEncoder`."""
    _load(model, _identity_norms(model, _tensors(state_dict)), "encoder")


def import_patch_discriminator(state_dict: Mapping[str, Any], model: PatchDiscriminator) -> None:
    """A PatchGAN's ``state_dict`` (MONAI-generative's or the port's names) into
    the port's `PatchDiscriminator`, mapped by order: conv weights (ndim >= 3)
    with their biases, then the 1-D affine pairs."""
    state = _tensors(state_dict)
    convs, norms = [], []
    for key, value in state.items():
        if key.endswith("num_batches_tracked") or "running_" in key or not key.endswith("weight"):
            continue
        bias = state.get(key[: -len("weight")] + "bias")
        (convs if value.ndim >= 3 else norms).append((value, bias))
    conv_names = [f"conv_{i}" for i in range(model.num_layers_d)] + ["conv_penultimate", "conv_out"]
    norm_names = [f"norm_{i}" for i in range(1, model.num_layers_d)] + ["norm_penultimate"]
    if len(convs) != len(conv_names) or len(norms) != len(norm_names):
        raise ValueError(f"discriminator: expected {len(conv_names)} convs and {len(norm_names)} norms for "
                         f"num_layers_d={model.num_layers_d}, found {len(convs)} and {len(norms)}")
    mapped = {}
    for name, (w, b) in zip(conv_names, convs):
        mapped[f"{name}.conv.weight"] = w
        mapped[f"{name}.conv.bias"] = b if b is not None else torch.zeros(w.shape[0], dtype=w.dtype)
    for name, (w, b) in zip(norm_names, norms):
        mapped[f"{name}.weight"], mapped[f"{name}.bias"] = w, b
    _load(model, mapped, "discriminator")


def import_checkpoint(path: str, generator: nn.Module, discriminator: PatchDiscriminator) -> Dict[str, Any]:
    """A reference ``.ckpt`` into the flagship's G (``unet``, required) and D
    (``discriminator``, skipped with its reason when it does not fit). Returns
    ``{"epoch", "eval_loss", "discriminator": None or the reason it was
    skipped}``."""
    ckpt = load_reference(path)
    if "unet" not in ckpt:
        raise ValueError(f"{path}: the checkpoint has no 'unet' state_dict")
    import_atten_unet(ckpt["unet"], generator)
    skipped = "the checkpoint has no 'discriminator'"
    if "discriminator" in ckpt:
        try:
            import_patch_discriminator(ckpt["discriminator"], discriminator)
            skipped = None
        except ValueError as err:
            skipped = str(err)
    eval_loss = ckpt.get("eval_loss")
    try:
        eval_loss = float(eval_loss)
    except (TypeError, ValueError):
        eval_loss = None
    return {"epoch": int(ckpt.get("epoch") or 0), "eval_loss": eval_loss, "discriminator": skipped}
