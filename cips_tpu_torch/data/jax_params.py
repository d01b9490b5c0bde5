"""Carry weights from the JAX package's flax trees to the port.

`from_jax_params` is the inverse of the JAX package's
`cips_tpu/data/torch_import.py:import_atten_unet`: it maps a flax parameter
tree (plain numpy arrays) to the reference's torch ``state_dict`` names that
this package's `AttenUNet` uses. `discriminator_from_jax_params` is the
inverse of `import_patch_discriminator`. The causal generator's three
networks: `encoder_from_jax_params` inverts `import_diffusion_encoder` (the
spatial head, which that importer does not read, keeps its flax names
``out_norm`` and ``conv_out``), `vae_decoder_from_jax_params` inverts
`import_vae_decoder` and `diffusion_decoder_from_jax_params` inverts
`import_diffusion_decoder`; `vae_encoder_from_jax_params` and
`autoencoder_kl_from_jax_params` map the whole KL-VAE's (its Encoder in the
same flat ``blocks`` scheme as the Decoder). `perceptual_from_jax_params` maps the LPIPS
network's tree, whose names the port keeps. BMGAN's:
`bmgan_generator_from_jax_params` and `bmgan_encoder_from_jax_params` invert
`import_bmgan_generator` and `import_bmgan_encoder` (whose instance norms are
affine-free: the port keeps the JAX norms' scale and bias under names of its
own, so only identity norms survive the trip through those importers), and
`bmgan_discriminator_from_jax_params` maps its PatchDiscriminator under
``patch_d``. Nothing here imports JAX.

  flax                                      torch
  ----------------------------------------  ------------------------------------------
  conv_in/{kernel,bias}                     conv_in.conv.{weight,bias}
  down_I/resnet_J/norm1/GroupNorm_0/scale   down_blocks.I.resnets.J.norm1.weight
  down_I/resnet_J/skip/kernel               down_blocks.I.resnets.J.skip_connection.conv.weight
  down_I/attn_J/block_K/attn1/to_out/*      down_blocks.I.attentions.J.transformer_blocks.K.attn1.to_out.0.*
  .../ff/proj_in, ff/proj_out               .../ff.linear1, ff.linear2
  mid/{resnet_1,attention,resnet_2}         middle_block.{resnet_1,attention,resnet_2}
  up_I/...                                  up_blocks.I...
  out_norm/GroupNorm_0/*, conv_out/*        out.0.*, out.2.conv.*

Conv kernels (kd, kh, kw, in, out) -> (out, in, kd, kh, kw); dense kernels
(in, out) -> (out, in); LayerNorm and GroupNorm ``scale`` -> ``weight``.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

_INDEXED = {"down": "down_blocks", "up": "up_blocks", "resnet": "resnets", "attn": "attentions",
            "block": "transformer_blocks"}
_RENAMED = {"mid": "middle_block", "skip": "skip_connection", "to_out": "to_out.0",
            "out_norm": "out.0", "conv_out": "out.2"}
_FF = {"proj_in": "linear1", "proj_out": "linear2"}


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(val)
    return out


def _module_name(path: tuple) -> str:
    names = []
    for i, seg in enumerate(path):
        if seg == "GroupNorm_0":
            continue
        m = re.fullmatch(r"(down|up|resnet|attn|block)_(\d+)", seg)
        if m and not (m.group(1) == "resnet" and i > 0 and path[i - 1] == "mid"):
            names.append(f"{_INDEXED[m.group(1)]}.{m.group(2)}")
        elif i > 0 and path[i - 1] == "ff" and seg in _FF:
            names.append(_FF[seg])
        else:
            names.append(_RENAMED.get(seg, seg))
    return ".".join(names)


def _conv_kernel(arr: np.ndarray) -> np.ndarray:
    """flax conv kernel (*k, in, out) -> torch (out, in, *k)."""
    return arr.transpose((arr.ndim - 1, arr.ndim - 2) + tuple(range(arr.ndim - 2)))


def _is_conv(tree: Mapping[str, Any], module: tuple) -> bool:
    node = tree
    for seg in module:
        node = node[seg]
    return np.ndim(node.get("kernel", 0)) >= 3


def _tensors(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in state.items()}


def convert_tree(
    tree: Mapping[str, Any], transformer_num_layers: int = 1, names: Callable[[tuple], str] = _module_name
) -> Dict[str, torch.Tensor]:
    """Any flax subtree of the AttenUNet family (a whole model or one block)
    -> ``state_dict`` of the matching port module (fp32 tensors). ``names``
    maps a module's flax path to its torch name."""
    state = {}
    for path, arr in _flatten(tree).items():
        module, leaf = path[:-1], path[-1]
        layers = [int(m.group(1)) for m in (re.fullmatch(r"block_(\d+)", s) for s in module) if m]
        if any(i >= transformer_num_layers for i in layers):
            raise ValueError(f"{'/'.join(path)}: more than {transformer_num_layers} transformer layers")
        prefix = names(module)
        prefix = f"{prefix}." if prefix else ""
        if leaf == "scale":  # GroupNorm / LayerNorm
            state[f"{prefix}weight"] = arr
        elif _is_conv(tree, module):
            if leaf == "kernel":
                arr = _conv_kernel(arr)
            state[f"{prefix}conv.{'weight' if leaf == 'kernel' else 'bias'}"] = arr
        elif leaf == "kernel":  # dense (in, out) -> (out, in)
            state[f"{prefix}weight"] = arr.T
        else:
            state[f"{prefix}bias"] = arr
    return _tensors(state)


def from_jax_params(
    flax_params: Mapping[str, Any], num_levels: int, transformer_num_layers: int = 1
) -> Dict[str, torch.Tensor]:
    """flax AttenUNet params (``{"params": ...}`` or its subtree, numpy leaves)
    -> the port's AttenUNet ``state_dict``."""
    tree = flax_params.get("params", flax_params)
    levels = sorted(k for k in tree if re.fullmatch(r"down_\d+", k))
    if levels != sorted(f"down_{i}" for i in range(num_levels)):
        raise ValueError(f"expected {num_levels} levels, found {levels}")
    return convert_tree(tree, transformer_num_layers)


def discriminator_from_jax_params(flax_params: Mapping[str, Any], num_layers_d: int) -> Dict[str, torch.Tensor]:
    """flax PatchDiscriminator params (``{"params": ...}`` or its subtree, numpy
    leaves) -> the port's PatchDiscriminator ``state_dict``: conv kernels
    (kd, kh, kw, in, out) -> ``{name}.conv.weight`` (out, in, kd, kh, kw),
    InstanceNorm ``scale`` -> ``{name}.weight``."""
    tree = flax_params.get("params", flax_params)
    middle = [m for i in range(1, num_layers_d) for m in (f"conv_{i}", f"norm_{i}")]
    modules = ["conv_0", *middle, "conv_penultimate", "norm_penultimate", "conv_out"]  # state_dict order
    if set(tree) != set(modules):
        raise ValueError(f"expected {sorted(modules)} for num_layers_d={num_layers_d}, found {sorted(tree)}")
    state = {}
    for name in modules:
        leaves = tree[name]
        if name.startswith("conv"):
            state[f"{name}.conv.weight"] = _conv_kernel(np.asarray(leaves["kernel"]))
            state[f"{name}.conv.bias"] = leaves["bias"]
        else:
            state[f"{name}.weight"] = leaves["scale"]
            state[f"{name}.bias"] = leaves["bias"]
    return _tensors(state)


def _with_rest(head: str, module: tuple) -> str:
    rest = _module_name(module[1:])
    return f"{head}.{rest}" if rest else head


def encoder_from_jax_params(flax_params: Mapping[str, Any], transformer_num_layers: int = 1) -> Dict[str, torch.Tensor]:
    """flax DiffusionModelEncoder params (either head) -> the port's ``state_dict``.
    The mlp head's fc1 rows go from flax's channels-last flatten (S, C) to the
    reference's (C, S), the permutation `import_diffusion_encoder` undoes."""
    tree = flax_params.get("params", flax_params)
    heads = {"out_norm": "out_norm", "conv_out": "conv_out", "fc1": "out.0", "fc2": "out.3"}

    def names(module: tuple) -> str:
        return heads[module[0]] if module and module[0] in heads else _module_name(module)

    state = convert_tree(tree, transformer_num_layers, names)
    if "fc1" in tree:
        levels = sorted(int(k[5:]) for k in tree if re.fullmatch(r"down_\d+", k))
        c = np.shape(tree[f"down_{levels[-1]}"]["resnet_0"]["conv2"]["kernel"])[-1]
        w = state["out.0.weight"]  # (hidden, S * C), channels-last order
        state["out.0.weight"] = w.reshape(w.shape[0], -1, c).transpose(1, 2).reshape(w.shape[0], -1).contiguous()
    return state


def _vae_rank(key: str) -> tuple:
    """Construction order of the VAE Decoder's flax modules (its ``blocks`` list)."""
    if key == "conv_in":
        return (0,)
    if key in ("mid_res_1", "mid_attn", "mid_res_2"):
        return (1, ("mid_res_1", "mid_attn", "mid_res_2").index(key))
    m = re.fullmatch(r"up_(\d+)_(?:res_(\d+)|us)", key)
    if m:
        return (2, int(m.group(1)), 0 if m.group(2) is not None else 1, int(m.group(2) or 0))
    return (3, ("out_norm", "conv_out").index(key))


def vae_decoder_from_jax_params(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax VAE Decoder params -> the port's ``Decoder`` ``state_dict``: each
    top-level module becomes ``blocks.{k}`` in construction order; a resnet's
    ``skip`` is ``nin_shortcut``."""
    tree = flax_params.get("params", flax_params)
    index = {key: k for k, key in enumerate(sorted(tree, key=_vae_rank))}

    def names(module: tuple) -> str:
        if not module:
            return ""
        return _with_rest(f"blocks.{index[module[0]]}", module).replace("skip_connection", "nin_shortcut")

    return convert_tree(tree, 1, names)


def _vae_encoder_rank(key: str) -> tuple:
    """Construction order of the VAE Encoder's flax modules (its ``blocks`` list)."""
    if key == "conv_in":
        return (0,)
    m = re.fullmatch(r"down_(\d+)_(?:res_(\d+)|ds)", key)
    if m:
        return (1, int(m.group(1)), 0 if m.group(2) is not None else 1, int(m.group(2) or 0))
    if key in ("mid_res_1", "mid_attn", "mid_res_2"):
        return (2, ("mid_res_1", "mid_attn", "mid_res_2").index(key))
    return (3,)  # out_norm


def vae_encoder_from_jax_params(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax VAE Encoder params -> the port's ``Encoder`` ``state_dict``: each
    module up to ``out_norm`` becomes ``blocks.{k}`` in construction order (a
    downsampling conv ``down_{i}_ds`` is ``blocks.{k}.conv``, a resnet's
    ``skip`` is ``nin_shortcut``); ``conv_mu`` and ``conv_log_var`` keep their names."""
    tree = flax_params.get("params", flax_params)
    heads = ("conv_mu", "conv_log_var")
    index = {key: k for k, key in enumerate(sorted((t for t in tree if t not in heads), key=_vae_encoder_rank))}

    def names(module: tuple) -> str:
        if not module or module[0] in heads:
            return _module_name(module)
        head = f"blocks.{index[module[0]]}" + (".conv" if module[0].endswith("_ds") else "")
        return _with_rest(head, module).replace("skip_connection", "nin_shortcut")

    return convert_tree(tree, 1, names)


def autoencoder_kl_from_jax_params(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax AutoencoderKL params -> the port's ``AutoencoderKL`` ``state_dict``
    (``encoder.*`` and ``decoder.*``)."""
    tree = flax_params.get("params", flax_params)
    state = {f"encoder.{k}": v for k, v in vae_encoder_from_jax_params(tree["encoder"]).items()}
    state.update({f"decoder.{k}": v for k, v in vae_decoder_from_jax_params(tree["decoder"]).items()})
    return state


def diffusion_decoder_from_jax_params(
    flax_params: Mapping[str, Any], transformer_num_layers: int = 1
) -> Dict[str, torch.Tensor]:
    """flax DiffusionModelDecoder params -> the port's ``state_dict``:
    ``up_{i}_resnet_{j}``, ``up_{i}_attn_{j}`` and ``up_{i}_upsampler`` become
    ``up_blocks.i.resnets.j``, ``up_blocks.i.attentions.j`` and ``up_blocks.i.upsampler``."""
    tree = flax_params.get("params", flax_params)
    children = {"resnet": "resnets.{}", "attn": "attentions.{}", "upsampler": "upsampler"}

    def names(module: tuple) -> str:
        m = re.fullmatch(r"up_(\d+)_(resnet|attn|upsampler)(?:_(\d+))?", module[0]) if module else None
        if m is None:
            return _module_name(module)
        return _with_rest(f"up_blocks.{m.group(1)}." + children[m.group(2)].format(m.group(3)), module)

    return convert_tree(tree, transformer_num_layers, names)


def perceptual_from_jax_params(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax PerceptualLoss params (``{"params": ...}`` or its subtree, numpy
    leaves) -> the port's ``state_dict``: paths joined by dots, conv kernels
    (kh, kw, in, out) -> ``weight`` (out, in, kh, kw), the lin weights as they are."""
    tree = flax_params.get("params", flax_params)
    state = {}
    for path, arr in _flatten(tree).items():
        *module, leaf = path
        if leaf == "kernel":
            state[".".join(module + ["weight"])] = _conv_kernel(arr)
        else:
            state[".".join(path)] = arr
    return _tensors(state)


def _transposed_kernel(arr: np.ndarray) -> np.ndarray:
    """flax ConvTranspose(k4, s2, 'SAME') kernel (*k, in, out) -> torch
    ConvTranspose(k4, s2, p1) weight (in, out, *k): the same map with the
    spatial axes flipped (the inverse of torch_import's ``transposed`` mapping)."""
    nd = arr.ndim - 2
    w = arr.transpose((nd, nd + 1) + tuple(range(nd)))
    return np.ascontiguousarray(w[(slice(None), slice(None)) + (slice(None, None, -1),) * nd])


def _bmgan_leaves(state: Dict[str, np.ndarray], prefix: str, leaves: Mapping[str, Any], transposed=False) -> None:
    """One flax module's leaves into ``state`` under the torch module ``prefix``:
    a conv (kernel, bias), a norm (scale, bias) or a PReLU slope (as given)."""
    for leaf, arr in leaves.items():
        arr = np.asarray(arr)
        if leaf == "kernel":
            state[f"{prefix}.weight"] = _transposed_kernel(arr) if transposed else _conv_kernel(arr)
        else:
            state[f"{prefix}.{'weight' if leaf == 'scale' else leaf}"] = arr


def _bmgan_dense_block(state: Dict[str, np.ndarray], prefix: str, tree: Mapping[str, Any]) -> None:
    """A flax dense block (unit_j, fuse_j, norm_j) onto the reference slots
    {prefix}.{4j}.layers0 (the unit), {4j+1} (fuse conv) and {4j+2} (norm)."""
    for j in range(2):
        unit = f"{prefix}.{4 * j}.layers0"
        _bmgan_leaves(state, f"{unit}.conv.unit0.conv", tree[f"unit_{j}"]["conv"])
        _bmgan_leaves(state, f"{unit}.conv.unit0.adn.N", tree[f"unit_{j}"]["norm"])
        if "skip" in tree[f"unit_{j}"]:
            _bmgan_leaves(state, f"{unit}.residual", tree[f"unit_{j}"]["skip"])
        _bmgan_leaves(state, f"{prefix}.{4 * j + 1}", tree[f"fuse_{j}"])
        _bmgan_leaves(state, f"{prefix}.{4 * j + 2}", tree[f"norm_{j}"])


def bmgan_generator_from_jax_params(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax DenseUNetGenerator params (packed or not: one tree) -> the port's
    ``state_dict``: stem_0/1/down and their norms -> input_layer.{0,1,3,4,6,7};
    down_dense_I and down_conv_I / down_norm_I -> down_layers.I.{0-7} and .{8,9};
    middle -> middle_layers; up_dense_I, up_tconv_I (flipped), up_norm_I ->
    up_layers.I.{0-7}, .8, .9; head_0/1/out and their norms -> output_layer.{0,1,3,4,6}."""
    tree = flax_params.get("params", flax_params)
    state: Dict[str, np.ndarray] = {}
    for name, slot in (("stem_0", 0), ("stem_norm_0", 1), ("stem_1", 3), ("stem_norm_1", 4), ("stem_down", 6),
                       ("stem_down_norm", 7)):
        _bmgan_leaves(state, f"input_layer.{slot}", tree[name])
    i = 0
    while f"down_dense_{i}" in tree:
        _bmgan_dense_block(state, f"down_layers.{i}", tree[f"down_dense_{i}"])
        _bmgan_leaves(state, f"down_layers.{i}.8", tree[f"down_conv_{i}"])
        _bmgan_leaves(state, f"down_layers.{i}.9", tree[f"down_norm_{i}"])
        i += 1
    _bmgan_dense_block(state, "middle_layers", tree["middle"])
    i = 0
    while f"up_dense_{i}" in tree:
        _bmgan_dense_block(state, f"up_layers.{i}", tree[f"up_dense_{i}"])
        _bmgan_leaves(state, f"up_layers.{i}.8", tree[f"up_tconv_{i}"], transposed=True)
        _bmgan_leaves(state, f"up_layers.{i}.9", tree[f"up_norm_{i}"])
        i += 1
    for name, slot in (("head_0", 0), ("head_norm_0", 1), ("head_1", 3), ("head_norm_1", 4), ("head_out", 6)):
        _bmgan_leaves(state, f"output_layer.{slot}", tree[name])
    return _tensors(state)


def bmgan_encoder_from_jax_params(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ResNetEncoder params (packed or not: one tree) -> the port's
    ``state_dict``: stem / stem_norm -> input_layer.{0,1}; res_I's conv, norm,
    prelu_0, conv_1, norm_1, prelu_1 and skip -> resblocks.I.conv.unit{0,1}.{conv,
    adn.N, adn.A} and resblocks.I.residual; mu and log_var -> linear1 and linear2,
    their rows taken from flax's channels-last flatten (S, C) to the reference's (C, S)."""
    tree = flax_params.get("params", flax_params)
    state: Dict[str, np.ndarray] = {}
    _bmgan_leaves(state, "input_layer.0", tree["stem"])
    _bmgan_leaves(state, "input_layer.1", tree["stem_norm"])
    i = 0
    while f"res_{i}" in tree:
        res, pre = tree[f"res_{i}"], f"resblocks.{i}"
        for sub, (conv, norm, slope) in enumerate((("conv", "norm", "prelu_0"), ("conv_1", "norm_1", "prelu_1"))):
            _bmgan_leaves(state, f"{pre}.conv.unit{sub}.conv", res[conv])
            _bmgan_leaves(state, f"{pre}.conv.unit{sub}.adn.N", res[norm])
            state[f"{pre}.conv.unit{sub}.adn.A.weight"] = np.asarray(res[slope]).reshape(1)
        if "skip" in res:
            _bmgan_leaves(state, f"{pre}.residual", res["skip"])
        last = np.shape(res["conv_1"]["kernel"])[-1]
        i += 1
    for flax_name, torch_name in (("mu", "linear1"), ("log_var", "linear2")):
        w = np.asarray(tree[flax_name]["kernel"]).T  # (latent, S * C), channels-last order
        state[f"{torch_name}.weight"] = w.reshape(w.shape[0], -1, last).transpose(0, 2, 1).reshape(w.shape[0], -1)
        state[f"{torch_name}.bias"] = tree[flax_name]["bias"]
    return _tensors(state)


def bmgan_discriminator_from_jax_params(
    flax_params: Mapping[str, Any], num_layers_d: int = 4
) -> Dict[str, torch.Tensor]:
    """flax BMGANDiscriminator params -> the port's ``state_dict``: its
    PatchDiscriminator subtree ``patch_d`` under ``patch_d.``."""
    tree = flax_params.get("params", flax_params)
    return {f"patch_d.{k}": v for k, v in discriminator_from_jax_params(tree["patch_d"], num_layers_d).items()}


def unet3d_from_jax_params(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax UnetGenerator3d params -> the port's ``state_dict``, whose names are
    the flax paths joined by dots: conv kernels -> ``weight``, norm ``scale`` -> ``weight``."""
    tree = flax_params.get("params", flax_params)
    state = {}
    for path, arr in _flatten(tree).items():
        *module, leaf = path
        state[".".join(module + ["weight" if leaf in ("kernel", "scale") else leaf])] = (
            _conv_kernel(arr) if leaf == "kernel" else arr)
    return _tensors(state)
