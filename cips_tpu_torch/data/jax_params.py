"""Carry AttenUNet weights from the JAX package's flax tree to the port.

`from_jax_params` is the inverse of the JAX package's
`cips_tpu/data/torch_import.py:import_atten_unet`: it maps a flax parameter
tree (plain numpy arrays) to the reference's torch ``state_dict`` names that
this package's `AttenUNet` uses. It imports nothing of JAX.

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
from typing import Any, Dict, Mapping

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


def _is_conv(tree: Mapping[str, Any], module: tuple) -> bool:
    node = tree
    for seg in module:
        node = node[seg]
    return np.ndim(node.get("kernel", 0)) >= 3


def convert_tree(tree: Mapping[str, Any], transformer_num_layers: int = 1) -> Dict[str, torch.Tensor]:
    """Any flax subtree of the AttenUNet family (a whole model or one block)
    -> ``state_dict`` of the matching port module (fp32 tensors)."""
    state = {}
    for path, arr in _flatten(tree).items():
        module, leaf = path[:-1], path[-1]
        layers = [int(m.group(1)) for m in (re.fullmatch(r"block_(\d+)", s) for s in module) if m]
        if any(i >= transformer_num_layers for i in layers):
            raise ValueError(f"{'/'.join(path)}: more than {transformer_num_layers} transformer layers")
        prefix = _module_name(module)
        prefix = f"{prefix}." if prefix else ""
        if leaf == "scale":  # GroupNorm / LayerNorm
            state[f"{prefix}weight"] = arr
        elif _is_conv(tree, module):
            if leaf == "kernel":  # (*k, in, out) -> (out, in, *k)
                arr = arr.transpose((arr.ndim - 1, arr.ndim - 2) + tuple(range(arr.ndim - 2)))
            state[f"{prefix}conv.{'weight' if leaf == 'kernel' else 'bias'}"] = arr
        elif leaf == "kernel":  # dense (in, out) -> (out, in)
            state[f"{prefix}weight"] = arr.T
        else:
            state[f"{prefix}bias"] = arr
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in state.items()}


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
