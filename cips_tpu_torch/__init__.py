"""cips_tpu_torch — the PyTorch/CUDA port of cips_tpu for one NVIDIA H100.

The JAX package `cips_tpu` stays the reference; this package computes the
same functions with PyTorch, and each Pallas TPU kernel on its path is a
CUDA kernel written by hand for Hopper (`csrc/`). It imports nothing of JAX
or of `cips_tpu`.

Entry points run on the card. The CPU is used only when a caller asks for
it by name (the tests do); a missing card is an error, never a silent
fallback.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def default_device(requested: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``requested`` is "cpu".

    Raises RuntimeError when CUDA is wanted (the default) but unavailable.
    """
    device = torch.device("cuda" if requested is None else requested)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device
