"""Perceptual (LPIPS) loss for 3-D volumes, 2.5-D slice-wise (port of
cips_tpu/models/perceptual.py).

MONAI-generative's ``PerceptualLoss`` with richzhang LPIPS's pieces:
  * backbone features at torchvision SqueezeNet-1.1's 7 tap points
    (``network_type="squeeze"``, the causal and flagship configs) or AlexNet's
    5 (``"alex"``, BMGAN's default);
  * the LPIPS scaling layer, (x - shift) / scale, which broadcasts a
    1-channel input to the 3 RGB channels;
  * per tap: unit-normalise over channels, squared difference, the 1x1 "lin"
    calibration to a scalar map, spatial mean; the taps summed;
  * a 3-D volume is evaluated 2.5-D: along each axis every k-th slice
    (k = round(1 / fake_3d_ratio)) is folded into the batch, the LPIPS mean
    over those slices is the axis loss, and the three axis losses are summed;
    or, given a ``generator`` (JAX's ``rng``: MONAI's per-call random subset),
    a random subset of int(m * fake_3d_ratio) of the m slices of the folded
    batch x slice axis, drawn per axis by `slice_subsets` (``subsets`` takes
    the indices themselves).

Depth-sharded volumes (the mesh's ``space`` axis): the 2.5-D slices cross
the depth axis, so `PerceptualLoss` gathers both volumes whole on every rank
first (`spatial.gather`) and each rank computes the whole term. The gather's
backward sums the ranks' gradients into each slab's owner, so the term reaches
the generator n_space times, as every loss all-reduced over the group does
(`parallel.spatial`).

A tap that the backbone has shrunk to nothing (an input smaller than its
receptive field, as in tiny test crops) is skipped, as in the JAX package.

Weights: `params_from_npz` reads the very ``.npz`` that the JAX package's
`params_from_npz` reads (``scripts/convert_lpips_weights.py`` makes it from a
torchvision backbone and the LPIPS lin weights). Without one, `init_params`
draws the backbone from a seeded ``torch.Generator`` (LeCun-normal kernels,
zero biases) and sets every lin weight to 1/C, as the JAX package's fallback
does; its draws differ from JAX's, as every init of this port does. The
network is frozen: its parameters take no gradient. Parameter names are the
flax tree's, joined by dots (``lpips.net.fire3.squeeze.weight``, ``lpips.lin0``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cips_tpu_torch.parallel.spatial import SpaceGroup, gather

_SHIFT = (-0.030, -0.088, -0.188)  # LPIPS ScalingLayer
_SCALE = (0.458, 0.448, 0.450)

SQUEEZE_TAP_CHANNELS = (64, 128, 256, 384, 384, 512, 512)
ALEX_TAP_CHANNELS = (64, 192, 384, 256, 256)


class Conv2d(nn.Conv2d):
    """2-D conv with fp32 parameters applied in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride, self.padding)


def _max_pool(x: torch.Tensor, ceil: bool = False) -> Optional[torch.Tensor]:
    """torch MaxPool2d(3, stride 2, ceil_mode=ceil); None when an axis of the output
    would be empty (under 3 wide, or under 2 with ``ceil``), where the JAX
    package's pool returns an empty array."""
    if min(x.shape[-2:]) < (2 if ceil else 3):
        return None
    return F.max_pool2d(x, 3, 2, ceil_mode=ceil)


class Fire(nn.Module):
    """torchvision SqueezeNet Fire: squeeze 1x1, then expand 1x1 and 3x3 concatenated."""

    def __init__(self, in_channels: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = Conv2d(in_channels, squeeze, 1)
        self.expand1x1 = Conv2d(squeeze, expand, 1)
        self.expand3x3 = Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)), F.relu(self.expand3x3(s))], dim=1)


class SqueezeFeatures(nn.Module):
    """SqueezeNet-1.1 ``features`` (conv0, fire3 ... fire12) with its 7 LPIPS taps."""

    def __init__(self):
        super().__init__()
        self.conv0 = Conv2d(3, 64, 3, stride=2)
        fires = {"fire3": (64, 16, 64), "fire4": (128, 16, 64), "fire6": (128, 32, 128),
                 "fire7": (256, 32, 128), "fire9": (256, 48, 192), "fire10": (384, 48, 192),
                 "fire11": (384, 64, 256), "fire12": (512, 64, 256)}
        for name, args in fires.items():
            self.add_module(name, Fire(*args))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = [F.relu(self.conv0(x))]
        stages = (("pool", "fire3", "fire4"), ("pool", "fire6", "fire7"), ("pool", "fire9"), ("fire10",),
                  ("fire11",), ("fire12",))
        h = taps[0]
        for stage in stages:
            for layer in stage:
                h = _max_pool(h, ceil=True) if layer == "pool" else getattr(self, layer)(h)
                if h is None:
                    return taps
            taps.append(h)
        return taps


class AlexFeatures(nn.Module):
    """AlexNet ``features`` (conv0, conv3, conv6, conv8, conv10) with its 5 LPIPS taps."""

    def __init__(self):
        super().__init__()
        self.conv0 = Conv2d(3, 64, 11, stride=4, padding=2)
        self.conv3 = Conv2d(64, 192, 5, padding=2)
        self.conv6 = Conv2d(192, 384, 3, padding=1)
        self.conv8 = Conv2d(384, 256, 3, padding=1)
        self.conv10 = Conv2d(256, 256, 3, padding=1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = [F.relu(self.conv0(x))]
        for stage in (("pool", "conv3"), ("pool", "conv6"), ("conv8",), ("conv10",)):
            h = taps[-1]
            for layer in stage:
                h = _max_pool(h) if layer == "pool" else F.relu(getattr(self, layer)(h))
                if h is None:
                    return taps
            taps.append(h)
        return taps


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """lpips.normalize_tensor over the channel axis, in fp32."""
    f = f.float()
    return f / (f.square().sum(dim=1, keepdim=True).sqrt() + eps)


class LPIPS(nn.Module):
    """2-D LPIPS distance with its lin calibration; (B, C, H, W) pairs, C 1 or 3 -> (B,)."""

    def __init__(self, network_type: str = "squeeze", dtype: torch.dtype = torch.float32):
        super().__init__()
        if network_type == "squeeze":
            self.net, channels = SqueezeFeatures(), SQUEEZE_TAP_CHANNELS
        elif network_type == "alex":
            self.net, channels = AlexFeatures(), ALEX_TAP_CHANNELS
        else:
            raise ValueError(f"unsupported network_type {network_type!r}")
        self.dtype = dtype
        self.num_taps = len(channels)
        for i, c in enumerate(channels):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.full((c, 1), 1.0 / c)))

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        shift, scale = (torch.tensor(v, device=a.device).view(1, 3, 1, 1) for v in (_SHIFT, _SCALE))
        fa = self.net(((a.float() - shift) / scale).to(self.dtype))
        fb = self.net(((b.float() - shift) / scale).to(self.dtype))
        total = torch.zeros(a.shape[0], device=a.device)
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            d = (_unit_normalize(xa) - _unit_normalize(xb)).square()
            total = total + torch.einsum("bchw,c->bhw", d, getattr(self, f"lin{i}")[:, 0]).mean(dim=(1, 2))
        return total


def slice_subsets(shape: Sequence[int], ratio: float, generator: torch.Generator) -> List[torch.Tensor]:
    """For a volume batch of spatial ``shape`` (N, D, H, W), one index tensor per
    axis (D, H, W) over the folded batch x slice axis of that axis's m = N * size
    slices: the first max(1, int(m * ratio)) of a ``torch.randperm(m)`` drawn
    from ``generator`` (on its device), axis after axis."""
    n, *sizes = shape
    subsets = []
    for size in sizes:
        m = n * size
        subsets.append(torch.randperm(m, generator=generator, device=generator.device)[:max(1, int(m * ratio))])
    return subsets


class PerceptualLoss(nn.Module):
    """MONAI-generative PerceptualLoss: 2.5-D LPIPS for (N, D, H, W, C) channels-last
    volumes (``spatial_dims`` 3), or LPIPS on (N, H, W, C) images (2)."""

    def __init__(
        self, spatial_dims: int = 3, network_type: str = "squeeze", is_fake_3d: bool = True,
        fake_3d_ratio: float = 0.5, dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if spatial_dims == 3 and not is_fake_3d:
            raise NotImplementedError("true-3D perceptual networks are not part of the reference workloads")
        self.spatial_dims = spatial_dims
        self.fake_3d_ratio = fake_3d_ratio
        self.stride = max(1, round(1.0 / fake_3d_ratio))
        self.lpips = LPIPS(network_type, dtype)
        self.requires_grad_(False)

    def forward(self, pred: torch.Tensor, target: torch.Tensor, space: Optional[SpaceGroup] = None,
                generator: Optional[torch.Generator] = None,
                subsets: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """The loss of a pair of volumes, or of depth slabs of them over ``space``.
        With ``generator`` (or the drawn ``subsets``, `slice_subsets`), each axis
        takes a random subset of its slices in place of every k-th."""
        if space is not None:
            pred, target = gather(pred, space, 1, "volume"), gather(target, space, 1, "volume")
        if self.spatial_dims == 2:
            return self.lpips(pred.movedim(-1, 1), target.movedim(-1, 1)).mean()
        if subsets is None and generator is not None:
            subsets = slice_subsets(pred.shape[:4], self.fake_3d_ratio, generator)
        s = 1 if subsets is not None else self.stride
        total = torch.zeros((), device=pred.device)
        for k, axis in enumerate((2, 3, 4)):  # D, H, W of (N, C, D, H, W): slices folded into the batch
            order = (0, axis, 1) + tuple(a for a in (2, 3, 4) if a != axis)
            views = []
            for x in (pred, target):
                x = x.movedim(-1, 1)
                x = x[(slice(None),) * axis + (slice(None, None, s),)].permute(order)
                x = x.reshape(-1, *x.shape[2:])
                views.append(x if subsets is None else x.index_select(0, subsets[k].to(x.device)))
            total = total + self.lpips(*views).mean()
        return total


def init_params(model: PerceptualLoss, generator: torch.Generator) -> None:
    """The JAX package's fallback without an .npz, drawn from ``generator``:
    LeCun-normal conv kernels, zero biases, lin weights 1/C."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Conv2d):
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator) * mod.weight[0].numel() ** -0.5)
                mod.bias.zero_()
        for i in range(model.lpips.num_taps):
            lin = getattr(model.lpips, f"lin{i}")
            lin.fill_(1.0 / lin.shape[0])


def params_from_npz(path: str) -> dict:
    """The port's state_dict from the JAX package's LPIPS weight .npz (flat
    "/"-joined flax paths such as ``lpips/net/fire3/squeeze/kernel``)."""
    from cips_tpu_torch.data.jax_params import perceptual_from_jax_params

    tree: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = flat[key]
    return perceptual_from_jax_params(tree)

