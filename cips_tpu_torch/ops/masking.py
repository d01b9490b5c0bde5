"""Brain masking: Otsu threshold + morphology (port of cips_tpu/ops/masking.py).

`get_mask` stands in for the reference's ``ants.get_mask``: Otsu threshold,
closing, the connected component grown from the most interior voxel, and a
final dilation. Erosion and dilation are 3-D min/max pools whose padding
never wins (+inf / -inf), as in the JAX package's ``reduce_window``.

The one place the two packages may differ: the Otsu histogram. JAX bins with
``jnp.histogram`` and this port with ``torch.histc``; both put the maximum
into the last bin, but bin edges computed in another order can move a voxel
that lies on an edge into the next bin.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def otsu_threshold(x: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """Otsu's threshold over the intensity range [min, max]."""
    x = x.float()
    lo, hi = x.min(), x.max()
    hist = torch.histc(x, bins=nbins, min=lo.item(), max=hi.item())
    centers = lo + (torch.arange(nbins, dtype=torch.float32, device=x.device) + 0.5) * (hi - lo) / nbins
    w0 = torch.cumsum(hist, 0)
    w1 = w0[-1] - w0
    m = torch.cumsum(hist * centers, 0)
    mu0 = m / w0.clamp_min(1e-12)
    mu1 = (m[-1] - m) / w1.clamp_min(1e-12)
    between = w0 * w1 * (mu0 - mu1) ** 2
    return centers[torch.argmax(between)]


def max_pool3d(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Stride-1 'same' max pool of a (D, H, W) volume as float32 (padding is -inf)."""
    return F.max_pool3d(mask.float()[None, None], size, stride=1, padding=size // 2)[0, 0]


def min_pool3d(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Stride-1 'same' min pool, -max(-x) (padding is +inf)."""
    return -max_pool3d(-mask.float(), size)


def dilate(mask: torch.Tensor, size: int = 3) -> torch.Tensor:
    return max_pool3d(mask, size) > 0.5


def erode(mask: torch.Tensor, size: int = 3) -> torch.Tensor:
    return min_pool3d(mask, size) > 0.5


def closing(mask: torch.Tensor, size: int = 3) -> torch.Tensor:
    return erode(dilate(mask, size), size)


def largest_component_from_seed(mask: torch.Tensor, max_iters: int = 64) -> torch.Tensor:
    """Geodesic dilation (a bounded flood fill) from the mask's most interior voxel.

    The seed is the first voxel (in flat order) where a 5-wide erosion plus
    the mask peaks; each of ``max_iters`` steps grows the region by a 7-wide
    dilation intersected with the mask.
    """
    maskf = mask.float()
    seed_idx = torch.argmax(min_pool3d(maskf, 5) + maskf)
    region = torch.zeros_like(maskf).flatten()
    region[seed_idx] = 1.0
    region = region.reshape(maskf.shape)
    for _ in range(max_iters):
        region = torch.minimum(max_pool3d(region, 7), maskf)
    return region > 0.5


def get_mask(img: torch.Tensor, cleanup: bool = True) -> torch.Tensor:
    """ANTs-style brain mask of a (D, H, W) volume."""
    mask = img > otsu_threshold(img)
    if cleanup:
        mask = closing(mask, 3)
        mask = largest_component_from_seed(mask)
        mask = dilate(mask, 3)
    return mask


def mask_by_t1(pet: torch.Tensor, t1: torch.Tensor) -> torch.Tensor:
    """PET masked by the skull-stripped T1's support: pet * (t1 > 0)."""
    return pet * (t1 > 0).to(pet.dtype)
