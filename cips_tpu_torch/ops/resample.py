"""Resampling: resizes, samplers, affine warps, spacing changes (port of
cips_tpu/ops/resample.py).

The offline chain's resamplers (`ants.resample_image` to a mm spacing, MONAI
`Resize`, the 1.5x upsample that pushes PET into segmentation space) and the
differentiable warp that drives the rigid registration (`ops/registration.py`).
Volumes are (D, H, W) or (..., D, H, W); coordinates are voxel indices.

The linear resize is the JAX package's `jax.image.resize(..., "linear")`,
written out: one pass per resized axis, a dense (in, out) weight matrix built
as `jax/_src/image/scale.py:compute_weight_mat` builds it. When it shrinks an
axis, that triangle kernel is widened by the factor (antialiasing), which
`F.interpolate(mode="trilinear")` does not do. The nearest resize takes the
source index ``floor((i + 0.5) * in / out)`` as JAX does. Both compute in fp32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

_F32_EPS = float(np.finfo(np.float32).eps)


def linear_weight_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_in, n_out) weights of a linear resize of one axis from n_in to n_out.

    JAX's `compute_weight_mat` with the triangle kernel, translation 0 and
    antialias on: the kernel is widened by ``in / out`` when shrinking, each
    output's column is normalised to sum to 1 (zeroed when the sum is under
    1000 eps), and an output whose sample point lies outside the input is 0.
    """
    scale = torch.tensor(n_out / n_in, dtype=torch.float32, device=device)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs() / kernel_scale
    weights = torch.clamp_min(1.0 - x.abs(), 0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * _F32_EPS,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _resized_axes(x: torch.Tensor, shape: Sequence[int]):
    lead = x.ndim - len(shape)
    return [(lead + i, n) for i, n in enumerate(shape) if x.shape[lead + i] != n]


def resize_trilinear(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Linear resize of the trailing len(shape) axes, as `jax.image.resize`
    computes it (antialiased when shrinking). Axes already at size are left."""
    x = x.float()
    for axis, n in _resized_axes(x, shape):
        w = linear_weight_matrix(x.shape[axis], n, x.device)
        x = torch.matmul(x.movedim(axis, -1), w).movedim(-1, axis)
    return x


def resize_nearest(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Nearest resize of the trailing len(shape) axes: output i reads input
    ``floor((i + 0.5) * in / out)`` (PyTorch's "nearest-exact")."""
    for axis, n in _resized_axes(x, shape):
        m = x.shape[axis]
        src = torch.floor((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) * m / n).long()
        x = x.index_select(axis, src)
    return x


def resample_spacing(
    x: torch.Tensor, spacing: Sequence[float], new_spacing: Sequence[float], nearest: bool = False
) -> torch.Tensor:
    """Resample a (D, H, W) volume from ``spacing`` mm to ``new_spacing`` mm."""
    shape = tuple(max(1, int(round(s * sp / nsp))) for s, sp, nsp in zip(x.shape, spacing, new_spacing))
    return resize_nearest(x, shape) if nearest else resize_trilinear(x, shape)


def _flat_index(zi, yi, xi, d: int, h: int, w: int):
    """Flat indices of the clipped coordinates and whether each is in bounds."""
    zc, yc, xc = zi.clamp(0, d - 1), yi.clamp(0, h - 1), xi.clamp(0, w - 1)
    inb = (zi >= 0) & (zi <= d - 1) & (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
    return (zc * h + yc) * w + xc, inb


def trilinear_sample(vol: torch.Tensor, coords: torch.Tensor, cval: float = 0.0) -> torch.Tensor:
    """Sample a (D, H, W) volume at fractional voxel coords (3, ...) trilinearly.

    Eight clipped gathers, each masked to ``cval`` out of bounds and weighted
    by its corner's (1 - f) or f, so autograd gives the JAX package's gradient
    with respect to the coordinates, at the borders too.
    """
    d, h, w = vol.shape
    flat = vol.reshape(-1)
    cz, cy, cx = coords[0], coords[1], coords[2]
    z0, y0, x0 = torch.floor(cz), torch.floor(cy), torch.floor(cx)
    fz, fy, fx = cz - z0, cy - y0, cx - x0
    z0, y0, x0 = z0.long(), y0.long(), x0.long()
    fill = torch.tensor(cval, dtype=vol.dtype, device=vol.device)
    acc = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                wz = fz if dz else (1.0 - fz)
                wy = fy if dy else (1.0 - fy)
                wx = fx if dx else (1.0 - fx)
                idx, inb = _flat_index(z0 + dz, y0 + dy, x0 + dx, d, h, w)
                acc = acc + wz * wy * wx * torch.where(inb, flat[idx], fill)
    return acc


def nearest_sample(vol: torch.Tensor, coords: torch.Tensor, cval: float = 0.0) -> torch.Tensor:
    """Nearest-neighbour sampling (label and mask volumes; ants' 'nearestNeighbor'),
    rounding half to even as `jnp.round` does."""
    d, h, w = vol.shape
    idx = torch.round(coords).long()
    flat_idx, inb = _flat_index(idx[0], idx[1], idx[2], d, h, w)
    return torch.where(inb, vol.reshape(-1)[flat_idx], torch.tensor(cval, dtype=vol.dtype, device=vol.device))


def identity_grid(shape: Sequence[int], device=None) -> torch.Tensor:
    """(3, D, H, W) fp32 voxel-coordinate grid."""
    axes = [torch.arange(s, dtype=torch.float32, device=device) for s in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"))


def affine_warp(
    vol: torch.Tensor,
    matrix: torch.Tensor,
    out_shape: Optional[Sequence[int]] = None,
    nearest: bool = False,
    cval: float = 0.0,
) -> torch.Tensor:
    """Warp ``vol`` by a 3x4 (or 4x4) voxel-space affine: out(p) = vol(A p + t).

    The matrix maps *output* voxel coordinates to input coordinates (pull-back).
    """
    out_shape = tuple(out_shape) if out_shape is not None else tuple(vol.shape)
    grid = identity_grid(out_shape, vol.device).reshape(3, -1)
    coords = matrix[:3, :3] @ grid + matrix[:3, 3][:, None]
    sampler = nearest_sample if nearest else trilinear_sample
    return sampler(vol, coords.reshape(3, *out_shape), cval=cval)


def rigid_matrix(params: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """6-DoF rigid transform -> 3x4 voxel-space matrix about ``center``.

    params = (rz, ry, rx, tz, ty, tx): Euler angles (radians) about axes 0, 1
    and 2, and translations (voxels). Differentiable with respect to params.
    """
    rz, ry, rx, tz, ty, tx = params.unbind()
    one, zero = torch.ones_like(rz), torch.zeros_like(rz)
    cz_, sz_ = torch.cos(rz), torch.sin(rz)
    cy_, sy_ = torch.cos(ry), torch.sin(ry)
    cx_, sx_ = torch.cos(rx), torch.sin(rx)

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    r0 = mat([(one, zero, zero), (zero, cz_, -sz_), (zero, sz_, cz_)])
    r1 = mat([(cy_, zero, sy_), (zero, one, zero), (-sy_, zero, cy_)])
    r2 = mat([(cx_, -sx_, zero), (sx_, cx_, zero), (zero, zero, one)])
    rot = r0 @ r1 @ r2
    offset = center - rot @ center + torch.stack([tz, ty, tx])
    return torch.cat([rot, offset[:, None]], dim=1)
