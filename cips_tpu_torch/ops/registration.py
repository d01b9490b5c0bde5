"""Rigid registration and N4-style bias correction (port of
cips_tpu/ops/registration.py), in place of the reference's ANTs calls
(preprocess/reg_to_T1.py: N4 :7-8, rigid :11-13, PET->T1 :62-99;
proprocess/reg_processed_mask_and_brain.py :8-35).

A 6-DoF transform drives the trilinear warp of `ops/resample.py`; a similarity
loss (negative NCC, or Mattes-style soft-histogram MI) is minimised with Adam
over a multi-resolution pyramid, the gradient from `torch.autograd`. Adam is
optax's `adam(lr)` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) written as tensor
ops, so a step matches the JAX package's. Everything runs in fp32 on the
device the volumes lie on; no TF32 is turned on here.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Literal, Optional, Sequence, Tuple

import numpy as np
import torch

from cips_tpu_torch.ops.resample import affine_warp, resize_trilinear, rigid_matrix

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def ncc_loss(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Negative normalised cross-correlation (global, optionally masked: ``mask``
    restricts the statistic to foreground voxels)."""
    if mask is None:
        a = a - a.mean()
        b = b - b.mean()
        return -(a * b).sum() / (torch.sqrt((a * a).sum() * (b * b).sum()) + eps)
    w = mask.float()
    n = torch.clamp_min(w.sum(), 1.0)
    a = a - (a * w).sum() / n
    b = b - (b * w).sum() / n
    return -(a * b * w).sum() / (torch.sqrt((a * a * w).sum() * (b * b * w).sum()) + eps)


def mutual_information_loss(
    a: torch.Tensor,
    b: torch.Tensor,
    nbins: int = 32,
    sigma: float = 0.5,
    eps: float = 1e-10,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Negative MI from differentiable Parzen soft histograms (Mattes-style, the
    metric of ANTs' rigid stage). ``mask`` weights each voxel's share of the
    joint histogram, and the intensity range is taken over masked voxels only."""

    def minmax(x):
        if mask is None:
            return x.min(), x.max()
        m = mask.bool()
        return torch.where(m, x, torch.inf).min(), torch.where(m, x, -torch.inf).max()

    def unit(x, lo, hi):  # clip as jnp.clip: maximum then minimum, ties split the gradient
        x = (x - lo) / torch.clamp_min(hi - lo, eps)
        return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))

    a = unit(a, *minmax(a))
    b = unit(b, *minmax(b))
    centers = (torch.arange(nbins, dtype=torch.float32, device=a.device) + 0.5) / nbins
    bw = sigma / nbins

    def soft_assign(x):
        d = (x.reshape(-1, 1) - centers[None, :]) / bw
        w = torch.exp(-0.5 * d * d)
        return w / torch.clamp_min(w.sum(dim=1, keepdim=True), eps)

    wa = soft_assign(a)  # (N, bins)
    wb = soft_assign(b)
    if mask is not None:
        wa = wa * mask.float().reshape(-1, 1)
    joint = wa.T @ wb  # (bins, bins), fp32
    joint = joint / torch.clamp_min(joint.sum(), eps)
    pa = joint.sum(dim=1)
    pb = joint.sum(dim=0)
    mi = torch.sum(joint * (torch.log(joint + eps) - torch.log(pa[:, None] + eps) - torch.log(pb[None, :] + eps)))
    return -mi


@dataclass
class RegistrationResult:
    params: torch.Tensor  # (6,) rz, ry, rx, tz, ty, tx (voxel units at full res, or mm for physical)
    matrix: torch.Tensor  # (3, 4) pull-back voxel affine
    loss: float


def adam_update(p, g, mu, nu, count: int, lr: float):
    """One step of optax.adam(lr): returns (p, mu, nu) after step ``count`` (1-based)."""
    mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
    nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu
    b1, b2 = (torch.tensor(b, dtype=torch.float32, device=p.device) for b in (ADAM_B1, ADAM_B2))
    mu_hat = mu / (1 - b1**count)
    nu_hat = nu / (1 - b2**count)
    return p + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)), mu, nu


def _register_level(
    moving: torch.Tensor,
    fixed: torch.Tensor,
    params0: torch.Tensor,
    metric: str,
    iters: int,
    lr: float,
    mask: Optional[torch.Tensor] = None,
    mat_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` Adam steps from ``params0``; returns (params, objective(params))."""
    loss_fn = ncc_loss if metric == "ncc" else mutual_information_loss
    if mat_fn is None:  # voxel-space rigid about the fixed volume's center
        center = (torch.tensor(fixed.shape, dtype=torch.float32, device=fixed.device) - 1.0) / 2.0
        mat_fn = functools.partial(rigid_matrix, center=center)

    def objective(p):
        return loss_fn(affine_warp(moving, mat_fn(p), out_shape=fixed.shape), fixed, mask=mask)

    p = params0.detach()
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    for step in range(1, iters + 1):
        leaf = p.requires_grad_(True)
        (g,) = torch.autograd.grad(objective(leaf), leaf)
        with torch.no_grad():
            p, mu, nu = adam_update(leaf, g, mu, nu, step, lr)
    with torch.no_grad():
        return p, objective(p)


def _rotation_seeds(n: int, device=None) -> torch.Tensor:
    """(n, 6) multi-start initialisations: identity first, then +-30 and +-60
    degree single-axis rotations (past gradient descent's ~15 degree basin)."""
    seeds = [torch.zeros(6, dtype=torch.float32, device=device)]
    for mag in (np.pi / 6, np.pi / 3):
        for axis in range(3):
            for sign in (1.0, -1.0):
                s = torch.zeros(6, dtype=torch.float32, device=device)
                s[axis] = sign * mag
                seeds.append(s)
    return torch.stack(seeds[: max(1, n)])


def _best_of_seeds(level: Callable, mv, fx, n_starts: int, lr: float):
    """Each rotation seed through ``level``; the candidate of least loss (the first on a tie)."""
    cands = [level(mv, fx, seed, lr=lr) for seed in _rotation_seeds(n_starts, fx.device)]
    best = int(torch.argmin(torch.stack([loss for _, loss in cands])))
    return cands[best]


def _level_mask(mask: Optional[torch.Tensor], shape_f) -> Optional[torch.Tensor]:
    if mask is None:
        return None
    return (resize_trilinear(mask.float(), shape_f) > 0.5).float()


def _level_shapes(moving, fixed, factor: int):
    return (tuple(max(4, s // factor) for s in moving.shape), tuple(max(4, s // factor) for s in fixed.shape))


def register_rigid(
    moving: torch.Tensor,
    fixed: torch.Tensor,
    metric: Literal["ncc", "mi"] = "ncc",
    pyramid: Sequence[int] = (4, 2, 1),
    iters_per_level: int = 100,
    lr: float = 0.05,
    mask: Optional[torch.Tensor] = None,
    n_starts: int = 1,
) -> RegistrationResult:
    """Coarse-to-fine 6-DoF registration of ``moving`` onto ``fixed`` in voxel space.

    Rotations in radians; translations in voxels of the current level
    (rescaled between levels); the level's lr is ``lr / (i + 1)``. Returns the
    pull-back matrix for `affine_warp` (and, with ``nearest=True``, for label
    maps). ``mask`` (fixed-image foreground) restricts the metric. ``n_starts``
    > 1 runs that many rotation seeds through the coarsest level and continues
    with the best.
    """
    moving, fixed = moving.float(), fixed.float()
    params = torch.zeros(6, dtype=torch.float32, device=fixed.device)
    level = functools.partial(_register_level, metric=metric, iters=iters_per_level)
    prev_factor = None
    loss = torch.zeros((), device=fixed.device)
    for i, factor in enumerate(pyramid):
        shape_m, shape_f = _level_shapes(moving, fixed, factor)
        mv, fx = resize_trilinear(moving, shape_m), resize_trilinear(fixed, shape_f)
        mk = _level_mask(mask, shape_f)
        if i == 0 and n_starts > 1:
            params, loss = _best_of_seeds(functools.partial(level, mask=mk), mv, fx, n_starts, lr)
            prev_factor = factor
            continue
        if prev_factor is not None:
            params = torch.cat([params[:3], params[3:] * (prev_factor / factor)])
        params, loss = level(mv, fx, params, lr=lr / (i + 1), mask=mk)
        prev_factor = factor
    if pyramid[-1] != 1:  # translations to full resolution
        params = torch.cat([params[:3], params[3:] * float(pyramid[-1])])
    center = (torch.tensor(fixed.shape, dtype=torch.float32, device=fixed.device) - 1.0) / 2.0
    return RegistrationResult(params=params, matrix=rigid_matrix(params, center), loss=float(loss))


def apply_transform(img: torch.Tensor, matrix: torch.Tensor, out_shape=None, nearest: bool = False) -> torch.Tensor:
    """Apply a registration result to an image or label volume."""
    return affine_warp(img, matrix, out_shape=out_shape, nearest=nearest)


# Arrays are (z, y, x) while NIfTI affines map (i=x, j=y, k=z) voxel indices to
# physical mm; this permutation turns an xyz affine into zyx index order.
_PERM_ZYX = np.array([[0, 0, 1, 0], [0, 1, 0, 0], [1, 0, 0, 0], [0, 0, 0, 1]], dtype=np.float64)


def _zyx_affine(affine_xyz: np.ndarray) -> np.ndarray:
    """4x4 NIfTI (xyz index -> physical xyz) -> (zyx index -> physical zyx)."""
    return _PERM_ZYX @ np.asarray(affine_xyz, np.float64) @ _PERM_ZYX


def _homog(m34: torch.Tensor) -> torch.Tensor:
    return torch.cat([m34, torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=m34.dtype, device=m34.device)], dim=0)


def _physical_pullback(p, am_inv_zyx, af_zyx, center_phys_zyx):
    """(6,) physical rigid params -> (3, 4) voxel pull-back matrix:
    v_moving = A_m^-1 · R(p) · A_f · v_fixed, R rigid about the fixed volume's
    physical center (radians and mm, ANTs' rigid parameterisation)."""
    return (am_inv_zyx @ _homog(rigid_matrix(p, center_phys_zyx)) @ af_zyx)[:3]


def register_rigid_physical(
    moving: torch.Tensor,
    fixed: torch.Tensor,
    moving_affine: np.ndarray,
    fixed_affine: np.ndarray,
    metric: Literal["ncc", "mi"] = "ncc",
    pyramid: Sequence[int] = (4, 2, 1),
    iters_per_level: int = 100,
    lr: float = 0.05,
    mask: Optional[torch.Tensor] = None,
    n_starts: int = 1,
) -> RegistrationResult:
    """6-DoF registration in PHYSICAL space using the NIfTI affines.

    Anisotropic spacings, oblique direction cosines and shifted origins make a
    voxel-space rigid transform unable to express the true alignment. The
    headers give the initial alignment (params = 0 is A_m^-1 · A_f) and Adam
    refines a rigid motion in mm and radians about the fixed volume's physical
    center (reg_to_T1.py:62-99). ``matrix`` pulls the ORIGINAL moving grid back
    onto the fixed grid (``apply_transform(moving, matrix, out_shape=fixed.shape)``).
    """
    moving, fixed = moving.float(), fixed.float()
    dev = fixed.device
    af_full = _zyx_affine(fixed_affine)
    am_full = _zyx_affine(moving_affine)
    center_vox = (np.asarray(fixed.shape, np.float64) - 1.0) / 2.0
    center_phys = torch.tensor((af_full @ np.append(center_vox, 1.0))[:3], dtype=torch.float32, device=dev)

    def level_affines(shape_m, shape_f):
        s_m = np.append(np.asarray(moving.shape, np.float64) / np.asarray(shape_m, np.float64), 1.0)
        s_f = np.append(np.asarray(fixed.shape, np.float64) / np.asarray(shape_f, np.float64), 1.0)
        am_inv_l = np.linalg.inv(am_full @ np.diag(s_m))
        af_l = af_full @ np.diag(s_f)
        return (torch.tensor(am_inv_l, dtype=torch.float32, device=dev),
                torch.tensor(af_l, dtype=torch.float32, device=dev))

    params = torch.zeros(6, dtype=torch.float32, device=dev)
    loss = torch.zeros((), device=dev)
    for i, factor in enumerate(pyramid):
        shape_m, shape_f = _level_shapes(moving, fixed, factor)
        mv, fx = resize_trilinear(moving, shape_m), resize_trilinear(fixed, shape_f)
        am_inv_l, af_l = level_affines(shape_m, shape_f)
        mat_fn = functools.partial(_physical_pullback, am_inv_zyx=am_inv_l, af_zyx=af_l, center_phys_zyx=center_phys)
        level = functools.partial(_register_level, metric=metric, iters=iters_per_level,
                                  mask=_level_mask(mask, shape_f), mat_fn=mat_fn)
        if i == 0 and n_starts > 1:
            params, loss = _best_of_seeds(level, mv, fx, n_starts, lr)
            continue
        # physical params (mm, radians) carry across levels unchanged
        params, loss = level(mv, fx, params, lr=lr / (i + 1))
    am_inv = torch.tensor(np.linalg.inv(am_full), dtype=torch.float32, device=dev)
    matrix = _physical_pullback(params, am_inv, torch.tensor(af_full, dtype=torch.float32, device=dev), center_phys)
    return RegistrationResult(params=params, matrix=matrix, loss=float(loss))


def n4_bias_correct(
    img: torch.Tensor, grid: Tuple[int, int, int] = (4, 4, 4), iters: int = 2, eps: float = 1e-6
) -> torch.Tensor:
    """Lightweight N4-style bias-field correction (reg_to_T1.py:7-8): the
    multiplicative bias is a log-domain field on a coarse control grid (the
    log residual resized down to ``grid`` and back up), mean intensity kept."""
    img = img.float()
    pos = img > 0
    log_img = torch.log(torch.where(pos, img, torch.ones_like(img)))
    field = torch.zeros_like(log_img)
    zero = torch.zeros_like(log_img)
    for _ in range(iters):
        residual = torch.where(pos, log_img - field, zero)
        smooth = resize_trilinear(resize_trilinear(residual, grid), img.shape)
        mean_r = residual.sum() / torch.clamp_min(pos.sum().float(), 1.0)
        field = field + (smooth - mean_r)
    corrected = torch.where(pos, torch.exp(log_img - field), zero)
    return corrected * (img.sum() / torch.clamp_min(corrected.sum(), eps))
