"""Space-to-depth packing: the part of `cips_tpu/ops/s2d.py` that the phase-structured
packed convolution needs, in PyTorch.

Layout as in the JAX package, packed (2,2,2): (B, Z, Y, X, 8C), channels last,
phase-major channel order p*C + c with p = (az*2 + ay)*2 + ax. Packing spatial
cells into channels computes exactly the same function with the same parameters:
a k3 stride-1 conv on the full grid equals a k3 conv on the packed grid with a
scattered kernel (`pack_conv_kernel`), or a k2 conv over phase-shifted input with
the phase kernel (`pack_conv_kernel_phase`, `_phase_shift_input`). Kernels are
(k, k, k, Cin, Cout), DHWIO, as in the JAX package.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

PHASES = 8  # phase count of the (2,2,2) packing, the only one this package uses


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, 2Z, 2Y, 2X, C) -> (B, Z, Y, X, 8C), phase-major channels."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, d // 2, h // 2, w // 2, PHASES * c)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """(B, Z, Y, X, 8C) -> (B, 2Z, 2Y, 2X, C)."""
    b, z, y, w, pc = x.shape
    c = pc // PHASES
    x = x.reshape(b, z, y, w, 2, 2, 2, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, 2 * z, 2 * y, 2 * w, c)


@lru_cache(maxsize=None)
def _scatter_indices() -> Tuple[np.ndarray, np.ndarray]:
    """Static index maps for `pack_conv_kernel` (k = 3): for each (output phase,
    kernel offset), where the original tap lands in the packed kernel.

    Returns (dst, src): dst columns are (Kz, Ky, Kx, q_phase, p_phase); src
    columns are (dz, dy, dx) of the original kernel. The packed kernel's support
    stays 3 (cells -1..1) on every axis.
    """
    dst, src = [], []
    phases = [(a, b, c) for a in range(2) for b in range(2) for c in range(2)]
    for pi, ph in enumerate(phases):
        for dz in range(3):
            for dy in range(3):
                for dx in range(3):
                    ts = [a + o - 1 for a, o in zip(ph, (dz, dy, dx))]
                    qs = [t % 2 for t in ts]
                    ks = [(t - q) // 2 for t, q in zip(ts, qs)]
                    dst.append((ks[0] + 1, ks[1] + 1, ks[2] + 1, qs[0] * 4 + qs[1] * 2 + qs[2], pi))
                    src.append((dz, dy, dx))
    return np.asarray(dst, np.int64), np.asarray(src, np.int64)


def _phase_kernel_indices() -> Tuple[np.ndarray, np.ndarray]:
    """Static index maps for `pack_conv_kernel_phase` (k = 3, (2,2,2) packing).

    In the phase-shifted representation (`_phase_shift_input`) the packed conv is
    one dense VALID k2 conv. Per axis, a tap of the original kernel at offset d
    feeding output phase p from input phase q lands at k2 position k with
    d = 2k - p + 1 - q; taps with d outside [0, 2] do not exist (stay zero). 216
    of the 512 (k, q, p) axis triples are live: 27 original taps x 8 output phases.
    """
    dst, src = [], []
    axes = [(k, q, p) for k in range(2) for q in range(2) for p in range(2)]
    for kz, qz, pz in axes:
        dz = 2 * kz - pz + 1 - qz
        if not 0 <= dz <= 2:
            continue
        for ky, qy, py in axes:
            dy = 2 * ky - py + 1 - qy
            if not 0 <= dy <= 2:
                continue
            for kx, qx, px in axes:
                dx = 2 * kx - px + 1 - qx
                if not 0 <= dx <= 2:
                    continue
                dst.append((kz, ky, kx, qz * 4 + qy * 2 + qx, pz * 4 + py * 2 + px))
                src.append((dz, dy, dx))
    return np.asarray(dst, np.int64), np.asarray(src, np.int64)


def _place(w: torch.Tensor, dst: np.ndarray, src: np.ndarray, kk: int, p: int) -> torch.Tensor:
    """(3,3,3,Cin,Cout) taps copied to their (Kz, Ky, Kx, q, p) blocks of a zero
    (kk,kk,kk,p*Cin,p*Cout) kernel: an exact placement in any dtype."""
    k, _, _, cin, cout = w.shape
    if k != 3 or w.shape[1:3] != (3, 3):
        raise ValueError(f"expected a (3, 3, 3, Cin, Cout) kernel, got {tuple(w.shape)}")
    big = w.new_zeros((kk, kk, kk, p, cin, p, cout))
    d, s = torch.from_numpy(dst), torch.from_numpy(src)
    big[d[:, 0], d[:, 1], d[:, 2], d[:, 3], :, d[:, 4], :] = w[s[:, 0], s[:, 1], s[:, 2]]
    return big.reshape(kk, kk, kk, p * cin, p * cout)


def pack_conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """(3,3,3,Cin,Cout) -> (3,3,3,8Cin,8Cout) packed-domain kernel:
    conv(full_grid_x, w) == depth_to_space(conv(space_to_depth(x), W)).
    1/8 dense; a conv with it issues 8 times the mathematical products."""
    dst, src = _scatter_indices()
    return _place(w, dst, src, 3, PHASES)


def pack_conv_kernel_phase(w: torch.Tensor) -> torch.Tensor:
    """(3,3,3,Cin,Cout) -> (2,2,2,8Cin,8Cout) phase-structured kernel, 27/64 dense.

    With `_phase_shift_input`, a VALID k2 conv with it computes the exact packed
    conv with 2.37x the mathematical products instead of 8x."""
    dst, src = _phase_kernel_indices()
    return _place(w, dst, src, 2, PHASES)


def _phase_shift_input(x: torch.Tensor) -> torch.Tensor:
    """(B,Z,Y,X,8C) -> (B,Z+1,Y+1,X+1,8C): phase group q shifted by q per axis.

    Padding group q by (q, 1-q) aligns every group onto the common VALID k2
    window; the zeros reproduce the full-grid conv's zero boundary exactly."""
    c = x.shape[-1] // PHASES
    parts = []
    for qz in range(2):
        for qy in range(2):
            for qx in range(2):
                qi = qz * 4 + qy * 2 + qx
                parts.append(F.pad(x[..., qi * c : (qi + 1) * c], (0, 0, qx, 1 - qx, qy, 1 - qy, qz, 1 - qz)))
    return torch.cat(parts, dim=-1)


def packed_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The packed k3 stride-1 conv as the full-grid conv it equals:
    space_to_depth(conv3d(depth_to_space(x), w, padding 1)), w cast to x's dtype,
    no bias. x (B,Z,Y,X,8Cin), w (3,3,3,Cin,Cout) -> (B,Z,Y,X,8Cout)."""
    full = depth_to_space(x).permute(0, 4, 1, 2, 3)
    out = F.conv3d(full, w.to(x.dtype).permute(4, 3, 0, 1, 2), padding=1)
    return space_to_depth(out.permute(0, 2, 3, 4, 1).contiguous())
