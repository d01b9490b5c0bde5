"""Image-quality metrics: MAE, MSE, PSNR, SSIM, MS-SSIM (3-D and the folder
tool's slice-wise 2-D form), port of cips_tpu/ops/metrics.py.

PSNR = 10 log10(1 / MSE) with data range 1. MS-SSIM follows torchmetrics'
MultiScaleStructuralSimilarityIndexMeasure with data_range 1: a gaussian
window (inference uses kernel 5, sigma 0.5), 5 scales with the standard
weights, 2x2x2 VALID average pooling between scales, and a relu before the
weighted product. Computation is fp32. The separable VALID filters are written
as weighted sums of shifted slices, so it is plain fp32 arithmetic on any
device (no TF32 convolution on the card).

Volumes are (D, H, W) or batched (N, D, H, W).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def mae(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).abs().mean()


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a.float() - b.float()
    return (d * d).mean()


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    return 10.0 * torch.log10((data_range**2) / mse(a, b))


def _gaussian_kernel1d(size: int, sigma: float, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return g / g.sum()


def _filter(x: torch.Tensor, kernel1d: torch.Tensor) -> torch.Tensor:
    """Separable 'valid' filtering of (N, *spatial) along every spatial axis."""
    k = kernel1d.shape[0]
    for axis in range(1, x.ndim):
        n = x.shape[axis] - k + 1
        x = sum(kernel1d[t] * x.narrow(axis, t, n) for t in range(k))
    return x


def _ssim_and_cs(
    a: torch.Tensor, b: torch.Tensor, kernel_size: int, sigma: float, data_range: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    kern = _gaussian_kernel1d(kernel_size, sigma, a.device)
    mu_a = _filter(a, kern)
    mu_b = _filter(b, kern)
    mu_aa = _filter(a * a, kern)
    mu_bb = _filter(b * b, kern)
    mu_ab = _filter(a * b, kern)
    var_a = mu_aa - mu_a * mu_a
    var_b = mu_bb - mu_b * mu_b
    cov = mu_ab - mu_a * mu_b
    cs = (2 * cov + c2) / (var_a + var_b + c2)
    ssim_map = ((2 * mu_a * mu_b + c1) / (mu_a * mu_a + mu_b * mu_b + c1)) * cs
    return ssim_map.mean(), cs.mean()


def _as_batched(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x[None] if x.ndim == 3 else x


def ssim(
    a: torch.Tensor, b: torch.Tensor, kernel_size: int = 11, sigma: float = 1.5, data_range: float = 1.0
) -> torch.Tensor:
    return _ssim_and_cs(_as_batched(a), _as_batched(b), kernel_size, sigma, data_range)[0]


def _ms_ssim(
    a: torch.Tensor, b: torch.Tensor, kernel_size: int, sigma: float, data_range: float, weights: Sequence[float]
) -> torch.Tensor:
    """MS-SSIM of (N, *spatial) fp32 batches, 2 or 3 spatial axes, each halved
    by average pooling between scales."""
    pool = F.avg_pool3d if a.ndim == 4 else F.avg_pool2d
    # Clamp the scale count so the window always fits, and renormalise the
    # weights over the scales used (torchmetrics raises on such inputs).
    min_dim = min(a.shape[1:])
    n_scales = len(weights)
    while n_scales > 1 and min_dim // (2 ** (n_scales - 1)) < kernel_size:
        n_scales -= 1
    w = torch.tensor(weights[:n_scales], dtype=torch.float32, device=a.device)
    w = w / w.sum() * sum(weights)
    values = []
    for i in range(n_scales):
        s, cs = _ssim_and_cs(a, b, kernel_size, sigma, data_range)
        values.append(s if i == n_scales - 1 else cs)
        if i != n_scales - 1:
            a = pool(a[:, None], 2)[:, 0]
            b = pool(b[:, None], 2)[:, 0]
    stacked = torch.stack(values).clamp_min(0.0)  # torchmetrics' relu
    return torch.prod(stacked**w)


def ms_ssim(
    a: torch.Tensor,
    b: torch.Tensor,
    kernel_size: int = 11,
    sigma: float = 1.5,
    data_range: float = 1.0,
    weights: Sequence[float] = MS_SSIM_WEIGHTS,
) -> torch.Tensor:
    return _ms_ssim(_as_batched(a), _as_batched(b), kernel_size, sigma, data_range, weights)


def ms_ssim_2d_slicewise(
    a: torch.Tensor,
    b: torch.Tensor,
    kernel_size: int = 11,
    sigma: float = 1.5,
    data_range: float = 1.0,
    weights: Sequence[float] = MS_SSIM_WEIGHTS,
) -> torch.Tensor:
    """MS-SSIM of a (D, H, W) volume as torchmetrics computes it on the 4-D
    (1, D, H, W) input that the reference's folder-metric tool feeds it
    (unet/scripts/metrics.py:53-66): its 2-D path with D as the channel axis,
    a 2-D gaussian window per slice, means over (D, H, W), and 2x2 average
    pooling of H and W only between scales. That is `ms_ssim`'s body with D
    as the batch axis."""
    if a.ndim != 3:
        raise ValueError(f"expected a (D, H, W) volume, got {tuple(a.shape)}")
    return _ms_ssim(a.float(), b.float(), kernel_size, sigma, data_range, weights)


def mean_intensity_match(sys: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """Scale a synthesized volume to the real volume's mean intensity
    (unet/scripts/metrics.py:51-52: ``sys / mean(sys) * mean(real)``)."""
    return sys / torch.clamp_min(sys.mean(), 1e-12) * real.mean()
