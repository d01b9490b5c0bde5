"""Plain fp32 2.5-D LPIPS over SqueezeNet-1.1's seven taps (MONAI-generative's
``PerceptualLoss(network_type="squeeze", is_fake_3d=True, fake_3d_ratio=0.5)``
with richzhang LPIPS's scaling layer and lin weights).

Along each of D, H and W every second slice of both volumes is folded into
the batch, LPIPS is averaged over those slices, and the three axis means are
summed. Parameter names are the program's (``lpips.net.fire3.squeeze.weight``,
``lpips.lin0``). Nothing here imports the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.models import PLAIN, Precision, operand

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
TAP_CHANNELS = (64, 128, 256, 384, 384, 512, 512)
FIRES = {"fire3": (64, 16, 64), "fire4": (128, 16, 64), "fire6": (128, 32, 128), "fire7": (256, 32, 128),
         "fire9": (256, 48, 192), "fire10": (384, 48, 192), "fire11": (384, 64, 256), "fire12": (512, 64, 256)}
STAGES = (("pool", "fire3", "fire4"), ("pool", "fire6", "fire7"), ("pool", "fire9"), ("fire10",), ("fire11",),
          ("fire12",))


class Conv2d(nn.Conv2d):
    def __init__(self, *args, p: Precision = PLAIN, **kw):
        super().__init__(*args, **kw)
        self.p = p

    def forward(self, x):
        return F.conv2d(operand(x, self.p), operand(self.weight, self.p), self.bias, self.stride, self.padding)


class Fire(nn.Module):
    def __init__(self, cin, squeeze, expand, p: Precision):
        super().__init__()
        self.squeeze = Conv2d(cin, squeeze, 1, p=p)
        self.expand1x1 = Conv2d(squeeze, expand, 1, p=p)
        self.expand3x3 = Conv2d(squeeze, expand, 3, padding=1, p=p)

    def forward(self, x):
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)), F.relu(self.expand3x3(s))], dim=1)


class Squeeze(nn.Module):
    def __init__(self, p: Precision):
        super().__init__()
        self.conv0 = Conv2d(3, 64, 3, stride=2, p=p)
        for name, args in FIRES.items():
            self.add_module(name, Fire(*args, p=p))

    def forward(self, x):
        h = F.relu(self.conv0(x))
        taps = [h]
        for stage in STAGES:
            for layer in stage:
                if layer == "pool":
                    if min(h.shape[-2:]) < 2:
                        return taps
                    h = F.max_pool2d(h, 3, 2, ceil_mode=True)
                else:
                    h = getattr(self, layer)(h)
            taps.append(h)
        return taps


class LPIPS(nn.Module):
    def __init__(self, p: Precision):
        super().__init__()
        self.net = Squeeze(p)
        for i, c in enumerate(TAP_CHANNELS):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.full((c, 1), 1.0 / c)))

    def forward(self, a, b):
        shift = torch.tensor(SHIFT, device=a.device).view(1, 3, 1, 1)
        scale = torch.tensor(SCALE, device=a.device).view(1, 3, 1, 1)
        fa, fb = self.net((a - shift) / scale), self.net((b - shift) / scale)
        total = torch.zeros(a.shape[0], device=a.device)
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa / (xa.square().sum(dim=1, keepdim=True).sqrt() + 1e-10)
            nb = xb / (xb.square().sum(dim=1, keepdim=True).sqrt() + 1e-10)
            total = total + torch.einsum("bchw,c->bhw", (na - nb).square(), getattr(self, f"lin{i}")[:, 0]).mean((1, 2))
        return total


class PerceptualLoss(nn.Module):
    """2.5-D LPIPS of two channels-last (N, D, H, W, 1) volumes; frozen."""

    def __init__(self, p: Precision = PLAIN, **_):
        super().__init__()
        self.lpips = LPIPS(p)
        self.requires_grad_(False)

    def forward(self, pred, target):
        total = pred.new_zeros(())
        for axis in (2, 3, 4):
            order = (0, axis, 1) + tuple(a for a in (2, 3, 4) if a != axis)
            views = []
            for x in (pred, target):
                x = x.movedim(-1, 1)
                x = x[(slice(None),) * axis + (slice(None, None, 2),)].permute(order)
                views.append(x.reshape(-1, *x.shape[2:]))
            total = total + self.lpips(*views).mean()
        return total
