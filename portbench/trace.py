"""Reduction of a `torch.profiler` trace of the profiled steps to device time
by kernel kind, the device's busy union, and its idle gaps named by the
benchmark's host span.

The trace records the device alone (recording each host operation would slow
the host-paced steps it measures). The profiled window opens and closes on a
synchronised device with a marker kernel (`mark`): from the first marker's
start to the last's end. The harness's host spans, taken on the host clock,
are placed on the device's timeline by the first marker, which starts as the
host launches it on an idle device. The profiler may leave a marker out of its
records (it drops device records that it places outside its own capture
window); the window's edge is then the first kernel's start or the last
kernel's end, and the spans are placed by the first kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

MARKER = "spin_kernel"  # `torch.cuda._sleep`'s kernel
HOST_SPANS = ("portbench.loader_next", "portbench.step", "portbench.metric_read")

# (kind, substrings of the kernel name), first match wins; the attention patterns
# take the port's kernels and PyTorch SDPA's flash, efficient and cuDNN ones
KERNEL_KINDS = (
    ("attention", ("flash_fwd", "flash_bwd", "flash_attn", "fmha", "sdpa", "efficient_attention")),
    ("collective", ("nccl",)),
    ("convolution", ("fprop", "dgrad", "wgrad", "conv", "implicit_gemm", "cudnn", "nchwToNhwc", "nhwcToNchw")),
    ("matmul", ("gemm", "cutlass", "sm90", "nvjet")),
    ("optimizer", ("multi_tensor",)),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "copy", "vectorized", "cat", "index")),
)


def kind_of(name: str) -> str:
    return next((kind for kind, keys in KERNEL_KINDS if any(key in name for key in keys)), "other")


@dataclass
class Profile:
    """The kernels of the profiled window, (name, start s, end s) each, the
    window's (start, end) and the host spans, (name, start, end) each."""

    kernels: List[Tuple[str, float, float]]
    window: Tuple[float, float]
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    steps: int = 0
    markers: int = 2  # the marker kernels that placed the window's edges

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def seconds_by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, a, b in self.kernels:
            kind = kind_of(name)
            out[kind] = out.get(kind, 0.0) + (b - a)
        return out

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the kernels' intervals inside the window, in order."""
        lo, hi = self.window
        merged: List[List[float]] = []
        for _, a, b in sorted(self.kernels, key=lambda k: k[1]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Each stretch of the window with no kernel running, named by the host
        span that overlaps it most ("other" where none does), longest first."""
        lo, hi = self.window
        edges, t = [], lo
        for a, b in self.busy_intervals():
            if a > t:
                edges.append((t, a))
            t = max(t, b)
        if hi > t:
            edges.append((t, hi))
        named = []
        for a, b in edges:
            overlap = {}
            for name, s0, s1 in self.spans:
                part = min(b, s1) - max(a, s0)
                if part > 0:
                    overlap[name] = overlap.get(name, 0.0) + part
            named.append((max(overlap, key=overlap.get) if overlap else "other", b - a))
        return sorted(named, key=lambda g: -g[1])

    def top_kernels(self, n: int = 10) -> List[Tuple[str, float]]:
        total: Dict[str, float] = {}
        for name, a, b in self.kernels:
            total[name] = total.get(name, 0.0) + (b - a)
        return sorted(total.items(), key=lambda kv: -kv[1])[:n]


def mark(device) -> None:
    """A marker kernel of a few hundred cycles on ``device`` (nothing on the CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda._sleep(256)


def from_profiler(prof, steps: int, spans: Sequence[Tuple[str, float, float]] = (),
                  host: Tuple[float, float] = (0.0, 0.0)) -> Optional[Profile]:
    """The `Profile` of a finished ``torch.profiler.profile`` whose window opens
    and closes with `mark`, ``spans`` (name, start, end) and ``host`` (the
    window's start and end) on the host clock. Without device records (the
    CPU) the window is the host's and the kernels none; None when the device
    recorded markers but no kernel. An edge whose marker is missing from the
    records is the kernels' own (see the module's docstring)."""
    kernels, markers = [], []
    for ev in prof.profiler.kineto_results.events():
        if "cuda" not in str(ev.device_type()).lower() or ev.is_user_annotation():
            continue
        name = ev.name()
        a = ev.start_ns() * 1e-9
        b = a + ev.duration_ns() * 1e-9
        if MARKER in name:
            markers.append((a, b))
        elif not name.startswith(("Memcpy", "Memset")):
            kernels.append((name, a, b))
    if not kernels and not markers:
        return Profile(kernels=[], window=host, spans=[s for s in spans if s[0] in HOST_SPANS], steps=steps,
                       markers=0)
    if not kernels:
        return None
    first = min(a for _, a, _ in kernels)
    last = max(b for _, _, b in kernels)
    opening = sorted(m for m in markers if m[0] <= first)
    closing = sorted(m for m in markers if m[1] >= last)
    lo = opening[0][0] if opening else first
    hi = closing[-1][1] if closing else last
    shift = lo - host[0]
    placed = [(name, a + shift, b + shift) for name, a, b in spans if name in HOST_SPANS]
    return Profile(kernels=kernels, window=(lo, hi), spans=placed, steps=steps,
                   markers=int(bool(opening)) + int(bool(closing)))


def breakdown(profiles: Sequence[Profile]) -> dict:
    """The ``breakdown`` of the result line, from rank 0's profile."""
    p = profiles[0]
    return {"device_ops": [[name[:160], s] for name, s in p.top_kernels(10)],
            "idle_gaps": [[name, s] for name, s in p.idle_gaps()[:10]]}
