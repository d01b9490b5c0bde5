"""Profiling utilities (port of cips_tpu/training/profiling.py).

  * `trace(log_dir)`: a torch.profiler trace of the enclosed block, written as
    ``{log_dir}/trace.json`` (Chrome trace format; Perfetto reads it), the
    card's kernels included when one is in use;
  * `timed_steps`: wall-clock per-step statistics with warm-up skipping;
  * `device_memory_report()`: every visible card's allocator statistics, with
    the JAX package's keys.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterable, Iterator, List

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace (host ops, and the card's kernels when CUDA
    is available) of the enclosed block into ``{log_dir}/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_report() -> List[Dict]:
    """One record a visible card: ``bytes_in_use`` and ``peak_bytes_in_use``
    (the caching allocator's allocated bytes, now and at their peak since the
    last reset) and ``bytes_limit`` (the card's total memory), as the JAX
    package names them, with ``bytes_free`` (free on the card, all processes'
    use counted). Empty without CUDA."""
    out = []
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        stats = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        out.append({
            "device": f"cuda:{i}",
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "bytes_limit": total,
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_free": free,
        })
    return out


class timed_steps:
    """Wrap a step iterable; collects per-step wall time (the caller makes each
    step's device work finish inside the loop: a host read or a synchronize).

    t = timed_steps(loader.epoch(e))
    for batch in t: ...
    print(t.report())
    """

    def __init__(self, iterable: Iterable, warmup: int = 2):
        self._it = iterable
        self.warmup = warmup
        self.times: List[float] = []

    def __iter__(self) -> Iterator:
        last = time.perf_counter()
        for item in self._it:
            yield item
            now = time.perf_counter()
            self.times.append(now - last)
            last = now

    def report(self) -> Dict[str, float]:
        steady = self.times[self.warmup :] or self.times
        if not steady:
            return {"steps": 0}
        return {
            "steps": len(self.times),
            "mean_s": sum(steady) / len(steady),
            "min_s": min(steady),
            "max_s": max(steady),
        }
