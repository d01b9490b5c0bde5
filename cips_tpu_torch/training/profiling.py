"""Profiling: the operator's trace (port of cips_tpu/training/profiling.py).

  * `trace(log_dir)`: a torch.profiler trace of the enclosed block, written as
    ``{log_dir}/trace.json`` (Chrome trace format; Perfetto reads it), the
    card's kernels included when one is in use, and on a "cips spans" track of
    the same file the block's spans and what each counter of
    `cips_tpu_torch.profiling` added in the block;
  * `device_memory_report()`: every visible card's allocator statistics, with
    the JAX package's keys.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, List

import torch

from cips_tpu_torch.profiling import COUNTERS, Recorder, recording

SPAN_TRACK = "cips spans"


def _write_spans(path: str, rec: Recorder, counts: Dict[str, tuple]) -> None:
    """Add ``rec``'s spans to the Chrome trace at ``path`` as complete events on
    a process of their own, named `SPAN_TRACK`, on the trace's clock, and each
    of ``counts`` (a counter's name: its start and end ns, and what it added)
    as a counter event that steps from 0 to what it added."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    events = doc.setdefault("traceEvents", [])
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = 1 + max([e["pid"] for e in events if isinstance(e.get("pid"), int)], default=0)
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0, "args": {"name": SPAN_TRACK}})
    for i, s in enumerate(rec.spans):
        events.append({"ph": "X", "cat": "cips", "name": s.name, "pid": pid, "tid": 0,
                       "ts": (s.start_ns - base) / 1e3, "dur": s.ns / 1e3,
                       "args": {"id": i, "parent": s.parent, "seq": s.seq, "device_ms": s.device_ms}})
    for name, (start_ns, end_ns, added) in sorted(counts.items()):
        for ns, value in ((start_ns, 0), (end_ns, added)):
            events.append({"ph": "C", "cat": "cips", "name": name, "pid": pid, "tid": 0,
                           "ts": (ns - base) / 1e3, "args": {"value": value}})
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace (host ops, and the card's kernels when CUDA
    is available) of the enclosed block, and the block's spans and counts, into
    ``{log_dir}/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = profile(activities=activities)
    with recording() as rec:
        prof.start()
        before, start_ns = dict(COUNTERS), rec.now_ns()
        try:
            yield prof
        finally:
            end_ns = rec.now_ns()
            prof.stop()
            rec.resolve()
            counts = {k: (start_ns, end_ns, v - before.get(k, 0)) for k, v in COUNTERS.items()
                      if v != before.get(k, 0)}
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, "trace.json")
            prof.export_chrome_trace(path)
            _write_spans(path, rec, counts)


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
