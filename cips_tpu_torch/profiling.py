"""The program's spans and counters. It imports nothing of the port, so every
layer (ops, data, parallel, training) records into it; `training.profiling`
writes them into the operator's trace.

  * `span(name, seq, device)`: one interval of the program's work, kept in
    memory while `recording()` is open or a ``torch.profiler`` runs (`profiled`
    hands out the newest profiler session's), on the profiler's clock (Unix
    ns); otherwise a shared null context: no allocation on the host or on the
    card. As torch's own ``record_function``, spans record under any torch
    profiler, so that a profile taken around the program (a benchmark's traced
    steps) holds them without a change to its caller. A profiler session's
    spans are those recorded under a profiler since the last span opened
    without one; a new session drops the last. No span is left open across a
    ``yield``: a consumer's time is not its producer's.
  * the spans the program opens:
      - ``data.gather`` and ``data.widen`` (`BatchLoader.epoch`: the rows and
        covariates read from the float16 store; their fp32 conversion, and crop
        and re-normalisation when cropping), a batch each;
      - ``prefetch.pin`` and ``prefetch.copy`` (`device_prefetch`: the batch as
        contiguous host tensors, page-locked on a card; the side stream's
        copies and their event), a batch each;
      - ``step`` (each trainer's `make_train_step`) and its phases
        ``step.g_forward`` (zero_grad, G's forward, the losses, the frozen D and
        LPIPS in G's loss), ``step.g_backward``, ``step.guard`` (with
        ``nan_guard``), ``step.g_optimizer``, ``step.d_forward``,
        ``step.d_backward``, ``step.d_optimizer``; each phase also has the
        device's time (`Span.device_ms`);
      - ``train.metric_read`` (`common.mean_over_ranks`: the host read, and the
        all-reduce across ranks, of a step's metrics).
  * `COUNTERS`: one registry of counts, kept whether or not spans are recorded
    (read by `counters`, cleared by `reset`): ``data.bytes_read``,
    ``data.bytes_widened``, ``prefetch.bytes_copied``,
    ``flash.{fwd,dq,dkv}.launches``, ``group_norm.{fwd,bwd}.launches`` (a norm's
    call each way, `ops.group_norm`), ``group_norm.plain.calls`` (its plain
    version's), ``phase_conv.launches.<variant>``,
    ``ddp.reduced_bytes``, ``space.exchanged.<kind>`` (`parallel.spatial.KINDS`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

COUNTERS: collections.Counter = collections.Counter()


def counters(prefix: str) -> Dict[str, int]:
    """The counts whose keys start with ``prefix``, by the rest of the key."""
    return {k[len(prefix):]: v for k, v in COUNTERS.items() if k.startswith(prefix)}


def reset(prefix: str) -> None:
    """Forget the counts whose keys start with ``prefix``."""
    for k in [k for k in COUNTERS if k.startswith(prefix)]:
        del COUNTERS[k]


@dataclasses.dataclass(slots=True, eq=False)
class Span:
    """One recorded span: ``start_ns`` and ``end_ns`` on the profiler's clock
    (Unix ns); ``parent``, the index in the recorder's ``spans`` of the span
    open around it (None for a root); ``seq``, the step or batch number it
    belongs to (a root's own, a child's its parent's); ``device_ms``, for a
    span given a device, the device's time from the span's start to its end on
    the current stream (the host's own interval on the CPU; on a card from a
    pair of CUDA events, read by `Recorder.resolve`), else None."""

    name: str
    start_ns: int
    parent: Optional[int]
    seq: Optional[int]
    end_ns: int = 0
    device_ms: Optional[float] = None
    events: Optional[tuple] = None

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


class Recorder:
    """The spans recorded, in the order they opened."""

    def __init__(self):
        self.spans: List[Span] = []
        self._open: List[int] = []  # the indices of the spans open now, innermost last
        # perf_counter is monotonic; the offset puts its stamps on the profiler's Unix clock
        self._offset_ns = time.time_ns() - time.perf_counter_ns()

    def now_ns(self) -> int:
        return time.perf_counter_ns() + self._offset_ns

    def resolve(self) -> None:
        """Read the device times of the spans recorded on a card (once each,
        waiting for each span's end event); call after the work's last
        synchronise."""
        for s in self.spans:
            if s.events is not None:
                start, end = s.events
                end.synchronize()
                s.device_ms, s.events = start.elapsed_time(end), None


class _Open:
    """An open span (the context manager `span` returns while recording)."""

    __slots__ = ("recorder", "name", "seq", "device", "index")

    def __init__(self, recorder: Recorder, name: str, seq: Optional[int], device: Optional[torch.device]):
        self.recorder, self.name, self.seq, self.device = recorder, name, seq, device

    def __enter__(self) -> Span:
        rec = self.recorder
        parent = rec._open[-1] if rec._open else None
        seq = self.seq if self.seq is not None or parent is None else rec.spans[parent].seq
        s = Span(self.name, rec.now_ns(), parent, seq)
        if self.device is not None and self.device.type == "cuda":
            s.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            s.events[0].record(torch.cuda.current_stream(self.device))
        self.index = len(rec.spans)
        rec._open.append(self.index)
        rec.spans.append(s)
        return s

    def __exit__(self, *exc) -> None:
        rec = self.recorder
        s = rec.spans[self.index]
        if s.events is not None:
            s.events[1].record(torch.cuda.current_stream(self.device))
        s.end_ns = rec.now_ns()
        if self.device is not None and self.device.type == "cpu":
            s.device_ms = s.ns / 1e6  # the CPU does the work as the host issues it
        rec._open.pop()


_NULL = contextlib.nullcontext()
_active: Optional[Recorder] = None  # the innermost open `recording()`
_session: Optional[Recorder] = None  # the newest torch.profiler session's spans
_in_session = False  # True from a session's first span to the first span with the profiler off


def span(name: str, seq: Optional[int] = None, device: Optional[torch.device] = None):
    """A context manager that records ``name``'s interval while spans are
    recorded (``seq`` a root's step or batch number; ``device`` a phase's
    device, whose time is recorded too); the shared null context otherwise."""
    global _in_session
    if _active is not None:
        return _Open(_active, name, seq, device)
    if _autograd_profiler._is_profiler_enabled:
        return _Open(_session_recorder(), name, seq, device)
    _in_session = False
    return _NULL


def _session_recorder() -> Recorder:
    global _session, _in_session
    if not _in_session:
        _session, _in_session = Recorder(), True  # the last session, and its unread events, go
    return _session


def profiled() -> Optional[Recorder]:
    """The recorder of the newest torch.profiler session's spans (those taken
    outside any `recording()`), or None when there was none."""
    return _session


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Record the block's spans into a new `Recorder`, handed out here."""
    global _active
    outer, rec = _active, Recorder()
    _active = rec
    try:
        yield rec
    finally:
        _active = outer
