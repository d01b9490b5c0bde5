"""Host milliseconds a step in `device_prefetch`'s spans, `prefetch.pin` (the
batch made contiguous and page-locked) and `prefetch.copy` (the side stream's
copies enqueued), over the profiled steps, not the window (the profiler slows
them), rank 0 (`_spans`)."""

from portbench.metrics._spans import host_ms_per_step

UNIT = "ms/step"


def read(run):
    return host_ms_per_step(run, "prefetch.pin", "prefetch.copy")
