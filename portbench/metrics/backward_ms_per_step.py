"""Device milliseconds a step from start to end of G's and D's backward
phases (`step.g_backward`, `step.d_backward`), by their CUDA events, over the
profiled steps, not the window (the profiler slows them), rank 0 (`_spans`).
In a cell the host paces, the card idles inside these intervals while it
waits for the launching thread, and that idle time is counted."""

from portbench.metrics._spans import device_ms_per_step

UNIT = "ms/step"


def read(run):
    return device_ms_per_step(run, "step.g_backward", "step.d_backward")
