"""Device milliseconds a step from start to end of the G forward's and the D
forward's phases (`step.g_forward`: zero_grad, G, the losses with the frozen
D and LPIPS; `step.d_forward`), by their CUDA events, over the profiled steps,
not the window (the profiler slows them), rank 0 (`_spans`). In a cell the
host paces, the card idles inside these intervals while it waits for the
launching thread, and that idle time is counted."""

from portbench.metrics._spans import device_ms_per_step

UNIT = "ms/step"


def read(run):
    return device_ms_per_step(run, "step.g_forward", "step.d_forward")
