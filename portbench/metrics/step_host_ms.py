"""Host milliseconds a step inside the train step's `step` span: the launching
thread's time to enqueue G's and D's work (and any wait on the device inside
it), over the profiled steps, not the window (the profiler slows them), rank
0 (`_spans`)."""

from portbench.metrics._spans import host_ms_per_step

UNIT = "ms/step"


def read(run):
    return host_ms_per_step(run, "step")
