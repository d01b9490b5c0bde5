"""Host milliseconds a step in the loader's own spans, `data.gather` (the
batch's rows and covariates read from the float16 store) and `data.widen`
(their fp32 conversion), over the profiled steps, not the window (the
profiler slows them), rank 0 (`_spans`)."""

from portbench.metrics._spans import host_ms_per_step

UNIT = "ms/step"


def read(run):
    return host_ms_per_step(run, "data.gather", "data.widen")
