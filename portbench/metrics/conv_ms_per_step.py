"""Device milliseconds a step in cuDNN convolutions and their layout
transposes (kernel names by `portbench.trace.KERNEL_KINDS`), rank 0."""

UNIT = "ms/step"


def read(run):
    if not run.profiles:
        return None
    p = run.profiles[0]
    ms = p.seconds_by_kind().get("convolution", 0.0) * 1e3
    return ms / p.steps if ms > 0 else None
