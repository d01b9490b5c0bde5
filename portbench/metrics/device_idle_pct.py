"""The share of the measured window in which no kernel ran on the device, on
any stream: one minus the device's busy time a step (the union of the
kernels' intervals over the profiled steps, a step) over the window's wall
time a step, rank 0. The window itself runs unprofiled, so the profiler's own
cost on the host (a tenth of the flagship's step) stays out of it."""

UNIT = "%"


def read(run):
    if not run.profiles or not run.steps or run.window_s <= 0 or not run.profiles[0].steps:
        return None
    p = run.profiles[0]
    return 100.0 * (1.0 - (p.busy_s() / p.steps) / (run.window_s / run.steps))
