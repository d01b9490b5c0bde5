"""Host milliseconds a step waits in ``next()`` on the prefetch iterator over
the loader (`BatchLoader.epoch` through `device_prefetch`), the mean over the
window's steps on rank 0."""

UNIT = "ms/step"


def read(run):
    return 1e3 * sum(run.waits) / len(run.waits) if run.waits else None
