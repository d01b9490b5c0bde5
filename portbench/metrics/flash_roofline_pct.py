"""The attention work's least time (every self-attention site of the step,
its forward, dQ and dK/dV each at its bound, `portbench.roofline`) over the
device time of the kernels that did it (the port's flash kernels or PyTorch
SDPA's), rank 0."""

from portbench.roofline import attention_bound_s

UNIT = "%"


def read(run):
    if not run.profiles or not run.sites:
        return None
    p = run.profiles[0]
    spent = p.seconds_by_kind().get("attention", 0.0)
    if spent <= 0:
        return None
    return 100.0 * attention_bound_s(run.sites, run.element_bytes) * p.steps / spent
