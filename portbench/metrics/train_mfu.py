"""The step's model FLOPs on one card (counted on the reference at the cell's
shapes for one rank's rows, nothing recomputed) over the window's time a step,
as a share of the card's dense bf16 peak."""

from portbench.roofline import BF16_FLOPS

UNIT = "%"


def read(run):
    if not run.steps or not run.flops_per_step:
        return None
    return 100.0 * run.flops_per_step * run.steps / run.window_s / BF16_FLOPS
