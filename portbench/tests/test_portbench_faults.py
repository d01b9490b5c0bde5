"""A run with its timed path broken (the state left unchanged; half the rows
left out of the step; the whole batch forward and the losses over half of
it) comes out not correct, and so does the control (the reference computed
with fp8 operands in the program's place): each cell's faults and control, at
a small volume on the CPU, held to the cell's own limits."""

import pytest
import torch

from portbench import check, data, harness
from portbench.reference import models as ref

CELLS = ["flagship.train.b4", "causal.train.b4"]
SMALL = {"volume": [32, 32, 32], "subjects": 8, "batch": 2}
SEED = 2**31 + 11


def _run(cell, fault):
    torch.set_num_threads(4)
    return harness.run(cell, SEED, 0.0, False, "cpu", fault=fault, overrides=SMALL, log=lambda line: None)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["frozen", "half_batch", "half_loss"])
def test_a_broken_step_is_not_correct(cell, fault):
    result = _run(cell, fault)
    assert result["correct"] is False
    worst = {k: v["value"] / v["limit"] for k, v in result["check"].items()}
    # a frozen state reads 1 on the gradient and the change; a half batch gives the outputs of half the rows;
    # losses over half the rows turn the signs of the first gradient's elements
    if fault == "frozen":
        assert worst["change"] > 1 and worst["grad"] > 1, worst
    elif fault == "half_batch":
        assert worst["output"] > 1, worst
    else:
        assert any(worst[k] > 1 for k in worst if k.startswith(("grad_sign", "leaf_sign"))), worst


@pytest.mark.parametrize("cell", CELLS)
def test_the_fp8_control_is_not_correct(cell):
    torch.set_num_threads(4)
    cell_file, cfg, traffic = harness.cell_parts(cell, SMALL)
    task, feeder = harness.modules(cfg, traffic)
    dev = torch.device("cpu")
    with torch.device("meta"):
        spec = task.REFERENCE(cfg).nets
    weights = data.make_weights(spec, SEED, dev)
    store = feeder.make_store(traffic, cfg, SEED, dev)
    batches, noises = harness.reference_inputs(task, feeder, cfg, traffic, store, SEED, dev)
    control = harness.reference_record(task, cfg, weights, batches, noises, dev, ref.Precision(fp8=True))
    want = harness.reference_record(task, cfg, weights, batches, noises, dev)
    assert not check.verdict(check.readings(control, want), cell_file["limits"])
