"""The plain reference against the port on the CPU at a small volume, the
port in fp32: one step of each configuration, and the loader's order against
the order the harness works out for the reference."""

import numpy as np
import pytest
import torch

from portbench import check, data, harness
from portbench.feeds import packed
from portbench.reference.train import norms

SMALL = {"volume": [32, 32, 32], "subjects": 4, "batch": 2}


def _one_step(cell, dtype="f32", seed=7):
    from cips_tpu_torch.parallel.mesh import make_mesh

    _, cfg, traffic = harness.cell_parts(cell, dict(SMALL, dtype=dtype))
    task, feeder = harness.modules(cfg, traffic)
    dev = torch.device("cpu")
    with torch.device("meta"):
        spec = task.REFERENCE(cfg).nets
    weights = data.make_weights(spec, seed, dev)
    store = feeder.make_store(traffic, cfg, seed, dev)
    program = task.build(cfg, weights, make_mesh("cpu"), seed, harness.DTYPES[dtype])
    batches, noises = harness.reference_inputs(task, feeder, cfg, traffic, store, seed, dev, steps=1)
    batch = {k: torch.cat([s[k] for s in batches[0]]) for k in ("t1", "pet", "info")}
    hooks = program.capture()
    metrics = program.step(batch)
    for h in hooks:
        h.remove()
    grads = program.first_grads()
    prog = {"losses": [{k: float(v) for k, v in metrics.items()}], "grads": norms(grads),
            "changes": norms({k: v.detach() - weights[k] for k, v in program.leaves().items()}),
            "grad_tensors": grads, "outputs": dict(program.captured)}
    want = harness.reference_record(task, cfg, weights, batches, noises, dev)
    assert set(prog["grads"]) == set(want["grads"]) and set(prog["outputs"]) == set(want["outputs"])
    return check.readings(prog, want)


@pytest.mark.parametrize("cell", ["flagship.train.b4", "causal.train.b4"])
def test_reference_follows_the_port_in_fp32(cell):
    values = _one_step(cell)
    assert values["loss"] < 1e-4 and values["output"] < 1e-4, values
    assert values["grad"] < 1e-3 and values["change"] < 2e-2, values
    assert all(v < 1e-3 for k, v in values.items() if k.startswith("grad_sign")), values


def test_loader_serves_the_rows_the_reference_takes():
    from cips_tpu_torch.data.dataset import BatchLoader

    store = {"volumes": np.arange(12, dtype=np.float16)[:, None, None, None, None] * np.ones((1, 2, 2, 2, 2),
                                                                                            np.float16),
             "covariates": np.arange(12, dtype=np.float32)[:, None]}
    loader = BatchLoader(packed.packed_store(store, ["x"]), 3, seed=2**31 + 5)
    for epoch in (0, 1):
        got = [b["info"][:, 0, 0].astype(int).tolist() for b in loader.epoch(epoch)]
        assert got == [r.tolist() for r in data.batch_rows(2**31 + 5, epoch, 12, 3)]
