"""The span metrics: a traced CPU run of each cell prints the six that read the
program's own spans (both cells in one process: each run's own profiled steps),
and a run of a program that records no spans (one from before they were
added, under this benchmark) prints none of them."""

from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.metrics import _spans

SPAN_METRICS = ("data_read_ms", "prefetch_host_ms", "step_host_ms", "forward_ms_per_step", "backward_ms_per_step",
                "optimizer_ms_per_step")


@pytest.mark.parametrize("cell", ["flagship.train.b4", "causal.train.b4"])
def test_a_traced_cpu_run_prints_the_span_metrics(monkeypatch, cell):
    import torch

    torch.set_num_threads(4)
    monkeypatch.setattr(harness, "PROFILE_STEPS", 2)
    result = harness.run(cell, 2**31 + 5, 0.0, True, "cpu",
                         overrides={"volume": [32, 32, 32], "subjects": 4, "batch": 2}, log=lambda line: None)
    metrics = result["metrics"]
    assert set(SPAN_METRICS) <= set(metrics)
    assert all(metrics[m]["unit"] == "ms/step" and metrics[m]["value"] > 0 for m in SPAN_METRICS)
    # the forward, backward and Adam phases lie inside the step
    phases = sum(metrics[m]["value"] for m in SPAN_METRICS[3:])
    assert phases <= metrics["step_host_ms"]["value"]
    # this run's profiled steps alone, whatever ran before in the process: a batch read, a step each
    names = [s.name for s in _spans.spans(SimpleNamespace(profiles=[SimpleNamespace(steps=2)]))]
    assert names.count("step") == names.count("data.gather") == names.count("prefetch.pin") == 2


def test_no_spans_no_span_metrics(monkeypatch):
    import sys

    profile = SimpleNamespace(steps=5)
    run = SimpleNamespace(steps=10, window_s=1.0, waits=[], flops_per_step=0.0, sites=[], element_bytes=2,
                          profiles=[profile])
    monkeypatch.setitem(sys.modules, "cips_tpu_torch.profiling", None)  # a program that records no spans
    assert _spans.spans(run) is None
    assert _spans.host_ms_per_step(run, "step") is None and _spans.device_ms_per_step(run, "step.g_forward") is None
