"""Every cell, configuration, traffic mix, model family and per-layer metric
is found by its name, and BENCHMARK.json names only what the folder holds."""

import importlib
import json
import os

import pytest

from portbench import harness

ROOT = os.path.dirname(harness.PKG)


def benchmark():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def test_every_workload_has_its_cell_config_and_traffic():
    bench = benchmark()
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cell, cfg, traffic = harness.cell_parts(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"] and cell["chips"] == w["chips"]
        assert configs[w["config"]]["file"] == f"portbench/configs/{w['config']}.json"
        assert importlib.import_module(f"portbench.tasks.{cfg['family']}").REFERENCE.family == cfg["family"]
        assert "output" in cell["limits"]
        assert all(k in {"loss", "grad", "change", "output", "replicas"} or k.startswith(("grad_sign.", "leaf_sign."))
                   for k in cell["limits"])
        assert int(traffic["subjects"]) // int(traffic["batch"]) >= harness.CHECK_STEPS


def test_every_per_layer_metric_has_a_reader():
    bench = benchmark()
    readers = harness.names("metrics", ".py")
    assert sorted(m["name"] for m in bench["per_layer"]) == readers
    for name in readers:
        mod = importlib.import_module(f"portbench.metrics.{name}")
        assert callable(mod.read) and mod.UNIT == next(m["unit"] for m in bench["per_layer"] if m["name"] == name)


@pytest.mark.parametrize("kind,suffix", [("cells", ".json"), ("configs", ".json"), ("traffic", ".json")])
def test_names_are_the_files(kind, suffix):
    found = harness.names(kind, suffix)
    assert found and all(os.path.exists(os.path.join(harness.PKG, kind, n + suffix)) for n in found)


def test_a_reader_that_finds_nothing_returns_none():
    from types import SimpleNamespace

    empty = SimpleNamespace(steps=0, window_s=1.0, waits=[], flops_per_step=0.0, sites=[], element_bytes=2,
                            profiles=[])
    for name in harness.names("metrics", ".py"):
        assert importlib.import_module(f"portbench.metrics.{name}").read(empty) is None
