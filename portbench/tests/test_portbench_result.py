"""The result line's keys, the comparison beside it, and the exits without a
card or without the program."""

import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = os.path.dirname(harness.PKG)


def test_the_result_line_keys(monkeypatch):
    import torch

    torch.set_num_threads(4)
    monkeypatch.setattr(harness, "PROFILE_STEPS", 1)
    lines = []
    result = harness.run("flagship.train.b4", 2**31 + 3, 0.0, True, "cpu",
                         overrides={"volume": [32, 32, 32], "subjects": 4, "batch": 2}, log=lines.append)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "check"]
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes", "busy_s", "window_s"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(result["check"]) == set(harness.load("cells", "flagship.train.b4")["limits"])
    assert all(set(v) == {"value", "limit"} for v in result["check"].values())
    n = len(result["check"])
    assert lines[-n:] == [f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in sorted(result["check"].items())]
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "portbench", "run.py"), "--workload",
                           "flagship.train.b4", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_no_program_no_result(tmp_path):
    shutil.copytree(harness.PKG, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys; sys.path.insert(0, '.'); from portbench import harness; "
            "print(harness.run('flagship.train.b4', 1, 0.0, False, 'cpu'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "cips_tpu_torch" in proc.stderr and proc.stdout == ""
