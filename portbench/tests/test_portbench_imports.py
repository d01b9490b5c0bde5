"""Nothing the benchmark runs loads JAX or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's), and the
reference loads nothing of the program."""

import os
import subprocess
import sys

from portbench import harness

ROOT = os.path.dirname(harness.PKG)
sys.path.insert(0, os.path.join(ROOT, "portbench"))


def _fresh(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", f"import sys; sys.path.insert(0, {ROOT!r}); {code}"],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip()


def test_whole_top_level_names(monkeypatch):
    import run

    for name in ("cips_tpu_torch", "cips_tpu_torch.models", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.loaded_forbidden() == []
    for name in ("cips_tpu.models", "jaxlib.xla", "optax"):
        monkeypatch.setitem(sys.modules, name, object())
    assert {"cips_tpu", "jaxlib", "optax"} <= set(run.loaded_forbidden())


def test_the_harness_and_the_program_it_drives_load_no_jax():
    got = _fresh("import portbench.run as r, portbench.harness, portbench.calibrate, portbench.tasks.flagship, "
                 "portbench.tasks.causal, portbench.feeds.packed; import cips_tpu_torch.training.unet_synthesis, "
                 "cips_tpu_torch.training.causal_task, cips_tpu_torch.data.dataset, cips_tpu_torch.parallel.mesh, "
                 "cips_tpu_torch.training.common; print(r.loaded_forbidden())")
    assert got == "[]"


def test_the_reference_loads_nothing_of_the_program():
    got = _fresh("import portbench.reference.train, portbench.reference.lpips, portbench.roofline, portbench.check; "
                 "print(sorted({m.split('.')[0] for m in sys.modules} & {'cips_tpu_torch', 'cips_tpu', 'jax'}))")
    assert got == "[]"
