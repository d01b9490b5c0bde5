"""The PyTorch port stands alone: no JAX, no JAX package, no silent CPU fallback."""

import ast
import pathlib

import pytest
import torch

import cips_tpu_torch
from cips_tpu_torch.cli import output_predict

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cips_tpu")
PORT_FILES = sorted((ROOT / "cips_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    # exact names or dotted prefixes: "cips_tpu_torch" is not "cips_tpu"
    return any(module == name or module.startswith(name + ".") for name in FORBIDDEN)


def test_forbidden_matches_exact_names_only():
    assert _forbidden("cips_tpu") and _forbidden("cips_tpu.data.nifti") and _forbidden("jax.numpy")
    assert not _forbidden("cips_tpu_torch") and not _forbidden("cips_tpu_torch.ops") and not _forbidden("jaxtyping_x")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__"
        ):
            imported += [a.value for a in node.args if isinstance(a, ast.Constant) and isinstance(a.value, str)]
    bad = [m for m in imported if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_has_files_to_scan():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "flash_attention.py", "output_predict.py", "atten_unet.py", "train_unet.py",
            "discriminator.py", "losses.py", "unet_synthesis.py", "s2d.py", "phase_conv.py", "cuda_library.py",
            "probe_phase_conv.py"} <= names


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        cips_tpu_torch.default_device()
    with pytest.raises(RuntimeError):
        cips_tpu_torch.default_device("cuda")
    assert cips_tpu_torch.default_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        cips_tpu_torch.default_device("mps")


def test_cli_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        output_predict.main(["--exp_dir", str(tmp_path)])
