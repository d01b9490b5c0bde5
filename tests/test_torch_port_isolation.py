"""The PyTorch port stands alone: no JAX, no JAX package, no silent CPU fallback."""

import ast
import pathlib

import pytest
import torch

import cips_tpu_torch
from cips_tpu_torch.cli import metrics, output_predict, postprocess, preprocess
from cips_tpu_torch.data import preprocess as data_preprocess
from cips_tpu_torch.eval import pair_metrics

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
            "probe_phase_conv.py", "classifier_task.py", "train_classifier.py", "test_mci.py", "classification.py",
            "bmgan.py", "bmgan_task.py", "train_bmgan.py", "gen_test_bmgan.py", "unet3d.py", "volume.py",
            "resample.py", "registration.py", "suvr.py", "mgz.py", "segmentation.py", "preprocess.py",
            "pair_metrics.py", "cohort.py", "metrics.py", "postprocess.py"} <= names


def test_runtime_and_utils_are_the_ports_own():
    scanned = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"cips_tpu_torch/runtime/native.py", "cips_tpu_torch/runtime/__init__.py",
            "cips_tpu_torch/utils/__init__.py", "cips_tpu_torch/data/torch_import.py",
            "cips_tpu_torch/cli/import_torch_ckpt.py"} <= scanned
    # the runtime builds its own copy of the C++ source, never the JAX package's
    from cips_tpu_torch.runtime import native

    assert pathlib.Path(native.SOURCE).resolve() == ROOT / "cips_tpu_torch" / "runtime" / "nifti_loader.cpp"
    # utils re-exports the port's counterpart of every name the JAX package's utils re-exports
    jax_utils = ast.parse((ROOT / "cips_tpu" / "utils" / "__init__.py").read_text(encoding="utf-8"))
    names = {alias.asname or alias.name for node in ast.walk(jax_utils) if isinstance(node, ast.ImportFrom)
             for alias in node.names}
    import cips_tpu_torch.utils as utils

    assert names and names <= set(dir(utils))
    for name in names:
        obj = getattr(utils, name)
        home = obj.__name__ if isinstance(obj, type(utils)) else obj.__module__
        assert home.startswith("cips_tpu_torch."), (name, home)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        cips_tpu_torch.default_device()
    with pytest.raises(RuntimeError):
        cips_tpu_torch.default_device("cuda")
    assert cips_tpu_torch.default_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        cips_tpu_torch.default_device("mps")
    # the tool-chain's device-bearing entry points
    for fn, args in ((data_preprocess.register_pet_to_t1, ("p", "t", "o")),
                     (data_preprocess.create_t1_downsample, ("t", "o")),
                     (data_preprocess.joint_register, (None, None, None)),
                     (pair_metrics.folder_pair_metrics, ("r",))):
        with pytest.raises(RuntimeError):
            fn(*args)


def test_cli_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        output_predict.main(["--exp_dir", str(tmp_path)])
    d = str(tmp_path)
    for main, argv in (
        (metrics.main, ["--root", d]),
        (postprocess.main, ["suvr", "--pet_dir", d, "--seg_dir", d, "--out_csv", d + "/s.csv"]),
        (preprocess.main, ["reg", "--PET_dir", d, "--T1_dir", d, "--out_dir", d]),
        (preprocess.main, ["downsample", "--T1_dir", d, "--out_dir", d]),
    ):
        with pytest.raises(RuntimeError):
            main(argv)
        main(argv + ["--device", "cpu"])  # asked for by name, the CPU runs (an empty tree: nothing to do)
