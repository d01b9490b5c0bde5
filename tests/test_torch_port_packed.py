"""The port's default training data path, the packed float16 store, against the
JAX package's on the CPU.

Without ``--streaming`` both packages pack every pair once into a float16
store and train on batches read back from it. On one fabricated tree the
port's default loaders must give the JAX package's default batches bit for bit.
The JAX side decodes with its numpy path, which the port's native runtime equals
bit for bit (JAX's own C++ copy normalises by a reciprocal, an ulp apart).
"""

import argparse
import json
import os

import numpy as np
import pytest

from cips_tpu.cli import common as jax_common
from cips_tpu.data import dataset as jax_dataset
from cips_tpu_torch.cli import common, train_unet
from cips_tpu_torch.data import nifti
from cips_tpu_torch.data.dataset import BatchLoader, PackedDataset, PairedVolumeDataset, StreamingLoader, pack_pairs

AV45 = ["ABETA", "Age", "Sex", "APOE4", "PTEDUCAT"]
CROP = (12, 16, 12)
TINY_UNET_CFG = {
    "atten_unet_def": {
        "spatial_dims": 3, "in_channels": 1, "out_channels": 1, "num_channels": [8, 8], "num_res_blocks": 1,
        "attention_levels": [False, True], "norm_num_groups": 8, "resblock_updown": True, "num_head_channels": [0, 4],
    },
    "discriminator": {"num_channels": 8, "num_layers_d": 2},
    "training": {"base_lr": 1e-3, "disc_lr": 1e-4, "perceptual_weight": 0, "adv_weight": 0.1},
}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Seven subjects {t1,pet}/{Subject}/{date}/img.nii.gz of (14, 18, 14), with
    values whose fp16 rounding is not exact; train (7) and eval (3) manifests
    with AV45 covariates and their stats."""
    root = tmp_path_factory.mktemp("packed_tree")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(7):
        subj = f"s{i:03d}"
        for kind, date in (("t1", "2012-01-01"), ("pet", "2012-01-15")):
            vol = rng.random((14, 18, 14)) * (1.0 + i) + 0.01
            nifti.write(str(root / kind / subj / date / "img.nii.gz"), vol.astype(np.float32))
        rows.append(f"{subj},2012-01-01,2012-01-15,{500 + 150 * i},{70 + i},{'Female' if i % 2 else 'Male'},"
                    f"{i % 3},{12 + i}")
    header = "Subject,T1_date,PET_date," + ",".join(AV45)
    (root / "train.csv").write_text("\n".join([header] + rows) + "\n")
    (root / "test.csv").write_text("\n".join([header] + rows[:3]) + "\n")
    (root / "stats.json").write_text(json.dumps({"ABETA": [200, 1700], "Age": [55, 95], "PTEDUCAT": [6, 20]}))
    (root / "cfg.json").write_text(json.dumps(TINY_UNET_CFG))
    return root


def _args(root, exp_dir, *extra) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    common.add_common_data_args(p)
    p.add_argument("--exp_dir")
    return p.parse_args([
        "--training_info_csv", str(root / "train.csv"), "--eval_info_csv", str(root / "test.csv"),
        "--PET_dir", str(root / "pet"), "--T1_dir", str(root / "t1"), "--min_and_max", str(root / "stats.json"),
        "--crop_size", *map(str, CROP), "--batch_size", "2", "--seed", "3", "--exp_dir", str(exp_dir), *extra,
    ])


@pytest.fixture
def jax_numpy_decode(monkeypatch):
    monkeypatch.setattr(jax_dataset, "_native", lambda: None)


def _assert_same_batches(got_loader, want_loader, epochs, n_batches):
    for epoch in epochs:
        got, want = list(got_loader.epoch(epoch)), list(want_loader.epoch(epoch))
        assert len(got) == len(want) == n_batches
        for a, b in zip(got, want):
            assert a.keys() == b.keys() == {"t1", "pet", "info"}
            for key in a:
                assert a[key].dtype == b[key].dtype == np.float32 and a[key].shape == b[key].shape, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"epoch {epoch} {key}")


def test_default_loaders_equal_jax_default_batches_bit_for_bit(tree, tmp_path, jax_numpy_decode):
    got = common.make_loaders(_args(tree, tmp_path / "port"), AV45)
    want = jax_common.make_loaders(_args(tree, tmp_path / "jax"), AV45)
    assert all(isinstance(loader, BatchLoader) for loader in got)
    _assert_same_batches(got[0], want[0], (0, 1), 3)  # 7 pairs at batch 2, the short last batch dropped
    _assert_same_batches(got[1], want[1], (0,), 3)  # eval: batch 1, in order, every subject
    train = next(iter(got[0].epoch(0)))
    assert np.array_equal(train["t1"], train["t1"].astype(np.float16).astype(np.float32))  # trained on fp16 values
    for tag in ("train", "eval"):
        for name in ("volumes.npy", "covariates.npy"):
            a, b = np.load(tmp_path / "port" / f"packed_{tag}" / name), np.load(tmp_path / "jax" / f"packed_{tag}" / name)
            assert a.dtype == b.dtype and np.array_equal(a, b), (tag, name)
        assert (json.loads((tmp_path / "port" / f"packed_{tag}" / "index.json").read_text())
                == json.loads((tmp_path / "jax" / f"packed_{tag}" / "index.json").read_text()))


def test_random_crop_equals_jax_bit_for_bit(tree, tmp_path, jax_numpy_decode):
    crop = ["--random_crop_size", "8", "12", "10"]
    got = common.make_loaders(_args(tree, tmp_path / "port", *crop), AV45)
    want = jax_common.make_loaders(_args(tree, tmp_path / "jax", *crop), AV45)
    _assert_same_batches(got[0], want[0], (0, 1), 3)
    batch = next(iter(got[0].epoch(0)))
    assert batch["t1"].shape == (2, 8, 12, 10, 1)
    assert np.allclose(batch["pet"].max(axis=(1, 2, 3, 4)), 1.0)  # each crop re-max-normalised
    _assert_same_batches(got[1], want[1], (0,), 3)  # eval stays center-cropped
    assert next(iter(got[1].epoch(0)))["t1"].shape == (1, *CROP, 1)


@pytest.mark.parametrize("packer", ["jax", "port"])
def test_a_store_packed_by_either_package_loads_in_the_other(tree, tmp_path, jax_numpy_decode, packer):
    stats = json.loads((tree / "stats.json").read_text())
    kw = dict(pet_dir=str(tree / "pet"), t1_dir=str(tree / "t1"), crop_size=CROP, need_values=AV45, min_and_max=stats)
    store = str(tmp_path / "store")
    if packer == "jax":
        jax_dataset.pack_pairs(jax_dataset.PairedVolumeDataset(str(tree / "train.csv"), **kw), store)
    else:
        pack_pairs(PairedVolumeDataset(str(tree / "train.csv"), **kw), store)
    port_store, jax_store = PackedDataset(store), jax_dataset.PackedDataset(store)
    assert len(port_store) == len(jax_store) == 7 and port_store.need_values == AV45
    assert port_store.index == jax_store.index
    for opts in (dict(seed=5), dict(shuffle=False, drop_last=False), dict(seed=1, process_index=1, process_count=2),
                 dict(seed=2, random_crop_size=(6, 8, 6))):
        got, want = BatchLoader(port_store, 3, **opts), jax_dataset.BatchLoader(jax_store, 3, **opts)
        assert got.steps_per_epoch() == want.steps_per_epoch()
        _assert_same_batches(got, want, (0, 2), want.steps_per_epoch())


def test_packed_dirs_are_reused_and_streaming_selects_the_streaming_loader(tree, tmp_path):
    args = _args(tree, tmp_path / "exp", "--packed_dir", str(tmp_path / "p"), "--eval_packed_dir",
                 str(tmp_path / "pe"))
    common.make_loaders(args, AV45)
    assert not (tmp_path / "exp" / "packed_train").exists()
    volumes = np.load(tmp_path / "p" / "volumes.npy", mmap_mode="r+")
    volumes[:] = 0.5  # a store that exists is read, not packed again
    volumes.flush()
    del volumes
    train, evaluate = common.make_loaders(args, AV45)
    assert all(np.all(b["t1"] == 0.5) for b in train.epoch(0))
    assert not np.all(next(iter(evaluate.epoch(0)))["t1"] == 0.5)
    train, evaluate = common.make_loaders(_args(tree, tmp_path / "s", "--streaming"), AV45)
    assert isinstance(train, StreamingLoader) and isinstance(evaluate, StreamingLoader)
    assert not (tmp_path / "s").exists()
    # the streaming crop (tests/test_torch_port_classifier.py holds its batches to JAX's): training only
    train, evaluate = common.make_loaders(_args(tree, tmp_path / "s", "--streaming", "--random_crop_size", "8", "8",
                                                "8"), AV45)
    assert train.dataset.random_crop_size == (8, 8, 8) and evaluate.dataset.random_crop_size is None
    assert next(iter(train.epoch(0)))["t1"].shape[1:4] == (8, 8, 8)


def test_train_unet_takes_the_packed_flags(tree, tmp_path):
    exp = tmp_path / "exp"
    state = train_unet.main([
        "--exp_dir", str(exp), "--config", str(tree / "cfg.json"), "--training_info_csv", str(tree / "train.csv"),
        "--eval_info_csv", str(tree / "test.csv"), "--PET_dir", str(tree / "pet"), "--T1_dir", str(tree / "t1"),
        "--min_and_max", str(tree / "stats.json"), "--use_condition", "--dtype", "f32", "--device", "cpu",
        "--batch_size", "2", "--epochs", "1", "--crop_size", *map(str, CROP), "--random_crop_size", "12", "16", "12",
        "--packed_dir", str(tmp_path / "p"), "--eval_packed_dir", str(tmp_path / "pe"),
    ])
    assert state.step == 3
    assert os.path.exists(tmp_path / "p" / "volumes.npy") and os.path.exists(tmp_path / "pe" / "volumes.npy")
    assert np.load(tmp_path / "p" / "volumes.npy").dtype == np.float16
    rec = nifti.read_array(str(exp / "conditional" / "AV45" / "visual" / "epoch0_rec.nii.gz"))
    assert rec.shape == CROP and np.isfinite(rec).all()
