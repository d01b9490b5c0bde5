"""The PyTorch port's serving path against the JAX package on the CPU.

`cips_tpu_torch.cli.output_predict` (``--device cpu``) and the JAX package's
`predict_dataset` run the same weights over the same tiny NIfTI tree; the
metrics and the written ``rec.nii.gz`` must agree. The pieces the path runs
(dataset, brain mask, metrics, checkpoints) are held to their JAX
counterparts one by one as well.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cips_tpu.data import covariates as jax_covariates
from cips_tpu.data.dataset import PairedVolumeDataset as JaxDataset
from cips_tpu.inference.predict import predict_dataset as jax_predict_dataset
from cips_tpu.ops import masking as jax_masking
from cips_tpu.ops import metrics as jax_metrics
from cips_tpu.training import unet_synthesis as jax_synthesis
from cips_tpu_torch.cli import output_predict
from cips_tpu_torch.data import covariates, nifti
from cips_tpu_torch.data.dataset import PairedVolumeDataset
from cips_tpu_torch.data.jax_params import from_jax_params
from cips_tpu_torch.inference.predict import predict_dataset
from cips_tpu_torch.ops import masking, metrics
from cips_tpu_torch.training.common import CheckpointManager

AV45 = ["ABETA", "Age", "Sex", "APOE4", "PTEDUCAT"]
CROP = (8, 16, 8)
MODEL_CFG = {
    "atten_unet_def": {
        "spatial_dims": 3, "in_channels": 1, "out_channels": 1, "num_channels": [8, 16, 16],
        "num_res_blocks": 2, "attention_levels": [False, False, True], "norm_num_groups": 4,
        "norm_eps": 1e-6, "resblock_updown": True, "num_head_channels": [0, 0, 8],
        "with_conditioning": True, "transformer_num_layers": 1, "upcast_attention": False,
    },
    "discriminator": {"spatial_dims": 3, "num_channels": 8, "num_layers_d": 1},
    "perceptual_network": {"spatial_dims": 3},
    "training": {"base_lr": 1e-3, "disc_lr": 1e-4, "perceptual_weight": 0, "adv_weight": 0.1},
}


def _head(shape, rng, radius=0.75):
    """A bright blob with noise on a dim background: a volume with a clear brain mask."""
    grids = np.meshgrid(*(np.linspace(-1, 1, s) for s in shape), indexing="ij")
    blob = np.clip(1.0 - sum(g**2 for g in grids) / radius**2, 0.0, None)
    return (blob * (1.0 + 0.2 * rng.standard_normal(shape)) + 0.02 * rng.random(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """{t1,pet}/{Subject}/{date}/img.nii.gz (larger than the crop: pad/crop runs),
    a manifest with AV45 covariates and their stats."""
    root = tmp_path_factory.mktemp("tree")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(3):
        subj = f"s{i:03d}"
        for kind, date in (("t1", "2012-01-01"), ("pet", "2012-01-15")):
            nifti.write(str(root / kind / subj / date / "img.nii.gz"), _head((12, 18, 10), rng, 0.7 + 0.05 * i))
        rows.append([subj, "2012-01-01", "2012-01-15", 500 + 150 * i, 70 + i, "Female" if i % 2 else "Male", i % 3, 12 + i])
    with open(root / "test.csv", "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["Subject", "T1_date", "PET_date"] + AV45)
        w.writerows(rows)
    (root / "stats.json").write_text(json.dumps({"ABETA": [200, 1700], "Age": [55, 95], "PTEDUCAT": [6, 20]}))
    return {"csv": str(root / "test.csv"), "stats": str(root / "stats.json"),
            "t1": str(root / "t1"), "pet": str(root / "pet")}


def _dataset_args(tree):
    stats = covariates.load_min_and_max(tree["stats"])
    return dict(info_csv=tree["csv"], pet_dir=tree["pet"], t1_dir=tree["t1"], crop_size=CROP,
                need_values=AV45, min_and_max=stats)


def test_cli_matches_jax_predict_dataset(tree, tmp_path):
    # fp32 end to end on the CPU; the model measures ~1e-6 relative against JAX
    # (test_torch_port_unet.py), the metrics and mask are fp32 too.
    generator, _, _ = jax_synthesis.build_models(MODEL_CFG, n_covariates=5, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    x, ctx = jnp.zeros((1, *CROP, 1)), jnp.zeros((1, 1, 5))
    shapes = jax.eval_shape(generator.init, jax.random.key(0), x, ctx)
    params = jax.tree_util.tree_map(lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32), shapes)
    predict = jax.jit(jax_synthesis.make_predict_fn(generator, use_condition=True))
    jax_dir = str(tmp_path / "jax")
    want = jax_predict_dataset(
        lambda batch: predict(params, batch), JaxDataset(**_dataset_args(tree)), output_dir=jax_dir, batch_size=2
    ).summary()

    exp_dir = tmp_path / "exp"
    state = from_jax_params(params, 3)
    ckpt = CheckpointManager(str(exp_dir / "conditional" / "AV45" / "ckpt"))
    ckpt.save({"unet": {f"module.{k}": v for k, v in state.items()}, "discriminator": {}, "epoch": 3}, epoch=3)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(MODEL_CFG))
    port_dir = str(tmp_path / "port")
    got = output_predict.main([
        "--exp_dir", str(exp_dir), "--config", str(cfg_path), "--eval_info_csv", tree["csv"],
        "--PET_dir", tree["pet"], "--T1_dir", tree["t1"], "--min_and_max", tree["stats"],
        "--crop_size", *map(str, CROP), "--batch_size", "2", "--use_condition", "--dtype", "f32",
        "--device", "cpu", "--output_dir", port_dir,
    ]).summary()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)
    assert np.isfinite(list(got.values())).all()
    recs = sorted(os.path.relpath(os.path.join(d, f), port_dir) for d, _, fs in os.walk(port_dir) for f in fs)
    assert len(recs) == 6  # rec + ori per subject
    for rel in recs:
        a = nifti.read_array(os.path.join(port_dir, rel))
        b = nifti.read_array(os.path.join(jax_dir, rel))
        assert a.shape == CROP
        np.testing.assert_allclose(a, b, atol=1e-5 * max(np.abs(b).max(), 1e-6), rtol=0, err_msg=rel)


@pytest.mark.parametrize("mask_mode", ["self", "none"])
def test_predict_dataset_mask_modes_match_jax(tree, tmp_path, mask_mode):
    # The T1 itself stands in for the synthesized volume, so only the
    # post-processing (renormalise + self mask, or nothing) is compared.
    want = jax_predict_dataset(
        lambda batch: batch["t1"], JaxDataset(**_dataset_args(tree)), output_dir=str(tmp_path / "jax"),
        mask_mode=mask_mode, write_ori=False, batch_size=2,
    ).summary()
    got = predict_dataset(
        lambda batch: batch["t1"], PairedVolumeDataset(**_dataset_args(tree)), "cpu",
        output_dir=str(tmp_path / "port"), mask_mode=mask_mode, batch_size=2,
    ).summary()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-7, err_msg=key)
    assert len(list((tmp_path / "port").rglob("ori.nii.gz"))) == 3
    with pytest.raises(ValueError):
        predict_dataset(lambda b: b["t1"], PairedVolumeDataset(**_dataset_args(tree)), "cpu", mask_mode="real_t1")


def test_dataset_matches_jax(tree):
    port, ref = PairedVolumeDataset(**_dataset_args(tree)), JaxDataset(**_dataset_args(tree))
    assert len(port) == len(ref) == 3
    for i in range(len(port)):
        a, b = port[i], ref[i]
        np.testing.assert_allclose(a.t1, b.t1, rtol=1e-6)
        np.testing.assert_allclose(a.pet, b.pet, rtol=1e-6)
        np.testing.assert_array_equal(a.info, b.info)
        assert (a.subject, a.t1_date, a.pet_date) == (b.subject, b.t1_date, b.pet_date)
    # resize_size resizes as JAX's (jax.image.resize, linear), no longer raising
    port, ref = (cls(**_dataset_args(tree), resize_size=(4, 8, 4)) for cls in (PairedVolumeDataset, JaxDataset))
    for i in range(len(port)):
        for field in ("t1", "pet"):
            a, b = getattr(port[i], field), getattr(ref[i], field)
            assert a.shape == b.shape == (4, 8, 4)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())


@pytest.mark.parametrize("key,raw", [("Sex", "Female"), ("Sex", "M"), ("ABETA", "<200"), ("ABETA", ">1700"),
                                     ("Age", "71.5"), ("Age", ""), ("PTEDUCAT", "nan"), ("APOE4", "x")])
def test_encode_value_matches_jax(key, raw):
    assert covariates.encode_value(key, raw) == jax_covariates.encode_value(key, raw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_brain_mask_matches_jax(seed):
    # Expected to be exact. The histograms may differ only if a voxel lies on
    # a bin edge that jnp.histogram and torch.histc compute in another order.
    vol = _head((20, 28, 24), np.random.default_rng(seed))
    np.testing.assert_allclose(
        masking.otsu_threshold(torch.from_numpy(vol)).item(),
        float(jax_masking.otsu_threshold(jnp.asarray(vol))), rtol=1e-6,
    )
    got = masking.get_mask(torch.from_numpy(vol)).numpy()
    want = np.asarray(jax_masking.get_mask(jnp.asarray(vol)))
    assert got.sum() > 0
    np.testing.assert_array_equal(got, want)
    t1 = vol - 0.5
    np.testing.assert_array_equal(
        masking.mask_by_t1(torch.from_numpy(vol), torch.from_numpy(t1)).numpy(),
        np.asarray(jax_masking.mask_by_t1(jnp.asarray(vol), jnp.asarray(t1))),
    )


@pytest.mark.parametrize("kernel_size,sigma", [(5, 0.5), (11, 1.5)])
def test_metrics_match_jax(kernel_size, sigma):
    # fp32; the port's separable filter sums shifted slices where JAX runs a
    # convolution, so only summation order differs.
    rng = np.random.default_rng(3)
    a = _head((40, 48, 40), rng)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), 0, None)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(metrics.mae(ta, tb).item(), float(jax_metrics.mae(ja, jb)), rtol=1e-5)
    np.testing.assert_allclose(metrics.psnr(ta, tb).item(), float(jax_metrics.psnr(ja, jb)), rtol=1e-5)
    np.testing.assert_allclose(
        metrics.ssim(ta, tb, kernel_size, sigma).item(), float(jax_metrics.ssim(ja, jb, kernel_size, sigma)), rtol=1e-4
    )
    np.testing.assert_allclose(
        metrics.ms_ssim(ta, tb, kernel_size, sigma).item(),
        float(jax_metrics.ms_ssim(ja, jb, kernel_size, sigma)), rtol=1e-4,
    )


def test_checkpoint_manager_contract(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    with pytest.raises(FileNotFoundError):
        ckpt.restore()
    for epoch, metric in ((0, 0.5), (1, 0.3), (2, 0.4)):
        ckpt.save({"unet": {"module.w": torch.full((2,), float(epoch))}, "discriminator": {}, "epoch": epoch},
                  epoch, eval_metric=metric)
    meta = json.loads((tmp_path / "ckpt" / "meta.json").read_text())
    assert meta == {"last_epoch": 2, "best_metric": 0.3, "best_epoch": 1}
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["best", "epoch_0", "epoch_1", "epoch_2", "meta.json"]
    assert ckpt.restore()["unet"]["w"][0] == 2
    assert ckpt.restore(best=True)["unet"]["w"][0] == 1
    assert ckpt.restore(epoch=0)["epoch"] == 0
