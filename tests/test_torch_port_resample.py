"""The port's volume, resampling, bias-correction, SUVR and slice-wise MS-SSIM ops
(cips_tpu_torch/ops/{volume,resample,registration,suvr,metrics}.py) against the
JAX package's, on the same seeded numpy inputs, on the CPU.

Limits are relative to max |JAX output|:
  * resizes, linear and nearest: 1e-6 (one separable fp32 pass an axis against
    JAX's einsum of the same weight matrices: only the order of the sums differs);
  * samplers, `affine_warp`, `rigid_matrix`, N4, `compute_suvr` and
    `resize_and_pad_pet_to_seg`: 1e-5 (fp32 coordinates and long sums);
  * `ms_ssim_2d_slicewise` at tests/test_msssim_parity.py's shapes: 1e-5.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cips_tpu.data import dataset as jax_dataset
from cips_tpu.data import nifti
from cips_tpu.ops import metrics as jax_metrics
from cips_tpu.ops import registration as jax_reg
from cips_tpu.ops import resample as jax_resample
from cips_tpu.ops import suvr as jax_suvr
from cips_tpu.ops import volume as jax_volume
from cips_tpu_torch.data import dataset as port_dataset
from cips_tpu_torch.ops import metrics as port_metrics
from cips_tpu_torch.ops import registration as port_reg
from cips_tpu_torch.ops import resample as port_resample
from cips_tpu_torch.ops import suvr as port_suvr
from cips_tpu_torch.ops import volume as port_volume

TOL_RESIZE = 1e-6
TOL_F32 = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread: small tensors, and a full intra-op pool in each of
    the suite's parallel workers oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


VOL = np.random.default_rng(0).random((16, 12, 8)).astype(np.float32)
RESIZES = {  # target shape of VOL (16, 12, 8)
    "down2": (8, 6, 4),
    "down4": (4, 3, 2),
    "to4cube": (4, 4, 4),
    "non_integer_down": (11, 7, 5),
    "mixed": (13, 12, 9),
    "up1.5": (24, 18, 12),
    "identity": (16, 12, 8),
}


@pytest.mark.parametrize("method", ["resize_trilinear", "resize_nearest"])
@pytest.mark.parametrize("name", list(RESIZES))
def test_resize_matches_jax(name, method):
    shape = RESIZES[name]
    want = np.asarray(getattr(jax_resample, method)(jnp.asarray(VOL), shape))
    got = getattr(port_resample, method)(t(VOL), shape).numpy()
    assert got.shape == want.shape == shape
    assert rel_err(got, want) <= TOL_RESIZE, (name, method, rel_err(got, want))


def test_resize_batched_leading_axes():
    x = np.random.default_rng(1).random((2, 3, 10, 9, 7)).astype(np.float32)
    want = np.asarray(jax_resample.resize_trilinear(jnp.asarray(x), (4, 6, 5)))
    assert rel_err(port_resample.resize_trilinear(t(x), (4, 6, 5)).numpy(), want) <= TOL_RESIZE


@pytest.mark.parametrize("name", ["down2", "down4", "to4cube", "non_integer_down"])
def test_plain_interpolate_is_not_jax_resize(name):
    """Why the port writes its own resize: `F.interpolate(mode="trilinear")` does
    not widen its kernel when shrinking (JAX antialiases), and misses by far
    more than the limit above."""
    shape = RESIZES[name]
    want = np.asarray(jax_resample.resize_trilinear(jnp.asarray(VOL), shape))
    plain = F.interpolate(t(VOL)[None, None], size=shape, mode="trilinear", align_corners=False)[0, 0].numpy()
    assert rel_err(plain, want) > 100 * TOL_RESIZE


def test_resample_spacing_matches_jax():
    x = np.random.default_rng(2).random((14, 20, 18)).astype(np.float32)
    for nearest in (False, True):
        want = np.asarray(jax_resample.resample_spacing(jnp.asarray(x), (1.2, 1.0, 1.0), (1.5, 1.5, 1.5), nearest))
        got = port_resample.resample_spacing(t(x), (1.2, 1.0, 1.0), (1.5, 1.5, 1.5), nearest).numpy()
        assert got.shape == want.shape and rel_err(got, want) <= TOL_RESIZE


def _coords(rng, shape, extent):
    """Coordinates reaching 1.5 voxels past every border, and exact half-voxels."""
    c = rng.random((3, *shape)) * (np.asarray(extent)[:, None, None, None] + 3.0) - 1.5
    c[:, 0, 0, :] = np.round(c[:, 0, 0, :] * 2) / 2  # half-integers: nearest rounds half to even
    return c.astype(np.float32)


@pytest.mark.parametrize("sampler", ["trilinear_sample", "nearest_sample"])
def test_samplers_match_jax(sampler):
    rng = np.random.default_rng(3)
    vol = rng.random((10, 12, 9)).astype(np.float32)
    coords = _coords(rng, (5, 6, 7), (10, 12, 9))
    for cval in (0.0, -0.5):
        want = np.asarray(getattr(jax_resample, sampler)(jnp.asarray(vol), jnp.asarray(coords), cval=cval))
        got = getattr(port_resample, sampler)(t(vol), t(coords), cval=cval).numpy()
        assert rel_err(got, want) <= TOL_F32


@pytest.mark.parametrize("nearest", [False, True])
def test_rigid_matrix_and_affine_warp_match_jax(nearest):
    rng = np.random.default_rng(4)
    vol = rng.random((10, 12, 9)).astype(np.float32)
    params = rng.normal(0, 0.2, 6).astype(np.float32)
    params[3:] *= 10
    center = np.array([4.5, 5.5, 4.0], np.float32)
    want_m = np.asarray(jax_resample.rigid_matrix(jnp.asarray(params), jnp.asarray(center)))
    got_m = port_resample.rigid_matrix(t(params), t(center)).numpy()
    assert rel_err(got_m, want_m) <= TOL_F32
    want = np.asarray(jax_resample.affine_warp(jnp.asarray(vol), jnp.asarray(want_m), (8, 14, 9), nearest=nearest))
    got = port_resample.affine_warp(t(vol), t(want_m), (8, 14, 9), nearest=nearest).numpy()
    assert rel_err(got, want) <= TOL_F32


def test_identity_grid_matches_jax():
    assert np.array_equal(port_resample.identity_grid((3, 4, 5)).numpy(),
                          np.asarray(jax_resample.identity_grid((3, 4, 5))))


@pytest.mark.parametrize("target", [(9, 12, 7), (13, 10, 5), (8, 11, 8)])
def test_volume_ops_match_jax(target):
    rng = np.random.default_rng(5)
    x = rng.random((2, 8, 11, 6)).astype(np.float32)
    want = np.asarray(jax_volume.pad_crop_to(jnp.asarray(x), target, spatial_axes=(1, 2, 3)))
    got = port_volume.pad_crop_to(t(x), target, spatial_axes=(1, 2, 3)).numpy()
    assert np.array_equal(got, want)


def test_n4_matches_jax():
    rng = np.random.default_rng(6)
    zz, yy, xx = np.meshgrid(*(np.linspace(-1, 1, s) for s in (20, 24, 18)), indexing="ij")
    img = (np.clip(1 - (zz**2 + yy**2 + xx**2), 0, None) * np.exp(0.3 * xx - 0.2 * zz)
           * (1 + 0.05 * rng.standard_normal(zz.shape))).astype(np.float32)
    want = np.asarray(jax_reg.n4_bias_correct(jnp.asarray(img)))
    got = port_reg.n4_bias_correct(t(img)).numpy()
    assert rel_err(got, want) <= TOL_F32


def test_suvr_ops_match_jax():
    rng = np.random.default_rng(7)
    seg = rng.choice([0, 3, 7, 8, 10, 11, 36, 42, 46, 47, 60, 120], size=(12, 14, 10)).astype(np.int32)
    pet = rng.random((12, 14, 10)).astype(np.float32)
    for labels in (jax_suvr.FASTSURFER_ROI, jax_suvr.IBEAT_ROI):
        assert np.array_equal(port_suvr.label_mask(t(seg), labels).numpy(),
                              np.asarray(jax_suvr.label_mask(jnp.asarray(seg), labels)))
    for roi, ref in ((jax_suvr.FASTSURFER_ROI, jax_suvr.FASTSURFER_REF), (jax_suvr.IBEAT_ROI, jax_suvr.IBEAT_REF)):
        want = float(jax_suvr.compute_suvr(jnp.asarray(pet), jnp.asarray(seg), roi, ref))
        assert rel_err(float(port_suvr.compute_suvr(t(pet), t(seg), roi, ref)), want) <= TOL_F32
    gt, synth = rng.random(9).astype(np.float32), rng.random(9).astype(np.float32)
    want_err = jax_suvr.suvr_abs_error(jnp.asarray(gt), jnp.asarray(synth))
    got_err = port_suvr.suvr_abs_error(t(gt), t(synth))
    for g, w in zip(got_err, want_err):
        assert rel_err(float(g), float(w)) <= 1e-6


@pytest.mark.parametrize("pet_shape,seg_shape", [((10, 12, 8), (20, 20, 20)), ((11, 13, 9), (21, 18, 16))])
def test_resize_and_pad_pet_to_seg_matches_jax(pet_shape, seg_shape):
    pet = np.random.default_rng(8).random(pet_shape).astype(np.float32)
    for reorient in (True, False):
        want = np.asarray(jax_suvr.resize_and_pad_pet_to_seg(jnp.asarray(pet), seg_shape, reorient=reorient))
        got = port_suvr.resize_and_pad_pet_to_seg(t(pet), seg_shape, reorient=reorient).numpy()
        assert got.shape == want.shape and rel_err(got, want) <= TOL_F32


def _vol_pair(shape, seed):
    rng = np.random.default_rng(seed)
    real = rng.random(shape).astype(np.float32)
    return real, np.clip(real + 0.15 * rng.standard_normal(shape).astype(np.float32), 0, 1)


@pytest.mark.parametrize("shape,k,sigma", [((24, 224, 192), 11, 1.5), ((24, 225, 191), 11, 1.5),
                                           ((96, 128, 96), 5, 0.5), ((6, 40, 36), 11, 1.5)])
def test_ms_ssim_2d_slicewise_matches_jax(shape, k, sigma):
    real, rec = _vol_pair(shape, 5)
    want = float(jax_metrics.ms_ssim_2d_slicewise(jnp.asarray(rec), jnp.asarray(real), k, sigma))
    got = float(port_metrics.ms_ssim_2d_slicewise(t(rec), t(real), k, sigma))
    assert rel_err(got, want) <= TOL_F32, (got, want)


def test_mean_intensity_match_matches_jax():
    real, rec = _vol_pair((8, 9, 10), 9)
    want = np.asarray(jax_metrics.mean_intensity_match(jnp.asarray(rec), jnp.asarray(real)))
    assert rel_err(port_metrics.mean_intensity_match(t(rec), t(real)).numpy(), want) <= 1e-6


def test_dataset_resize_size_matches_jax(tmp_path):
    rng = np.random.default_rng(10)
    rows = ["Subject,T1_date,PET_date"]
    for i in range(2):
        for kind, date in (("t1", "2015-01-01"), ("pet", "2015-02-01")):
            nifti.write(str(tmp_path / kind / f"s{i}" / date / "img.nii.gz"), rng.random((14, 18, 12)).astype(np.float32))
        rows.append(f"s{i},2015-01-01,2015-02-01")
    (tmp_path / "pairs.csv").write_text("\n".join(rows) + "\n")
    kwargs = dict(pet_dir=str(tmp_path / "pet"), t1_dir=str(tmp_path / "t1"), crop_size=(12, 16, 12),
                  resize_size=(8, 10, 7))
    want = jax_dataset.PairedVolumeDataset(str(tmp_path / "pairs.csv"), **kwargs)
    got = port_dataset.PairedVolumeDataset(str(tmp_path / "pairs.csv"), **kwargs)
    assert len(got) == len(want) == 2
    for i in range(2):
        for field in ("t1", "pet"):
            a, b = getattr(got[i], field), getattr(want[i], field)
            assert a.shape == b.shape == (8, 10, 7) and rel_err(a, b) <= TOL_RESIZE
