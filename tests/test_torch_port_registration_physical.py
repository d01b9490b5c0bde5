"""The port's physical-space rigid registration (`register_rigid_physical`)
against the JAX package's, on tests/test_registration_geometry.py's ADNI-like
case: a phantom in mm, oblique anisotropic headers, a shifted PET field of
view, a bias field, noise and a true rigid motion (4 degrees, 3-4 mm).

`_make_case(k)` builds that case with every grid k times coarser (k = 1 is the
JAX test's own (56, 64, 56) T1 and (26, 52, 52) PET). Limits:
  * the header-only pull-back (no step): 1e-5 relative to max |JAX matrix|;
  * params: within one Adam step of the last level, lr / 2, for runs of JAX's
    length that reach the optimum (120 steps a level; the reasoning is in
    tests/test_torch_port_registration.py). On the CPU they part by 1.2e-4 at
    k = 1 and by 1.2e-6 (NCC) to 1.7e-3 (MI) at k = 3.5. Runs cut short are
    still in flight and part by more: at k = 3.5, 20 MI steps a level part by
    0.03 and a 3-start MI run of 60 by 0.07. That is the optimiser, not the
    port: JAX against itself on the PET scaled by (1 + 2^-22) parts by 0.006
    and 0.077 on those runs (each level's first Adam steps are about lr x the
    sign of the gradient, so a component near 0 takes a full step either way);
  * the JAX test's recovery checks at its own size, for JAX's result and the
    port's: masked correlation above the header-only one by 0.01 and above
    0.93, the largest rotation between 0.01 and 0.2 rad. (At k = 3.5 the coarse
    grid caps the correlation near 0.6 for both, so only the parity is held there.)
  * chip_smoke's tool-chain subject 1 ((-6, -3, 4) degrees, (-5, -3, 2) mm) at
    1/4 of the phase's size, at the defaults (pyramid (4, 2, 1), 100 steps a
    level): JAX's result and the port's both under the 0.93 recovery limit
    (`-s` prints them), their params within one Adam step of the last level,
    lr / 3. The defaults' capture range at that size is the JAX package's; the
    phase holds the port to the recovery checks on this motion at full size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cips_tpu.ops import registration as jax_reg
from cips_tpu_torch.ops import registration as port_reg

LR = 0.05
TOL_PARAMS = LR / 2  # one Adam step of the last level, pyramid (2, 1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _phantom(coords_zyx):
    z, y, x = coords_zyx[..., 0], coords_zyx[..., 1], coords_zyx[..., 2]
    r2 = (z / 22.0) ** 2 + (y / 28.0) ** 2 + (x / 24.0) ** 2
    val = 0.6 * np.exp(-np.maximum(r2 - 0.75, 0.0) / 0.05)
    for (cz, cy, cx), s, a in (((0.0, 8.0, -6.0), 7.0, 0.9), ((5.0, -10.0, 4.0), 5.0, 0.7),
                               ((-8.0, 2.0, 9.0), 4.0, 1.0)):
        val = val + a * np.exp(-((z - cz) ** 2 + (y - cy) ** 2 + (x - cx) ** 2) / (2 * s * s))
    return (val + 0.8 * np.exp(-((r2 - 0.75) ** 2) / 0.02)).astype(np.float32)


def _rot_xyz(rx, ry, rz):
    cx, sx, cy, sy, cz, sz = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry), np.cos(rz), np.sin(rz)
    return (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]]) @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))


def _affine(spacing_xyz, rot, center_xyz):
    """Voxel -> mm with the grid's center voxel at the origin."""
    a = np.eye(4)
    a[:3, :3] = rot @ np.diag(spacing_xyz)
    a[:3, 3] = -a[:3, :3] @ center_xyz
    return a


def _grid_physical(shape_zyx, affine_xyz, motion=np.eye(4)):
    zz, yy, xx = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape_zyx], indexing="ij")
    phys = np.stack([xx, yy, zz, np.ones_like(xx)], axis=-1) @ affine_xyz.T @ motion.T
    return np.stack([phys[..., 2], phys[..., 1], phys[..., 0]], axis=-1)


def _make_case(k, motion_deg=4.0, motion_mm=(3.0, -2.0, 2.5), seed=0):
    rng = np.random.default_rng(seed)
    t1_shape = tuple(int(round(s / k)) for s in (56, 64, 56))
    t1_aff = _affine([s * k for s in (1.0, 1.0, 1.2)], _rot_xyz(*np.deg2rad([2.0, -1.5, 1.0])),
                     (np.array(t1_shape[::-1]) - 1) / 2)
    t1 = _phantom(_grid_physical(t1_shape, t1_aff))
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, s) for s in t1_shape], indexing="ij")
    t1 = t1 * np.exp(0.25 * (0.8 * xx + 0.5 * yy - 0.4 * zz)) + rng.normal(0, 0.01, t1_shape)
    pet_shape = tuple(int(round(s / k)) for s in (26, 52, 52))
    pet_aff = _affine([s * k for s in (1.2, 1.2, 2.4)], _rot_xyz(*np.deg2rad([-1.0, 2.0, -2.5])),
                      (np.array(pet_shape[::-1]) - 1) / 2)
    motion = np.eye(4)
    motion[:3, :3] = _rot_xyz(*np.deg2rad([motion_deg, -motion_deg / 2, motion_deg / 1.5]))
    motion[:3, 3] = motion_mm
    pet = _phantom(_grid_physical(pet_shape, pet_aff, motion)) + rng.normal(0, 0.01, pet_shape)
    return t1.astype(np.float32), t1_aff, pet.astype(np.float32), pet_aff


def _masked_corr(a, b, mask):
    a, b = np.asarray(a)[mask], np.asarray(b)[mask]
    a, b = a - a.mean(), b - b.mean()
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum() + 1e-9))


def _both(pet, t1, pet_aff, t1_aff, **run):
    want = jax_reg.register_rigid_physical(jnp.asarray(pet), jnp.asarray(t1), pet_aff, t1_aff, **run)
    got = port_reg.register_rigid_physical(t(pet), t(t1), pet_aff, t1_aff, **run)
    return want, got


@pytest.mark.parametrize("run", [dict(), dict(n_starts=3), dict(metric="mi")], ids=["ncc", "ncc-3-starts", "mi"])
def test_register_rigid_physical_matches_jax_reduced(run):
    t1, t1_aff, pet, pet_aff = _make_case(3.5)
    assert t1.shape == (16, 18, 16) and pet.shape == (7, 15, 15)
    header = _both(pet, t1, pet_aff, t1_aff, pyramid=(2,), iters_per_level=0)
    want_m = np.asarray(header[0].matrix)
    assert np.abs(header[1].matrix.numpy() - want_m).max() <= 1e-5 * np.abs(want_m).max()
    want, got = _both(pet, t1, pet_aff, t1_aff, pyramid=(2, 1), iters_per_level=120, **run)
    assert np.abs(got.params.numpy() - np.asarray(want.params)).max() <= TOL_PARAMS


def test_register_rigid_physical_recovers_adni_like_motion():
    t1, t1_aff, pet, pet_aff = _make_case(1.0)
    mask = t1 > 0.2
    header = port_reg.register_rigid_physical(t(pet), t(t1), pet_aff, t1_aff, pyramid=(2,), iters_per_level=0)
    base = _masked_corr(port_reg.apply_transform(t(pet), header.matrix, out_shape=t1.shape).numpy(), t1, mask)
    want, got = _both(pet, t1, pet_aff, t1_aff, pyramid=(2, 1), iters_per_level=120)
    assert np.abs(got.params.numpy() - np.asarray(want.params)).max() <= TOL_PARAMS
    for name, res in (("jax", want), ("port", got)):
        warped = port_reg.apply_transform(t(pet), t(np.asarray(res.matrix)), out_shape=t1.shape).numpy()
        corr = _masked_corr(warped, t1, mask)
        assert corr > base + 0.01 and corr > 0.93, (name, corr, base)
        assert 0.01 < float(np.abs(np.asarray(res.params[:3])).max()) < 0.2, name


def test_default_capture_range_matches_jax():
    case = chip_smoke.toolchain_case(1, "cpu", 4)
    assert case["t1"].shape == (42, 64, 64) and case["pet"].shape == (24, 40, 40)
    mask = case["t1"] > 0.2
    want, got = _both(case["pet"], case["t1"], *case["headers"][::-1])
    assert np.abs(got.params.numpy() - np.asarray(want.params)).max() <= LR / 3
    for name, res in (("jax", want), ("port", got)):
        warped = port_reg.apply_transform(t(case["pet"]), t(np.asarray(res.matrix)), out_shape=case["t1"].shape)
        corr = _masked_corr(warped.numpy(), case["t1"], mask)
        print(f"subject 1 at 1/4 size, {name}: masked correlation {corr:.5f}, params {np.asarray(res.params)}")
        assert corr < chip_smoke.TOOLCHAIN_MIN_CORR, (name, corr)
