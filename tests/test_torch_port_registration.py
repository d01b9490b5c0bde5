"""The port's rigid registration (cips_tpu_torch/ops/registration.py) against
the JAX package's, on the same seeded numpy inputs, on the CPU.

Limits, relative to max |JAX value| unless stated:
  * losses (NCC, MI; masked and not): 1e-5 against JAX's fp32 value;
  * their gradients with respect to the six params: 1e-5 against the JAX
    function's exact gradient (JAX in float64), and against JAX's fp32 gradient
    within 1e-5 plus JAX's own distance from that exact gradient: XLA's fp32
    sums sit up to 1.7e-5 from it at these inputs, the port's 2e-6 (measured on
    the CPU), so the fp32 pair cannot be held closer than JAX's own rounding;
  * Adam: one optax step to 1e-6; one level of 5 steps to 1e-5;
  * whole registrations (three pyramid levels, 100 steps each): every param
    within one Adam step of the last level, lr / 3 (`TOL_PARAMS`). Adam moves
    a param by at most about lr a step (|mu_hat / sqrt(nu_hat)| stays near 1 or
    under), and near the optimum it circles it at about that amplitude, where
    the trilinear loss has kinks at voxel borders: two fp32 runs that part by
    rounding end up about one step apart at most. Measured on the CPU: 5.6e-5
    at most here (MI); runs cut short part by more (the physical cases,
    tests/test_torch_port_registration_physical.py, show JAX against itself). The warped volume must beat the unregistered
    one's masked correlation and reach 0.99, for JAX's result and the port's.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cips_tpu.ops import registration as jax_reg
from cips_tpu.ops import resample as jax_resample
from cips_tpu_torch.ops import registration as port_reg
from cips_tpu_torch.ops import resample as port_resample

TOL_F32 = 1e-5
LR = 0.05
PYRAMID = (4, 2, 1)
TOL_PARAMS = LR / len(PYRAMID)  # one Adam step of the last level


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


def t(x, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(dtype)


def _blob(shape, center, sigma):
    g = np.stack(np.meshgrid(*[np.arange(n) for n in shape], indexing="ij"), -1).astype(np.float64)
    return np.exp(-((g - center) ** 2).sum(-1) / (2 * sigma * sigma))


SHAPE = (16, 20, 16)
FIXED = (_blob(SHAPE, (8, 10, 8), 4) + 0.5 * _blob(SHAPE, (5, 12, 9), 2)
         + 0.01 * np.random.default_rng(0).random(SHAPE)).astype(np.float32)
MOVING = (_blob(SHAPE, (8.7, 9.4, 8.5), 4) + 0.5 * _blob(SHAPE, (5.8, 11.5, 9.3), 2)).astype(np.float32)
MASK = (FIXED > 0.1).astype(np.float32)
CENTER = np.array([7.5, 9.5, 7.5], np.float32)
P0 = np.array([0.05, -0.03, 0.02, 0.3, -0.4, 0.2], np.float32)


def _jax_loss(metric, mask):
    fn = jax_reg.ncc_loss if metric == "ncc" else jax_reg.mutual_information_loss

    def loss(p, moving, fixed, center):
        warped = jax_resample.affine_warp(moving, jax_resample.rigid_matrix(p, center), out_shape=fixed.shape)
        return fn(warped, fixed, mask=None if mask is None else jnp.asarray(mask))

    return loss


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", ["ncc", "mi"])
def test_losses_and_grads_match_jax(metric, masked):
    mask = MASK if masked else None
    jloss = _jax_loss(metric, mask)
    want_loss, want_grad = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(P0), jnp.asarray(MOVING),
                                                              jnp.asarray(FIXED), jnp.asarray(CENTER))
    with jax.enable_x64(True):
        exact_grad = np.asarray(jax.jit(jax.grad(jloss))(*(jnp.asarray(a, jnp.float64)
                                                           for a in (P0, MOVING, FIXED, CENTER))))
    assert exact_grad.dtype == np.float64

    p = t(P0).requires_grad_(True)
    fn = port_reg.ncc_loss if metric == "ncc" else port_reg.mutual_information_loss
    warped = port_resample.affine_warp(t(MOVING), port_resample.rigid_matrix(p, t(CENTER)), out_shape=SHAPE)
    loss = fn(warped, t(FIXED), mask=None if mask is None else t(mask))
    (grad,) = torch.autograd.grad(loss, p)

    assert rel_err(float(loss.detach()), float(want_loss)) <= TOL_F32
    assert rel_err(grad.numpy(), exact_grad) <= TOL_F32
    jax_own = rel_err(np.asarray(want_grad), exact_grad)
    assert rel_err(grad.numpy(), np.asarray(want_grad)) <= TOL_F32 + jax_own, jax_own


def test_adam_step_matches_optax():
    rng = np.random.default_rng(1)
    p, g1, g2 = (rng.standard_normal(6).astype(np.float32) for _ in range(3))
    tx = optax.adam(LR)
    state = tx.init(jnp.asarray(p))
    want = jnp.asarray(p)
    got, mu, nu = t(p), torch.zeros(6), torch.zeros(6)
    for step, g in enumerate((g1, g2), start=1):
        updates, state = tx.update(jnp.asarray(g), state, want)
        want = optax.apply_updates(want, updates)
        got, mu, nu = port_reg.adam_update(got, t(g), mu, nu, step, LR)
        assert rel_err(got.numpy(), np.asarray(want)) <= 1e-6


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", ["ncc", "mi"])
def test_one_level_of_five_steps_matches_jax(metric, masked):
    mask = MASK if masked else None
    want_p, want_loss = jax_reg._register_level(jnp.asarray(MOVING), jnp.asarray(FIXED), jnp.asarray(P0), metric, 5,
                                                LR, mask=None if mask is None else jnp.asarray(mask))
    got_p, got_loss = port_reg._register_level(t(MOVING), t(FIXED), t(P0), metric, 5, LR,
                                               mask=None if mask is None else t(mask))
    assert rel_err(got_p.numpy(), np.asarray(want_p)) <= TOL_F32
    assert rel_err(float(got_loss), float(want_loss)) <= TOL_F32


def test_rotation_seeds_match_jax():
    for n in (1, 3, 13):
        assert rel_err(port_reg._rotation_seeds(n).numpy(), np.asarray(jax_reg._rotation_seeds(n))) == 0.0


def _masked_corr(a, b, mask):
    a, b = np.asarray(a)[mask], np.asarray(b)[mask]
    a, b = a - a.mean(), b - b.mean()
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum() + 1e-9))


@pytest.mark.parametrize("n_starts", [1, 3])
@pytest.mark.parametrize("metric", ["ncc", "mi"])
def test_register_rigid_matches_jax(metric, n_starts):
    want = jax_reg.register_rigid(jnp.asarray(MOVING), jnp.asarray(FIXED), metric=metric, pyramid=PYRAMID, lr=LR,
                                  n_starts=n_starts)
    got = port_reg.register_rigid(t(MOVING), t(FIXED), metric=metric, pyramid=PYRAMID, lr=LR, n_starts=n_starts)
    assert np.abs(got.params.numpy() - np.asarray(want.params)).max() <= TOL_PARAMS
    assert rel_err(got.loss, want.loss) <= 1e-4
    mask = FIXED > 0.1
    before = _masked_corr(MOVING, FIXED, mask)
    for name, res in (("jax", want), ("port", got)):
        warped = port_reg.apply_transform(t(MOVING), t(np.asarray(res.matrix)), out_shape=SHAPE).numpy()
        assert _masked_corr(warped, FIXED, mask) > max(before, 0.99), name


def test_apply_transform_nearest_matches_jax():
    labels = np.random.default_rng(2).integers(0, 5, SHAPE).astype(np.float32)
    m = np.asarray(jax_resample.rigid_matrix(jnp.asarray(P0), jnp.asarray(CENTER)))
    want = np.asarray(jax_reg.apply_transform(jnp.asarray(labels), jnp.asarray(m), out_shape=(14, 18, 16), nearest=True))
    got = port_reg.apply_transform(t(labels), t(m), out_shape=(14, 18, 16), nearest=True).numpy()
    assert np.array_equal(got, want)
