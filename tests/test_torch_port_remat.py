"""Remat and ``d_remat`` in the port: a step with them equals the step without.

The JAX package's ``remat`` (its models' block-level ``nn.remat``) and
``d_remat`` (``jax.checkpoint`` around the frozen D and LPIPS in the G step)
trade a forward for activation memory and leave the result as it is; the
port's are ``torch.utils.checkpoint`` around the same blocks. Each of the
flagship's, the causal trio's and BMGAN's steps runs twice on the CPU in fp32
from the same seeded weights and batch, once with remat and ``d_remat`` and
once without: the losses, every gradient and every updated parameter must
agree to 1e-6 of their scale (the recomputed forwards repeat the same
operations; here they agree bit for bit). The steps without remat are held to
the JAX package's in tests/test_torch_port_train.py, test_torch_port_causal.py
and test_torch_port_bmgan.py; the depth-sharded case is in
tests/test_torch_port_space.py.
"""

import numpy as np
import pytest
import torch

from cips_tpu_torch.models import bmgan, blocks
from cips_tpu_torch.models.atten_unet import AttenUNet
from cips_tpu_torch.training import bmgan_task, causal_task, unet_synthesis
from test_cli_workloads import TINY_CAUSAL_CFG
from test_torch_port_bmgan import SHAPE as BMGAN_SHAPE
from test_torch_port_bmgan import _tiny_build
from test_torch_port_train import CFG, CROP, K

TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _batch(shape, k, seed=0, b=2):
    rng = np.random.default_rng(seed)
    t1 = rng.random((b, *shape, 1), np.float32)
    pet = np.clip(t1 * 0.8 + 0.1 * rng.random((b, *shape, 1), np.float32), 0, 1)
    return {"t1": torch.from_numpy(t1), "pet": torch.from_numpy(pet),
            "info": torch.from_numpy(rng.random((b, 1, k), np.float32))}


def _assert_same(got: dict, want: dict, label: str) -> None:
    assert got.keys() == want.keys(), label
    for name, w in want.items():
        scale = max(w.abs().max().item(), 1e-12)
        assert (got[name] - w).abs().max().item() <= TOL * scale, f"{label} {name}"


def _grads(*models) -> dict:
    return {f"{i}.{n}": p.grad.clone() for i, m in enumerate(models) for n, p in m.named_parameters()
            if p.grad is not None}


def _params(*models) -> dict:
    return {f"{i}.{n}": p.detach().clone() for i, m in enumerate(models) for n, p in m.named_parameters()}


def _marked(model: torch.nn.Module) -> list:
    return [type(m).__name__ for m in model.modules() if getattr(m, "remat", False)]


def test_remat_policies_and_marked_blocks():
    g, _, _ = unet_synthesis.build_models(CFG, K, dtype=torch.float32, device="cpu", remat=True,
                                          remat_policy="conv12")
    assert sorted(set(_marked(g))) == ["DownBlock", "MidBlock", "UpBlock"]  # JAX's block-level remat
    enc, t1_dec, pet_dec, _, _ = causal_task.build_models(TINY_CAUSAL_CFG, 5, dtype=torch.float32, device="cpu",
                                                         remat=True)
    assert set(_marked(enc)) == {"ResnetBlock"} and set(_marked(pet_dec)) == {"ResnetBlock"}  # attention outside
    assert set(_marked(t1_dec)) == {"ResnetBlock"}
    plain, _, _ = unet_synthesis.build_models(CFG, K, dtype=torch.float32, device="cpu")
    assert not _marked(plain)  # off by default
    with pytest.raises(ValueError, match="remat policy"):
        AttenUNet(num_channels=(8, 8), attention_levels=(False, False), norm_num_groups=8, remat=True,
                  remat_policy="everything")
    assert set(blocks.REMAT_POLICIES) == {"conv", "conv12", "conv2", "conv_all"}


def _flagship_step(remat: bool):
    cfg = dict(CFG, training=dict(CFG["training"], d_remat=remat))
    g, d, _ = unet_synthesis.build_models(cfg, K, dtype=torch.float32, device="cpu", seed=3, remat=remat)
    with torch.no_grad():  # the zero-initialised output conv would leave most first-step gradients 0
        g.out[2].conv.weight.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(1))
    state = unet_synthesis.init_state(g, d, cfg["training"])
    metrics = unet_synthesis.make_train_step(cfg["training"])(state, _batch(CROP, K))
    return metrics, {**_params(g, d), **{f"grad {k}": v for k, v in _grads(g, d).items()}}


def test_flagship_step_with_remat_and_d_remat_equals_the_plain_step():
    (got_m, got_p), (want_m, want_p) = _flagship_step(True), _flagship_step(False)
    _assert_same({k: v.reshape(1) for k, v in got_m.items()}, {k: v.reshape(1) for k, v in want_m.items()},
                 "metrics")
    _assert_same(got_p, want_p, "gradients and updated parameters")
    init = _flagship_init()
    assert any(not torch.equal(got_p[k], init[k]) for k in init)


def _flagship_init():
    g, d, _ = unet_synthesis.build_models(CFG, K, dtype=torch.float32, device="cpu", seed=3)
    return _params(g, d)


def test_d_remat_reads_the_environment(monkeypatch):
    from cips_tpu_torch.training.common import d_remat_from

    assert not d_remat_from({})
    monkeypatch.setenv("CIPS_D_REMAT", "1")
    assert d_remat_from({}) and not d_remat_from({"d_remat": False})


def _causal_step(remat: bool):
    cfg = dict(TINY_CAUSAL_CFG, training=dict(TINY_CAUSAL_CFG["training"], perceptual_weight=0.5, d_remat=remat))
    enc, t1_dec, pet_dec, disc, perc = causal_task.build_models(cfg, 5, dtype=torch.float32, device="cpu", seed=4,
                                                                remat=remat)
    state = causal_task.init_state(enc, t1_dec, pet_dec, disc, perc, cfg["training"])
    step = causal_task.make_train_step(cfg["training"])
    metrics = step(state, _batch((8, 16, 8), 5, seed=1), torch.Generator().manual_seed(2))
    return metrics, {**_params(state.gen, disc), **{f"grad {k}": v for k, v in _grads(state.gen, disc).items()}}


def test_causal_step_with_remat_and_d_remat_equals_the_plain_step():
    (got_m, got_p), (want_m, want_p) = _causal_step(True), _causal_step(False)
    assert want_m["p_loss"].item() > 0  # the LPIPS call ran under d_remat
    _assert_same({k: v.reshape(1) for k, v in got_m.items()}, {k: v.reshape(1) for k, v in want_m.items()},
                 "metrics")
    _assert_same(got_p, want_p, "gradients and updated parameters")


def _bmgan_step(remat: bool):
    g, e, d, p = _tiny_build(dtype=torch.float32, device="cpu", seed=5)
    g.remat = remat
    state = bmgan_task.init_state(g, e, d, p)
    batch = _batch(BMGAN_SHAPE, 1, seed=2)
    metrics = bmgan_task.make_train_step(latent_dim=8, d_remat=remat)(
        state, {"t1": batch["t1"], "pet": batch["pet"]}, torch.Generator().manual_seed(3))
    return metrics, {**_params(g, e, d), **{f"grad {k}": v for k, v in _grads(g, e, d).items()}}


def test_bmgan_step_with_remat_and_d_remat_equals_the_plain_step():
    (got_m, got_p), (want_m, want_p) = _bmgan_step(True), _bmgan_step(False)
    _assert_same({k: v.reshape(1) for k, v in got_m.items()}, {k: v.reshape(1) for k, v in want_m.items()},
                 "metrics")
    _assert_same(got_p, want_p, "gradients and updated parameters")
    g = bmgan.DenseUNetGenerator(input_conv_channel=4, output_conv_channel=4, down_channels=(4,), middle_channels=4,
                                 up_channels=(4, 4), remat=True, remat_policy="conv_all")
    assert g.remat
    with pytest.raises(ValueError, match="remat policy"):
        bmgan.DenseUNetGenerator(remat_policy="conv99")
