"""The PyTorch port's BMGAN baseline and UnetGenerator3d against the JAX package on the CPU.

A tiny BMGAN (tests/test_workloads.py's: generator stem 4 channels, down (4, 8),
middle 8, up (8, 4, 4); encoder stem 4, units (4, 8); discriminator
num_layers_d 1) at a (16, 16, 16) volume. Every parameter is drawn from a
seeded numpy generator and carried to the port with the `jax_params`
converters. The JAX models run with their default space-to-depth packing and
unpacked (same parameters, same function); the port computes the unpacked
function. Everything is fp32. The latent that JAX draws is fed to the port
through `bmgan_task.sample_latent`.

Limits. The generator's instance norms at its coarsest levels normalise 8 and
64 voxels, which amplifies fp32 rounding: against an fp64 forward of the same
weights the port's fp32 generator is 2.6e-5 of max|out| off and JAX's
1.6e-4 (unpacked; 3.2e-5 packed). So the generator is held to JAX at 3e-4 of
max|out| and to its own fp64 forward at 1e-4; the encoder and the
discriminator to JAX at 1e-5. A train step's gradients inherit that rounding
and amplify it (an L1 or activation kink on either side of a near-tie, and
these random networks' norms over few voxels): against JAX's packed step each
network's whole gradient measured up to 6.2e-3 off in the 2-norm (E's, after an
exact_d_fake step, whose fake comes from G's updated weights), so the limit is
1e-2 per network, relative in the 2-norm; the step's metrics are held to 1e-4.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cips_tpu.data.torch_import import import_bmgan_encoder, import_bmgan_generator
from cips_tpu.models.bmgan import BMGANDiscriminator as JaxD
from cips_tpu.models.bmgan import DenseUNetGenerator as JaxG
from cips_tpu.models.bmgan import ResNetEncoder as JaxE
from cips_tpu.models.perceptual import PerceptualLoss as JaxPerceptualLoss
from cips_tpu.models.unet3d import UnetGenerator3d as JaxUnet3d
from cips_tpu.training import bmgan_task as jax_bmgan
from cips_tpu.training.common import TrainState
from cips_tpu.training.common import adam as jax_adam
from cips_tpu_torch.cli import gen_test_bmgan, train_bmgan
from cips_tpu_torch.data import nifti
from cips_tpu_torch.data.jax_params import (
    bmgan_discriminator_from_jax_params,
    bmgan_encoder_from_jax_params,
    bmgan_generator_from_jax_params,
    perceptual_from_jax_params,
    unet3d_from_jax_params,
)
from cips_tpu_torch.models import bmgan
from cips_tpu_torch.models import perceptual as lpips
from cips_tpu_torch.models.unet3d import UnetGenerator3d
from cips_tpu_torch.training import bmgan_task
from cips_tpu_torch.training.common import init_models
from test_torch_port_causal import _adam_grads, _close, _np_tree, _random_tree

SHAPE = (16, 16, 16)
G_KW = dict(input_conv_channel=4, output_conv_channel=4, down_channels=(4, 8), middle_channels=8,
            up_channels=(8, 4, 4))
E_KW = dict(input_layer_channel=4, channels=(4, 8))
TOL_G_JAX = 3e-4
TOL_G_F64 = 1e-4
TOL_GRAD_NORM = 1e-2
LR = 2e-4



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread for this module: its tensors are tiny, and a full
    intra-op pool in each of the suite's parallel workers oversubscribes the
    cores (a 3 s test took 250 s that way)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _port_models(dtype=torch.float32):
    with torch.device("meta"):
        models = (bmgan.DenseUNetGenerator(dtype=dtype, **G_KW),
                  bmgan.ResNetEncoder(input_shape=SHAPE, dtype=dtype, **E_KW),
                  bmgan.BMGANDiscriminator(num_layers_d=1, dtype=dtype),
                  lpips.PerceptualLoss(spatial_dims=3, network_type="alex", dtype=dtype))
    return init_models(models, bmgan.init_params, "cpu")


def _identity_norms(tree):
    """The flax tree with every instance norm's scale 1 and bias 0 (the reference's affine-free norms)."""

    def fix(path, a):
        names = [p.key for p in path]
        norm = any("norm" in n for n in names[:-1])
        if norm and names[-1] == "scale":
            return np.ones_like(a)
        if norm and names[-1] == "bias":
            return np.zeros_like(a)
        return a

    return jax.tree_util.tree_map_with_path(fix, tree)


@pytest.fixture(scope="module")
def nets():
    """The JAX models (packed and unpacked), their random params, and a batch."""
    x, z = jnp.zeros((1, *SHAPE, 1)), jnp.zeros((1, 8))
    jax_models = {s2d: (JaxG(s2d=s2d, **G_KW), JaxE(s2d=s2d, **E_KW)) for s2d in (True, False)}
    d, p = JaxD(num_layers_d=1), JaxPerceptualLoss(spatial_dims=3, network_type="alex")
    g, e = jax_models[False]
    rng = np.random.default_rng(0)
    key = jax.random.key(0)
    params = {"g": _random_tree(jax.eval_shape(g.init, key, x, z), rng),
              "e": _random_tree(jax.eval_shape(e.init, key, x), rng),
              "d": _random_tree(jax.eval_shape(d.init, key, x), rng),
              "p": _random_tree(jax.eval_shape(p.init, key, x, x), rng)}
    return {"models": jax_models, "d": d, "p": p, "params": params}


def _batch(rng, b=2):
    t1 = rng.random((b, *SHAPE, 1), np.float32)
    return {"t1": t1, "pet": np.clip(t1 * 0.8 + 0.1 * rng.random((b, *SHAPE, 1), np.float32), 0, 1)}


def _load(models, params):
    g, e, d, p = models
    g.load_state_dict(bmgan_generator_from_jax_params(params["g"]))
    e.load_state_dict(bmgan_encoder_from_jax_params(params["e"]))
    d.load_state_dict(bmgan_discriminator_from_jax_params(params["d"], 1))
    p.load_state_dict(perceptual_from_jax_params(params["p"]))
    return models


@pytest.mark.parametrize("s2d", [True, False], ids=["packed", "unpacked"])
def test_forwards_match_jax(nets, s2d):
    jg, je = nets["models"][s2d]
    params = nets["params"]
    rng = np.random.default_rng(1)
    x = rng.random((2, *SHAPE, 1), np.float32)
    z = rng.standard_normal((2, 8)).astype(np.float32)
    g, e, d, _ = _load(_port_models(), params)
    g64 = bmgan.DenseUNetGenerator(dtype=torch.float64, **G_KW)
    g64.load_state_dict(g.state_dict())
    want = np.asarray(jax.jit(jg.apply)(params["g"], x, z))
    with torch.no_grad():
        got = g(torch.from_numpy(x), torch.from_numpy(z)).numpy()
        f64 = g64(torch.from_numpy(x).double(), torch.from_numpy(z).double()).numpy()
        _close(got, want, rel=TOL_G_JAX, msg="generator vs JAX")
        _close(got, f64, rel=TOL_G_F64, msg="generator vs its fp64 forward")
        assert want.std() > 0.05
        for got_t, want_t, name in zip(e(torch.from_numpy(x)), jax.jit(je.apply)(params["e"], x), ("mu", "log_var")):
            _close(got_t.numpy(), want_t, msg=name)
        _close(d(torch.from_numpy(x)).numpy(), jax.jit(nets["d"].apply)(params["d"], x), msg="discriminator")
        with pytest.raises(ValueError, match="multiple of 8"):  # 3 halvings and 3 doublings
            g(torch.zeros((1, 12, 16, 16, 1)), torch.from_numpy(z[:1]))


def _assert_flax_equal(back, want):
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_back[path], leaf, err_msg=jax.tree_util.keystr(path))


def test_converters_round_trip_through_the_jax_importers(nets):
    # flax -> port -> the reference's names -> flax. The reference's norms carry no
    # affine, so the trip is exact only for identity norms; the port keeps JAX's
    # trained ones under names the importers do not read.
    params = nets["params"]
    for convert, importer, tree in ((bmgan_generator_from_jax_params, import_bmgan_generator, params["g"]),
                                    (bmgan_encoder_from_jax_params, import_bmgan_encoder, params["e"])):
        identity = _identity_norms(tree)
        state = convert(identity)
        _assert_flax_equal(importer({k: v.numpy() for k, v in state.items()}), identity["params"])
        trained = convert(tree)
        norms = [k for k in trained if not torch.equal(trained[k], state[k])]
        assert norms and all(".adn.N." in k or k.split(".")[-2].isdigit() for k in norms)
    g, e, d, _ = _port_models()
    for model, tree in ((g, params["g"]), (e, params["e"])):
        assert set(model.state_dict()) == set(bmgan_generator_from_jax_params(tree) if model is g
                                              else bmgan_encoder_from_jax_params(tree))
    assert set(d.state_dict()) == set(bmgan_discriminator_from_jax_params(params["d"], 1))
    # the linear heads: flax flattens channels-last, the reference channels-first
    w = bmgan_encoder_from_jax_params(params["e"])["linear1.weight"].numpy()
    flax_w = np.asarray(params["e"]["params"]["mu"]["kernel"]).T.reshape(8, 4 * 4 * 4, 8)
    np.testing.assert_array_equal(w.reshape(8, 8, 64), flax_w.transpose(0, 2, 1))


def _assert_grads_close(model: torch.nn.Module, want: dict, msg: str) -> None:
    """The network's whole gradient (every tensor, concatenated) within
    TOL_GRAD_NORM of JAX's, relative in the 2-norm (module doc)."""
    got = torch.cat([p.grad.flatten() for _, p in model.named_parameters()])
    ref = torch.cat([want[name].flatten() for name, _ in model.named_parameters()])
    err = ((got - ref).norm() / ref.norm()).item()
    assert err <= TOL_GRAD_NORM, f"{msg}: {err:.3e} of |grad|"


def _feed_latents(monkeypatch, draws):
    queue = list(draws)

    def fed(shape, dtype, device, generator):
        z = torch.from_numpy(np.array(queue.pop(0)))
        assert tuple(z.shape) == tuple(shape)
        return z.to(device, dtype)

    monkeypatch.setattr(bmgan_task, "sample_latent", fed)


@pytest.mark.parametrize("exact_d_fake,lamda_perceptual", [(False, 8.0), (True, 0.0)])
def test_train_step_matches_jax_over_three_steps(nets, monkeypatch, exact_d_fake, lamda_perceptual):
    # Three G, E and D steps of JAX's step (packed: its forward is the nearer to
    # fp64) and the port's on three batches, JAX's latents fed to the port, each
    # step from JAX's parameters (the port's Adam moments run on). The metrics
    # within 1e-4 relative; each step's G, E and D gradients (JAX's read back from
    # its Adam moments) within TOL_GRAD_NORM; after the last step the parameters
    # within 2 lr.
    jg, je = nets["models"][True]
    params = nets["params"]
    jax_step = jax.jit(jax_bmgan.make_train_step(jg, je, nets["d"], nets["p"], lamda_perceptual=lamda_perceptual,
                                                 exact_d_fake=exact_d_fake))
    jax_state = jax_bmgan.BMGANState(
        g=TrainState.create(params["g"], jax_adam(LR)), e=TrainState.create(params["e"], jax_adam(LR)),
        d=TrainState.create(params["d"], jax_adam(LR)), p_params=params["p"], step=jnp.zeros((), jnp.int32))
    state = bmgan_task.init_state(*_load(_port_models(), params), lr=LR, perceptual_weight=lamda_perceptual)
    step = bmgan_task.make_train_step(lamda_perceptual=lamda_perceptual, exact_d_fake=exact_d_fake)
    converters = (("g", bmgan_generator_from_jax_params), ("e", bmgan_encoder_from_jax_params),
                  ("d", lambda t: bmgan_discriminator_from_jax_params(t, 1)))
    rng = np.random.default_rng(2)
    for i in range(3):
        for part, convert in converters:
            getattr(state, part).load_state_dict(convert(_np_tree(getattr(jax_state, part).params)))
        batch = _batch(rng)
        key = jax.random.key(100 + i)
        new_state, want = jax_step(jax_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        grads = {part: _adam_grads(getattr(new_state, part), getattr(jax_state, part)) for part in "ged"}
        jax_state = new_state
        _feed_latents(monkeypatch, [np.asarray(jax.random.normal(key, (2, 8), jnp.float32))])
        got = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator())
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-7, err_msg=f"step {i} {k}")
        assert lamda_perceptual == 0 or float(got["p_loss"]) > 0
        for part, convert in converters:
            _assert_grads_close(getattr(state, part), convert(grads[part]), f"step {i} {part}")
    assert state.step == int(jax_state.step) == 3
    for part, convert in converters:
        want = convert(_np_tree(getattr(jax_state, part).params))
        for name, p in getattr(state, part).state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=2 * LR, rtol=0, err_msg=f"{part} {name}")


def test_eval_step_matches_jax(nets, monkeypatch):
    jg, _ = nets["models"][True]
    params = nets["params"]
    batch = _batch(np.random.default_rng(3), b=1)
    key = jax.random.key(7)
    jax_state = jax_bmgan.BMGANState(g=TrainState.create(params["g"], jax_adam(LR)), e=None, d=None, p_params=None,
                                     step=0)
    want = jax.jit(jax_bmgan.make_eval_step(jg))(jax_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    state = bmgan_task.init_state(*_load(_port_models(), params), perceptual_weight=0.0)
    assert state.perceptual is None
    _feed_latents(monkeypatch, [np.asarray(jax.random.normal(key, (1, 8), jnp.float32))] * 2)
    got = bmgan_task.make_eval_step()(state, {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator())
    np.testing.assert_allclose(float(got["l1_loss"]), float(want["l1_loss"]), rtol=1e-4)
    _close(got["fake"].numpy(), want["fake"], rel=TOL_G_JAX, msg="fake")
    generated = bmgan_task.make_generate_fn(state.g)({"t1": torch.from_numpy(batch["t1"])}, torch.Generator())
    _close(generated.numpy(), got["fake"].numpy(), rel=0, msg="generate is the eval step's fake")


@pytest.mark.parametrize("num_downs", [3, 5])
def test_unet_generator_3d_matches_jax(num_downs):
    jax_model = JaxUnet3d(num_downs=num_downs, ngf=4)
    rng = np.random.default_rng(4)
    x = rng.random((2, 32, 32, 32, 1), np.float32)
    params = _random_tree(jax.eval_shape(jax_model.init, jax.random.key(0), x), rng)
    model = UnetGenerator3d(num_downs=num_downs, ngf=4)
    model.load_state_dict(unet3d_from_jax_params(params))
    want = jax.jit(jax_model.apply)(params, x)
    with torch.no_grad():
        _close(model(torch.from_numpy(x)).numpy(), want, msg=f"num_downs {num_downs}")
    assert np.asarray(want).std() > 0.05


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Four subjects of (18, 18, 18) (pad/crop runs), a training manifest of all
    four and a test manifest of the last two."""
    root = tmp_path_factory.mktemp("bmgan_tree")
    rng = np.random.default_rng(0)
    lines = ["Subject,T1_date,PET_date"]
    for i in range(4):
        subj = f"s{i}"
        for kind, date in (("t1", "2012-01-01"), ("pet", "2012-01-20")):
            nifti.write(str(root / kind / subj / date / "img.nii.gz"), rng.random((18, 18, 18)).astype(np.float32))
        lines.append(f"{subj},2012-01-01,2012-01-20")
    (root / "train.csv").write_text("\n".join(lines) + "\n")
    (root / "test.csv").write_text("\n".join(lines[:1] + lines[3:]) + "\n")
    return root


def _tiny_build(dtype=torch.bfloat16, latent_dim=8, input_shape=SHAPE, device=None, seed=0):
    with torch.device("meta"):
        models = (bmgan.DenseUNetGenerator(dtype=dtype, **G_KW),
                  bmgan.ResNetEncoder(input_shape=input_shape, dtype=dtype, **E_KW),
                  bmgan.BMGANDiscriminator(num_layers_d=1, dtype=dtype),
                  lpips.PerceptualLoss(spatial_dims=3, network_type="alex", dtype=dtype))
    return init_models(models, bmgan.init_params, device, seed)


def _args(root, *extra):
    return ["--training_info_csv", str(root / "train.csv"), "--eval_info_csv", str(root / "test.csv"),
            "--PET_dir", str(root / "pet"), "--T1_dir", str(root / "t1"), "--crop_size", *map(str, SHAPE),
            "--dtype", "f32", *extra]


def test_bmgan_clis_end_to_end_on_cpu(tree, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(bmgan_task, "build_models", _tiny_build)
    exp = str(tmp_path / "exp")
    args = _args(tree, "--exp_dir", exp, "--batch_size", "2", "--save_every", "1", "--device", "cpu")
    state = train_bmgan.main(args + ["--epochs", "2"])
    assert state.step == 4 and state.perceptual is not None  # 4 subjects at batch 2
    assert os.path.exists(os.path.join(exp, "packed_train", "volumes.npy"))  # the default, packed loader
    meta = json.loads(open(os.path.join(exp, "ckpt", "meta.json"), encoding="utf-8").read())
    assert meta["last_epoch"] == 1 and np.isfinite(meta["best_metric"])
    resumed = train_bmgan.main(args + ["--epochs", "3", "--resume"])
    assert resumed.step == 6 and resumed.opt_e.state_dict()["state"][0]["step"].item() == 6
    saved = torch.load(os.path.join(exp, "ckpt", "epoch_2"), weights_only=True)
    assert {"generator", "encoder", "discriminator", "perceptual", "optimizer_g", "optimizer_e",
            "optimizer_d"} <= set(saved)
    records = [json.loads(line) for line in open(os.path.join(exp, "log", "metrics.jsonl"), encoding="utf-8")]
    assert [r["prefix"] for r in records] == ["eval"] * 3 and all(np.isfinite(r["l1_loss"]) for r in records)
    assert capsys.readouterr().out.count(" eval l1 ") == 3

    out = tmp_path / "gen"
    results = gen_test_bmgan.main(_args(tree, "--exp_dir", exp, "--device", "cpu", "--best", "--output_dir",
                                        str(out)))
    assert all(np.isfinite(v) for v in results.summary().values())
    recs = sorted(out.rglob("rec.nii.gz"))
    assert len(recs) == 2 and not list(out.rglob("ori.nii.gz"))
    for path in recs:
        rec = nifti.read_array(str(path))
        assert rec.shape == SHAPE and np.abs(rec).max() <= 1 and rec.std() > 0


def test_bmgan_clis_need_cuda_unless_asked(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (train_bmgan.main, gen_test_bmgan.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(_args(tree, "--exp_dir", str(tmp_path / "exp")))
