"""The PyTorch port's causal unified generator against the JAX package on the CPU.

The tiny causal config of tests/test_cli_workloads.py (`TINY_CAUSAL_CFG`:
2-level encoder with self-attending transformers at level 1, 2-level T1 and
PET decoders, the PET decoder cross-attending to K = 5 covariates at level 0)
at a (8, 16, 8) crop. Every parameter is drawn from a seeded numpy generator,
the zero-initialised convs included (else the PET decoder outputs a constant
and every comparison of it passes), and carried to the port with the
`jax_params` converters. The JAX models run both with their default
space-to-depth packing and unpacked (same parameters, same function); the
port computes the unpacked function. Everything is fp32. The reparameterisation
noise that JAX draws is fed to the port through `causal_task.sample_noise`.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cips_tpu import losses as jax_losses
from cips_tpu.data import nifti as jax_nifti
from cips_tpu.data.manifest import PairRow, write_manifest
from cips_tpu.data.torch_import import import_diffusion_decoder, import_diffusion_encoder, import_vae_decoder
from cips_tpu.models.autoencoder_kl import Decoder as JaxDecoder
from cips_tpu.models.encoder import DiffusionModelEncoder as JaxEncoder
from cips_tpu.models.perceptual import PerceptualLoss as JaxPerceptualLoss
from cips_tpu.models.perceptual import params_from_npz as jax_params_from_npz
from cips_tpu.training import causal_task as jax_causal
from cips_tpu.training.common import TrainState
from cips_tpu.training.common import adam as jax_adam
from cips_tpu_torch import losses
from cips_tpu_torch.cli import gen_latents, gen_test_causal, train_causal
from cips_tpu_torch.data import nifti
from cips_tpu_torch.data.jax_params import (
    diffusion_decoder_from_jax_params,
    discriminator_from_jax_params,
    encoder_from_jax_params,
    perceptual_from_jax_params,
    vae_decoder_from_jax_params,
)
from cips_tpu_torch.models.autoencoder_kl import Decoder
from cips_tpu_torch.models.encoder import DiffusionModelEncoder
from cips_tpu_torch.models.perceptual import PerceptualLoss, params_from_npz
from cips_tpu_torch.training import causal_task
from test_cli_workloads import TINY_CAUSAL_CFG, TINY_CLS_CFG

K = 5
CROP = (8, 16, 8)
LATENT = (4, 8, 4, 3)  # z_mu / z_sigma of one sample: the last level keeps its resolution
TRAIN_CFG = {**TINY_CAUSAL_CFG["training"], "perceptual_weight": 0.02}



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread for this module: its tensors are tiny, and a full
    intra-op pool in each of the suite's parallel workers oversubscribes the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _unpacked(cfg):
    cfg = copy.deepcopy(cfg)
    for d in (cfg["t1_autoencoder_def"]["atten_encoder"], cfg["t1_autoencoder_def"]["decoder"], cfg["pet_decoder_def"]):
        d["s2d"] = False
    return cfg


def _random_tree(shapes, rng):
    """LeCun-scaled kernels, norm scales near 1, small biases, LPIPS lin weights
    in (0, 2/C), for a flax tree of shapes."""

    def draw(path, a):
        leaf = path[-1].key
        if leaf == "kernel":
            return (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        if leaf == "scale":
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if leaf.startswith("lin"):
            return (rng.random(a.shape) * 2 / a.shape[0]).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rel=1e-5, msg=""):
    want = np.asarray(want)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0, err_msg=msg)


@pytest.fixture(scope="module")
def trio():
    """The JAX models (packed and unpacked), their random params, and a batch."""
    packed = jax_causal.build_models(TINY_CAUSAL_CFG, K, dtype=jnp.float32, remat=False)
    unpacked = jax_causal.build_models(_unpacked(TINY_CAUSAL_CFG), K, dtype=jnp.float32, remat=False)
    enc, t1_dec, pet_dec, disc, perc = unpacked
    rng = np.random.default_rng(0)
    x, z, ctx = jnp.zeros((1, *CROP, 1)), jnp.zeros((1, *LATENT)), jnp.zeros((1, 1, K))
    key = jax.random.key(0)
    params = {
        "encoder": _random_tree(jax.eval_shape(enc.init, key, x), rng),
        "t1_decoder": _random_tree(jax.eval_shape(t1_dec.init, key, z), rng),
        "pet_decoder": _random_tree(jax.eval_shape(pet_dec.init, key, z, ctx), rng),
        "d": _random_tree(jax.eval_shape(disc.init, key, x), rng),
        "p": _random_tree(jax.eval_shape(perc.init, key, x, x), rng),
    }
    batch = _batch(np.random.default_rng(1))
    return {"packed": packed, "unpacked": unpacked, "params": params, "batch": batch}


def _batch(rng, b=2):
    t1 = rng.random((b, *CROP, 1), np.float32)
    pet = np.clip(t1 * 0.8 + 0.1 * rng.random((b, *CROP, 1), np.float32), 0, 1)
    return {"t1": t1, "pet": pet, "info": rng.random((b, 1, K), np.float32)}


def _port_models(params, cfg=TINY_CAUSAL_CFG):
    enc, t1_dec, pet_dec, disc, perc = causal_task.build_models(cfg, K, dtype=torch.float32, device="cpu")
    enc.load_state_dict(encoder_from_jax_params(params["encoder"]))
    t1_dec.load_state_dict(vae_decoder_from_jax_params(params["t1_decoder"]))
    pet_dec.load_state_dict(diffusion_decoder_from_jax_params(params["pet_decoder"]))
    disc.load_state_dict(discriminator_from_jax_params(params["d"], 1))
    perc.load_state_dict(perceptual_from_jax_params(params["p"]))
    return enc, t1_dec, pet_dec, disc, perc


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _feed_noise(monkeypatch, draws):
    """Make the port draw ``draws`` (numpy arrays) in order."""
    queue = list(draws)

    def fed(shape, dtype, device, generator):
        eps = torch.from_numpy(np.array(queue.pop(0)))
        assert eps.shape == shape
        return eps.to(device, dtype)

    monkeypatch.setattr(causal_task, "sample_noise", fed)
    return queue


@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_trio_forwards_match_jax(trio, layout):
    # fp32; summation order only: each output within 1e-5 of its max|out|
    enc, t1_dec, pet_dec, _, _ = trio[layout]
    params, batch = trio["params"], trio["batch"]
    latent = jax.jit(enc.apply)(params["encoder"], jnp.asarray(batch["t1"]))
    z = np.asarray(latent)[..., :3] + 0.5 * np.asarray(latent)[..., 3:]
    t1_rec = jax.jit(t1_dec.apply)(params["t1_decoder"], jnp.asarray(z))
    pet = jax.jit(pet_dec.apply)(params["pet_decoder"], jnp.asarray(z), jnp.asarray(batch["info"]))
    p_enc, p_t1, p_pet, _, _ = _port_models(params)
    with torch.no_grad():
        _close(p_enc(torch.from_numpy(batch["t1"])).numpy(), latent, msg="encoder")
        _close(p_t1(torch.from_numpy(z)).numpy(), t1_rec, msg="t1 decoder")
        _close(p_pet(torch.from_numpy(z), torch.from_numpy(batch["info"])).numpy(), pet, msg="pet decoder")
    assert np.asarray(pet).std() > 0.01  # non-zero weights everywhere: not a constant output


def test_encoder_mlp_head_matches_jax_and_round_trips():
    cfg = dict(TINY_CLS_CFG["atten_encoder_def"])
    jax_enc = JaxEncoder(head="mlp", **cfg)
    rng = np.random.default_rng(2)
    x = rng.random((2, *CROP, 1), np.float32)
    params = _random_tree(jax.eval_shape(jax_enc.init, jax.random.key(0), jnp.asarray(x)), rng)
    want = jax.jit(jax_enc.apply)(params, jnp.asarray(x))
    model = DiffusionModelEncoder(head="mlp", input_shape=CROP, **cfg).eval()
    state = encoder_from_jax_params(params)
    model.load_state_dict(state)
    with torch.no_grad():
        _close(model(torch.from_numpy(x)).numpy(), want, msg="mlp head")
    back = import_diffusion_encoder({k: v.numpy() for k, v in state.items()}, num_levels=2)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_want = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_back[path], leaf, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("nonlocal_attn", [False, True])
def test_t1_decoder_weights_round_trip_and_nonlocal_branch(trio, nonlocal_attn):
    cfg = dict(TINY_CAUSAL_CFG["t1_autoencoder_def"]["decoder"], with_decoder_nonlocal_attn=nonlocal_attn)
    jax_dec = JaxDecoder(**cfg)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((2, *LATENT)).astype(np.float32)
    params = _random_tree(jax.eval_shape(jax_dec.init, jax.random.key(0), jnp.asarray(z)), rng)
    model = Decoder(**cfg)
    state = vae_decoder_from_jax_params(params)
    model.load_state_dict(state)
    with torch.no_grad():
        _close(model(torch.from_numpy(z)).numpy(), jax.jit(jax_dec.apply)(params, jnp.asarray(z)), msg="decoder")
    back = import_vae_decoder({k: v.numpy() for k, v in state.items()}, cfg["num_channels"], cfg["num_res_blocks"],
                              with_decoder_nonlocal_attn=nonlocal_attn)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_want = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_back[path], leaf, err_msg=jax.tree_util.keystr(path))


def test_encoder_and_pet_decoder_weights_round_trip(trio):
    params = trio["params"]
    for convert, importer, tree, extra in (
        (encoder_from_jax_params, import_diffusion_encoder, params["encoder"], {"out_norm", "conv_out"}),
        (diffusion_decoder_from_jax_params, import_diffusion_decoder, params["pet_decoder"], set()),
    ):
        state = convert(tree)
        back = importer({k: v.numpy() for k, v in state.items()}, num_levels=2)
        flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        flat_want = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
        # the spatial head is not read by import_diffusion_encoder; the port keeps its flax names
        skipped = [p for p, _ in flat_want if p[0].key in extra]
        assert len(flat_back) == len(flat_want) - len(skipped)
        for path, leaf in flat_want:
            if path[0].key in extra:
                name = path[0].key + (".weight" if path[-1].key == "scale" else ".conv.weight"
                                      if path[-1].key == "kernel" else "." + path[-1].key)
                name = name.replace("conv_out.bias", "conv_out.conv.bias")
                assert name in state, name
            else:
                np.testing.assert_array_equal(flat_back[path], leaf, err_msg=jax.tree_util.keystr(path))


def test_kl_divergence_matches_jax():
    rng = np.random.default_rng(4)
    mu, logvar = (rng.standard_normal((3, *LATENT)).astype(np.float32) for _ in range(2))
    got = losses.kl_divergence(torch.from_numpy(mu), torch.from_numpy(logvar)).item()
    np.testing.assert_allclose(got, float(jax_losses.kl_divergence(jnp.asarray(mu), jnp.asarray(logvar))), rtol=1e-6)
    assert losses.kl_divergence(torch.from_numpy(mu).bfloat16(), torch.from_numpy(logvar).bfloat16()).dtype == \
        torch.float32


@pytest.mark.parametrize("network_type", ["squeeze", "alex"])
def test_perceptual_loss_from_npz_matches_jax(tmp_path, network_type):
    # One .npz for both packages, in the JAX package's flat "/" key format. At
    # (20, 28, 24) squeeze keeps every tap; alex keeps its first 3 (the rest
    # shrink to nothing and are skipped, as in JAX).
    shape = (2, 20, 28, 24, 1)
    jax_loss = JaxPerceptualLoss(spatial_dims=3, network_type=network_type)
    rng = np.random.default_rng(5)
    x = rng.random(shape, np.float32)
    y = np.clip(x + 0.1 * rng.standard_normal(shape).astype(np.float32), 0, 1)
    params = _random_tree(jax.eval_shape(jax_loss.init, jax.random.key(0), jnp.asarray(x), jnp.asarray(x)), rng)
    flat = {"/".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params["params"])[0]}
    npz = tmp_path / "lpips.npz"
    np.savez(npz, **flat)
    want = float(jax.jit(jax_loss.apply)(jax_params_from_npz(npz), jnp.asarray(x), jnp.asarray(y)))
    model = PerceptualLoss(spatial_dims=3, network_type=network_type)
    model.load_state_dict(params_from_npz(str(npz)))
    got = model(torch.from_numpy(x), torch.from_numpy(y)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert want > 0 and not any(p.requires_grad for p in model.parameters())


def _jax_state(params, train_cfg=TRAIN_CFG):
    gen = {k: params[k] for k in causal_task.GENERATOR_PARTS}
    return jax_causal.CausalState(
        gen=TrainState.create(gen, jax_adam(train_cfg["base_lr"])),
        d=TrainState.create(params["d"], jax_adam(train_cfg["disc_lr"])),
        p_params=params["p"], step=jnp.zeros((), jnp.int32),
    )


def _port_state(params, train_cfg=TRAIN_CFG):
    return causal_task.init_state(*_port_models(params), train_cfg)


def _assert_grads_close(model: torch.nn.Module, want: dict, msg: str) -> None:
    """Each grad within 1e-4 of its tensor's max|grad|. A tensor whose max|grad|
    is under 1e-3 of the network's largest (a conv bias ahead of a norm, whose
    exact gradient is 0) holds only rounding noise: both sides must stay under
    that bound instead."""
    tiny = 1e-3 * max(w.abs().max().item() for w in want.values())
    for name, p in model.named_parameters():
        scale = want[name].abs().max().item()
        if scale < tiny:
            assert p.grad.abs().max().item() < tiny, f"{msg} {name}"
        else:
            assert (p.grad - want[name]).abs().max().item() <= 1e-4 * scale, f"{msg} {name}"


def _adam_grads(new: TrainState, old: TrainState):
    """The gradient that a JAX TrainState's Adam step took, from its first moments:
    mu_t = b1 mu_(t-1) + (1 - b1) g_t (b1 0.9), as numpy."""
    mu_new, mu_old = new.opt_state[0].mu, old.opt_state[0].mu
    return _np_tree(jax.tree_util.tree_map(lambda a, b: (a - 0.9 * b) / 0.1, mu_new, mu_old))


@pytest.mark.parametrize("exact_d_fake,perceptual_weight", [(False, 0.02), (True, 0.0)])
def test_train_step_matches_jax_over_three_steps(trio, monkeypatch, exact_d_fake, perceptual_weight):
    # Three G+D steps of JAX's train step and the port's on three batches, JAX's
    # noise fed to the port, each step from JAX's parameters (the port's Adam
    # moments run on). Each step's generator and D gradients (JAX's read back
    # from its Adam moments) within 1e-4 of each max|grad|; the metrics within
    # 1e-4 relative; after the last step the parameters within 2 lr (Adam moves
    # an element whose gradient is rounding noise by up to lr either way). The
    # perceptual term is on in one case (it doubles JAX's compile time).
    enc, t1_dec, pet_dec, disc, perc = trio["unpacked"]
    train_cfg = {**TRAIN_CFG, "perceptual_weight": perceptual_weight}
    jax_step = jax.jit(jax_causal.make_train_step(enc, t1_dec, pet_dec, disc, perc, train_cfg,
                                                  exact_d_fake=exact_d_fake))
    jax_state = _jax_state(trio["params"])
    state = _port_state(trio["params"], train_cfg)
    assert (state.perceptual is not None) == (perceptual_weight > 0)
    step = causal_task.make_train_step(train_cfg, exact_d_fake=exact_d_fake)
    rng = np.random.default_rng(6)
    converters = (("encoder", encoder_from_jax_params), ("t1_decoder", vae_decoder_from_jax_params),
                  ("pet_decoder", diffusion_decoder_from_jax_params))
    for i in range(3):
        params = _np_tree(jax_state.gen.params)
        for part, convert in converters:
            state.gen[part].load_state_dict(convert(params[part]))
        state.d.load_state_dict(discriminator_from_jax_params(_np_tree(jax_state.d.params), 1))
        batch = _batch(rng)
        key = jax.random.key(100 + i)
        new_state, want = jax_step(jax_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        g_grads, d_grads = _adam_grads(new_state.gen, jax_state.gen), _adam_grads(new_state.d, jax_state.d)
        jax_state = new_state

        _feed_noise(monkeypatch, [np.array(jax.random.normal(r, (2, *LATENT), jnp.float32))
                                  for r in jax.random.split(key)])  # eps_t1, eps_pet
        got = step(state, _torch(batch), torch.Generator())
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-7, err_msg=f"step {i} {k}")
        for part, convert in converters:
            _assert_grads_close(state.gen[part], convert(g_grads[part]), f"step {i} {part}")
        _assert_grads_close(state.d, discriminator_from_jax_params(d_grads, 1), f"step {i} d")
    assert state.step == int(jax_state.step) == 3
    params = _np_tree(jax_state.gen.params)
    for part, convert in converters:
        want = convert(params[part])
        for name, p in state.gen[part].state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=2 * TRAIN_CFG["base_lr"], rtol=0,
                                       err_msg=f"{part} {name}")


def test_eval_step_and_generate_fn_match_jax(trio, monkeypatch):
    enc, t1_dec, pet_dec, _, _ = trio["packed"]
    params, batch = trio["params"], trio["batch"]
    key = jax.random.key(7)
    eps = np.asarray(jax.random.normal(key, (2, *LATENT), jnp.float32))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(jax_causal.make_eval_step(enc, t1_dec, pet_dec))(_jax_state(params), jb, key)
    want_gen = jax.jit(jax_causal.make_generate_fn(enc, pet_dec))(
        {k: params[k] for k in causal_task.GENERATOR_PARTS}, jb, key)
    state = _port_state(params)
    _feed_noise(monkeypatch, [eps, eps])
    got = causal_task.make_eval_step()(state, _torch(batch), torch.Generator())
    for k in ("rec_pet_loss", "rec_t1_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    for k in ("fake", "t1_rec"):
        _close(got[k].numpy(), want[k], msg=k)
    generate = causal_task.make_generate_fn(state.gen["encoder"], state.gen["pet_decoder"])
    _close(generate(_torch(batch), torch.Generator()).numpy(), want_gen, msg="generate")
    _close(want_gen, want["fake"], msg="generate is the eval step's fake")


def test_nan_guard_skips_both_updates(trio):
    state = _port_state(trio["params"])
    before = {k: v.clone() for k, v in {**state.gen.state_dict(), **state.d.state_dict()}.items()}
    batch = _torch(trio["batch"])
    batch["t1"][0, 0, 0, 0, 0] = float("nan")
    metrics = causal_task.make_train_step(TRAIN_CFG, nan_guard=True)(state, batch, torch.Generator().manual_seed(0))
    assert metrics["skipped_nonfinite"].item() == 1.0 and state.step == 0
    after = {**state.gen.state_dict(), **state.d.state_dict()}
    assert all(torch.equal(before[k], after[k]) for k in before)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Six subjects of (10, 18, 10) (pad/crop runs), train and test manifests with
    AV45 covariates, their stats, and the tiny causal config."""
    root = tmp_path_factory.mktemp("causal_tree")
    rng = np.random.default_rng(0)
    rows = [PairRow(f"s{i}", f"2011-0{i + 1}-01", f"2011-0{i + 1}-10",
                    {"ABETA": str(400 + 100 * i), "Age": str(70 + i), "Sex": str(i % 2), "APOE4": str(i % 3),
                     "PTEDUCAT": "16"}) for i in range(6)]
    for r in rows:
        for base, date in (("t1", r.t1_date), ("pet", r.pet_date)):
            jax_nifti.write(str(root / base / r.subject / date / "img.nii.gz"),
                            rng.random((10, 18, 10)).astype(np.float32))
    write_manifest(str(root / "train.csv"), rows[:4])
    write_manifest(str(root / "test.csv"), rows[4:])
    (root / "stats.json").write_text(json.dumps({"ABETA": [0, 2000], "Age": [55, 94], "PTEDUCAT": [6, 20]}))
    (root / "cfg.json").write_text(json.dumps(TINY_CAUSAL_CFG))
    return root


def _data_args(root):
    return ["--training_info_csv", str(root / "train.csv"), "--eval_info_csv", str(root / "test.csv"),
            "--PET_dir", str(root / "pet"), "--T1_dir", str(root / "t1"), "--min_and_max", str(root / "stats.json"),
            "--config", str(root / "cfg.json"), "--crop_size", *map(str, CROP), "--dtype", "f32"]


def test_causal_clis_end_to_end_on_cpu(tree, tmp_path, capsys):
    exp = str(tmp_path / "exp")
    args = _data_args(tree) + ["--exp_dir", exp, "--batch_size", "2", "--save_every", "1", "--device", "cpu"]
    state = train_causal.main(args + ["--epochs", "2"])
    assert state.step == 4  # 4 training subjects at batch 2: 2 steps an epoch
    base = os.path.join(exp, "conditional", "AV45")
    assert os.path.exists(os.path.join(exp, "packed_train", "volumes.npy"))  # the default, packed loader
    meta = json.loads(open(os.path.join(base, "ckpt", "meta.json"), encoding="utf-8").read())
    assert meta["last_epoch"] == 1 and np.isfinite(meta["best_metric"])
    resumed = train_causal.main(args + ["--epochs", "3", "--resume"])
    assert resumed.step == 6 and resumed.opt_g.state_dict()["state"][0]["step"].item() == 6
    records = [json.loads(line) for line in open(os.path.join(base, "log", "metrics.jsonl"), encoding="utf-8")]
    assert [r["prefix"] for r in records] == ["eval"] * 3 and all(np.isfinite(r["rec_pet_loss"]) for r in records)

    out = tmp_path / "gen"
    results = gen_test_causal.main(_data_args(tree) + ["--exp_dir", exp, "--device", "cpu", "--output_dir", str(out)])
    assert all(np.isfinite(v) for v in results.summary().values())
    recs = sorted(out.rglob("rec.nii.gz"))
    assert len(recs) == 2 and not list(out.rglob("ori.nii.gz"))
    for path in recs:
        rec = nifti.read_array(str(path))
        assert rec.shape == CROP and 0 <= rec.min() and rec.max() <= 1 and rec.max() > 0

    lat = tmp_path / "lat"
    assert gen_latents.main(_data_args(tree) + ["--exp_dir", exp, "--device", "cpu", "--out_dir", str(lat)]) == 2
    latents = sorted(lat.rglob("latent.npy"))
    assert len(latents) == 2 and all(np.load(p).shape == (*LATENT[:3], 6) for p in latents)
    assert "eval rec_pet" in capsys.readouterr().out


def test_causal_clis_need_cuda_unless_asked(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp = ["--exp_dir", str(tmp_path / "exp")]
    for main, extra in ((train_causal.main, []), (gen_test_causal.main, []),
                        (gen_latents.main, ["--out_dir", str(tmp_path / "lat")])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(_data_args(tree) + exp + extra)
