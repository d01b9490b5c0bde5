"""The PyTorch port's training path against the JAX package on the CPU.

A tiny conditional GAN (tests/test_training.py's AttenUNet, channels (8, 8),
attention at the last level; PatchDiscriminator 8 channels with
``num_layers_d`` 2, so ``norm_1`` and the penultimate norm both exist) at a
(12, 16, 12) crop, the smallest that leaves D a non-empty patch map. Weights
are drawn from a seeded numpy generator for every parameter, the output conv
included (with its zero init every other gradient of the first step is 0),
and carried across with `from_jax_params` / `discriminator_from_jax_params`.
Everything is fp32.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cips_tpu import losses as jax_losses
from cips_tpu.data import dataset as jax_dataset
from cips_tpu.data.torch_import import import_patch_discriminator
from cips_tpu.models.discriminator import PatchDiscriminator as JaxPatchDiscriminator
from cips_tpu.training import unet_synthesis as jax_synthesis
from cips_tpu.training.common import TrainState
from cips_tpu.training.common import adam as jax_adam
from cips_tpu_torch import losses
from cips_tpu_torch.cli import output_predict, train_unet
from cips_tpu_torch.data import nifti
from cips_tpu_torch.data.dataset import PairedVolumeDataset, StreamingLoader
from cips_tpu_torch.data.jax_params import discriminator_from_jax_params, from_jax_params
from cips_tpu_torch.models.discriminator import PatchDiscriminator
from cips_tpu_torch.training import unet_synthesis
from cips_tpu_torch.training.common import CheckpointManager

K = 3
CROP = (12, 16, 12)
LEVELS = 2
CFG = {
    "atten_unet_def": {
        "spatial_dims": 3, "in_channels": 1, "out_channels": 1, "num_channels": [8, 8], "num_res_blocks": 1,
        "attention_levels": [False, True], "norm_num_groups": 8, "norm_eps": 1e-6, "resblock_updown": True,
        "num_head_channels": [0, 4],
    },
    "discriminator": {"num_channels": 8, "num_layers_d": 2},
    "training": {"base_lr": 1e-3, "disc_lr": 1e-4, "perceptual_weight": 0, "adv_weight": 0.1},
}
TRAIN_CFG = CFG["training"]
AW = TRAIN_CFG["adv_weight"]



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


def _random_tree(shapes, rng):
    """LeCun-scaled kernels, norm scales near 1, small biases, for a flax tree of shapes."""

    def draw(path, a):
        leaf = path[-1].key
        if leaf == "kernel":
            return (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        if leaf == "scale":
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _batch(rng, b=2):
    t1 = rng.random((b, *CROP, 1), np.float32)
    pet = np.clip(t1 * 0.8 + 0.1 * rng.random((b, *CROP, 1), np.float32), 0, 1)
    return {"t1": t1, "pet": pet, "info": rng.random((b, 1, K), np.float32)}


@pytest.fixture(scope="module")
def models():
    """JAX G and D (unpacked, no remat), their random params, and the batch."""
    g, d, _ = jax_synthesis.build_models(CFG, n_covariates=K, dtype=jnp.float32, remat=False, s2d=False)
    rng = np.random.default_rng(0)
    x, ctx = jnp.zeros((1, *CROP, 1)), jnp.zeros((1, 1, K))
    g_params = _random_tree(jax.eval_shape(g.init, jax.random.key(0), x, ctx), rng)
    d_params = _random_tree(jax.eval_shape(d.init, jax.random.key(1), x), rng)
    return g, d, g_params, d_params


def _port_state(g_params, d_params) -> unet_synthesis.GANState:
    generator, discriminator, perceptual = unet_synthesis.build_models(CFG, K, dtype=torch.float32, device="cpu")
    assert perceptual is None
    generator.load_state_dict(from_jax_params(g_params, LEVELS))
    discriminator.load_state_dict(discriminator_from_jax_params(d_params, 2))
    return unet_synthesis.init_state(generator, discriminator, TRAIN_CFG)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_grads_close(model: torch.nn.Module, want: dict) -> None:
    """Each grad within 1e-4 of its tensor's max|grad|. A tensor whose max|grad|
    is under 1e-3 of the network's largest (a conv bias ahead of a norm, whose
    exact gradient is 0) holds only rounding noise: both sides must stay under
    that bound instead."""
    tiny = 1e-3 * max(w.abs().max().item() for w in want.values())
    for name, p in model.named_parameters():
        scale = want[name].abs().max().item()
        if scale < tiny:
            assert p.grad.abs().max().item() < tiny, name
        else:
            assert (p.grad - want[name]).abs().max().item() <= 1e-4 * scale, name


@pytest.mark.parametrize("num_layers_d", [1, 2])
def test_discriminator_features_match_jax_f32(num_layers_d):
    # fp32 convs and instance norms; summation order only. Every feature map,
    # channels-last, logits last.
    rng = np.random.default_rng(num_layers_d)
    x = rng.random((2, *CROP, 1), np.float32)
    jd = JaxPatchDiscriminator(num_channels=8, num_layers_d=num_layers_d)
    params = _random_tree(jax.eval_shape(jd.init, jax.random.key(0), jnp.asarray(x)), rng)
    want = [np.asarray(f) for f in jax.jit(jd.apply)(params, jnp.asarray(x))]
    model = PatchDiscriminator(num_channels=8, num_layers_d=num_layers_d)
    state = discriminator_from_jax_params(params, num_layers_d)
    assert list(state) == list(model.state_dict())  # the order import_patch_discriminator maps by
    back = import_patch_discriminator(state, num_layers_d)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params["params"])[0]:
        np.testing.assert_array_equal(dict(jax.tree_util.tree_flatten_with_path(back)[0])[path], leaf)
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got) == len(want) == num_layers_d + 2
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5 * np.abs(b).max(), rtol=0, err_msg=f"feature {i}")
    with pytest.raises(ValueError, match="empty patch-logit map"):
        model(torch.zeros((1, *(2 ** (num_layers_d + 1),) * 3, 1)))  # logits of size 0
    with pytest.raises(ValueError):
        discriminator_from_jax_params(params, num_layers_d + 1)


def test_losses_match_jax():
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal((2, 3, 4, 1)).astype(np.float32), rng.standard_normal((2, 3, 4, 1)).astype(np.float32)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    # fp32 means of a few dozen terms: rounding only
    np.testing.assert_allclose(losses.l1_loss(ta, tb).item(), float(jax_losses.l1_loss(ja, jb)), rtol=1e-6)
    for real, for_d in ((True, False), (True, True), (False, True)):
        np.testing.assert_allclose(
            losses.patch_adversarial_loss(ta, target_is_real=real, for_discriminator=for_d).item(),
            float(jax_losses.patch_adversarial_loss(ja, target_is_real=real, for_discriminator=for_d)), rtol=1e-6)
    np.testing.assert_allclose(losses.lsgan_discriminator_loss(ta, tb).item(),
                               float(jax_losses.lsgan_discriminator_loss(ja, jb)), rtol=1e-6)
    with pytest.raises(ValueError):
        losses.patch_adversarial_loss(ta, target_is_real=False, for_discriminator=False)
    assert losses.l1_loss(ta.to(torch.bfloat16), tb.to(torch.bfloat16)).dtype == torch.float32


def test_gradients_match_jax_grad(models):
    # The G loss (L1 + adv_weight * LSGAN through the frozen D) and the D loss on
    # cat([fake, pet]), each differentiated by both frameworks from the same
    # weights. fp32; ~20 layers of summation-order noise; limits in
    # `_assert_grads_close`.
    g, d, g_params, d_params = models
    batch = _batch(np.random.default_rng(1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def g_loss(gp):
        fake = g.apply(gp, jb["t1"], jb["info"])
        adv = jax_losses.patch_adversarial_loss(d.apply(d_params, fake)[-1], target_is_real=True,
                                                for_discriminator=False)
        return jax_losses.l1_loss(fake, jb["pet"]) + AW * adv, fake

    (g_val, fake), g_grads = jax.jit(jax.value_and_grad(g_loss, has_aux=True))(g_params)

    def d_loss(dp):
        logits = d.apply(dp, jnp.concatenate([fake, jb["pet"]], axis=0))[-1]
        return jax_losses.lsgan_discriminator_loss(*jnp.split(logits, 2, axis=0))

    d_val, d_grads = jax.jit(jax.value_and_grad(d_loss))(d_params)

    state = _port_state(g_params, d_params)
    tb = _torch(batch)
    state.d.requires_grad_(False)
    t_fake = state.g(tb["t1"], tb["info"])
    adv = losses.patch_adversarial_loss(state.d(t_fake)[-1], target_is_real=True, for_discriminator=False)
    t_g = losses.l1_loss(t_fake, tb["pet"]) + AW * adv
    t_g.backward()
    state.d.requires_grad_(True)
    np.testing.assert_allclose(t_g.item(), float(g_val), rtol=1e-5)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, g_grads), LEVELS)
    assert want["out.2.conv.weight"].abs().max() > 0
    _assert_grads_close(state.g, want)
    assert all(p.grad is None for p in state.d.parameters())

    logits = state.d(torch.cat([t_fake.detach(), tb["pet"]]))[-1]
    t_d = losses.lsgan_discriminator_loss(*logits.chunk(2))
    t_d.backward()
    np.testing.assert_allclose(t_d.item(), float(d_val), rtol=1e-5)
    _assert_grads_close(state.d, discriminator_from_jax_params(jax.tree_util.tree_map(np.asarray, d_grads), 2))


@pytest.mark.parametrize("exact_d_fake,split_d", [(False, False), (True, True)])
def test_train_step_matches_jax_over_three_steps(models, exact_d_fake, split_d):
    # Three G+D steps on three batches. The metrics agree to 1e-4 relative
    # (measured 3e-6). The parameters are held to an absolute limit in units of
    # the learning rate: Adam's update is about lr * sign(g), so an element
    # whose gradient is rounding noise (a conv bias ahead of a norm: exactly 0)
    # may move 2 lr apart per step; over three steps the limit is 6 lr
    # (measured 3.6 lr, in such biases).
    g, d, g_params, d_params = models
    jax_state = jax_synthesis.GANState(
        g=TrainState.create(g_params, jax_adam(TRAIN_CFG["base_lr"])),
        d=TrainState.create(d_params, jax_adam(TRAIN_CFG["disc_lr"])),
        p_params=None, step=jnp.zeros((), jnp.int32),
    )
    jax_step = jax.jit(jax_synthesis.make_train_step(g, d, None, TRAIN_CFG, exact_d_fake=exact_d_fake,
                                                     split_d=split_d))
    state = _port_state(g_params, d_params)
    step = unet_synthesis.make_train_step(TRAIN_CFG, exact_d_fake=exact_d_fake, split_d=split_d)
    rng = np.random.default_rng(2)
    for i in range(3):
        batch = _batch(rng)
        jax_state, want = jax_step(jax_state, {k: jnp.asarray(v) for k, v in batch.items()})
        got = step(state, _torch(batch))
        assert set(got) == set(want) == {"g_loss", "rec_loss", "p_loss", "adv_loss", "d_loss"}
        for key in want:
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i} {key}")
    assert state.step == int(jax_state.step) == 3
    for model, params, convert, lr in (
        (state.g, jax_state.g.params, lambda t: from_jax_params(t, LEVELS), TRAIN_CFG["base_lr"]),
        (state.d, jax_state.d.params, lambda t: discriminator_from_jax_params(t, 2), TRAIN_CFG["disc_lr"]),
    ):
        want = convert(jax.tree_util.tree_map(np.asarray, params))
        for name, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=6 * lr, rtol=0, err_msg=name)


def test_nan_guard_skips_both_updates(models):
    _, _, g_params, d_params = models
    state = _port_state(g_params, d_params)
    before = {k: v.clone() for k, v in {**state.g.state_dict(), **state.d.state_dict()}.items()}
    batch = _torch(_batch(np.random.default_rng(3)))
    batch["t1"][0, 0, 0, 0, 0] = float("nan")
    metrics = unet_synthesis.make_train_step(TRAIN_CFG, nan_guard=True)(state, batch)
    assert metrics["skipped_nonfinite"].item() == 1.0 and not np.isfinite(metrics["g_loss"].item())
    assert state.step == 0
    after = {**state.g.state_dict(), **state.d.state_dict()}
    assert all(torch.equal(before[k], after[k]) for k in before)
    metrics = unet_synthesis.make_train_step(TRAIN_CFG, nan_guard=True)(state, _torch(_batch(np.random.default_rng(4))))
    assert metrics["skipped_nonfinite"].item() == 0.0 and state.step == 1


def test_eval_step_and_unported_weights(models):
    g, d, g_params, d_params = models
    batch = _batch(np.random.default_rng(6), b=1)
    jax_state = jax_synthesis.GANState(g=TrainState.create(g_params, jax_adam(1e-3)),
                                       d=TrainState.create(d_params, jax_adam(1e-4)), p_params=None, step=0)
    want = jax.jit(jax_synthesis.make_eval_step(g, d, None, TRAIN_CFG))(
        jax_state, {k: jnp.asarray(v) for k, v in batch.items()})
    got = unet_synthesis.make_eval_step(TRAIN_CFG)(_port_state(g_params, d_params), _torch(batch))
    for key in ("rec_loss", "p_loss", "adv_loss", "g_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(got["fake"].numpy(), np.asarray(want["fake"]),
                               atol=1e-5 * np.abs(np.asarray(want["fake"])).max(), rtol=0)
    # the perceptual term is ported (tests/test_torch_port_classifier.py holds it to JAX):
    # a perceptual weight builds the LPIPS network and a step that uses it
    cfg = {**CFG, "perceptual_network": {"spatial_dims": 3}, "training": {**TRAIN_CFG, "perceptual_weight": 1.0}}
    generator, discriminator, perceptual = unet_synthesis.build_models(cfg, K, dtype=torch.float32, device="cpu")
    assert perceptual is not None
    assert callable(unet_synthesis.make_train_step(cfg["training"]))
    # and a state without the network is refused, not trained without the term
    with pytest.raises(ValueError, match="perceptual"):
        unet_synthesis.init_state(generator, discriminator, cfg["training"])


AV45 = ["ABETA", "Age", "Sex", "APOE4", "PTEDUCAT"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Five subjects {t1,pet}/{Subject}/{date}/img.nii.gz (larger than the crop),
    train and eval manifests with AV45 covariates, and their stats."""
    root = tmp_path_factory.mktemp("train_tree")
    rng = np.random.default_rng(0)
    grids = np.meshgrid(*(np.linspace(-1, 1, s) for s in (14, 18, 14)), indexing="ij")
    rows = []
    for i in range(5):
        subj = f"s{i:03d}"
        blob = np.clip(1.0 - sum(g**2 for g in grids) / (0.7 + 0.05 * i) ** 2, 0.0, None)
        for kind, date in (("t1", "2012-01-01"), ("pet", "2012-01-15")):
            vol = blob * (1.0 + 0.2 * rng.standard_normal(blob.shape)) + 0.02 * rng.random(blob.shape)
            nifti.write(str(root / kind / subj / date / "img.nii.gz"), vol.astype(np.float32))
        rows.append([subj, "2012-01-01", "2012-01-15", 500 + 150 * i, 70 + i, "Female" if i % 2 else "Male",
                     i % 3, 12 + i])
    for name, part in (("train.csv", rows), ("test.csv", rows[:2])):
        with open(root / name, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["Subject", "T1_date", "PET_date"] + AV45)
            w.writerows(part)
    (root / "stats.json").write_text(json.dumps({"ABETA": [200, 1700], "Age": [55, 95], "PTEDUCAT": [6, 20]}))
    (root / "cfg.json").write_text(json.dumps(CFG))
    return {k: str(root / v) for k, v in (("train", "train.csv"), ("test", "test.csv"), ("stats", "stats.json"),
                                          ("t1", "t1"), ("pet", "pet"), ("cfg", "cfg.json"))}


def test_streaming_loader_order_matches_jax(tree, monkeypatch):
    # The JAX loader's synchronous path (no native prefetch pool) is the one ported.
    monkeypatch.setattr(jax_dataset, "_native", lambda: None)
    stats = json.loads(open(tree["stats"], encoding="utf-8").read())
    kw = dict(pet_dir=tree["pet"], t1_dir=tree["t1"], crop_size=CROP, need_values=AV45, min_and_max=stats)
    port_ds, jax_ds = PairedVolumeDataset(tree["train"], **kw), jax_dataset.PairedVolumeDataset(tree["train"], **kw)
    for opts in (dict(seed=3), dict(shuffle=False, drop_last=False)):
        for epoch in (0, 1):
            got = list(StreamingLoader(port_ds, 2, **opts).epoch(epoch))
            want = list(jax_dataset.StreamingLoader(jax_ds, 2, **opts).epoch(epoch))
            assert len(got) == len(want) == (2 if opts.get("drop_last", True) else 3)
            for a, b in zip(got, want):
                assert a.keys() == b.keys() == {"t1", "pet", "info"}
                for key in a:
                    assert a[key].shape == b[key].shape
                    np.testing.assert_allclose(a[key], b[key], rtol=1e-6, err_msg=key)


def _train_args(tree, exp_dir, *extra):
    return ["--exp_dir", exp_dir, "--config", tree["cfg"], "--training_info_csv", tree["train"],
            "--eval_info_csv", tree["test"], "--PET_dir", tree["pet"], "--T1_dir", tree["t1"],
            "--min_and_max", tree["stats"], "--crop_size", *map(str, CROP), "--batch_size", "2",
            "--use_condition", "--dtype", "f32", *extra]


def test_train_cli_end_to_end_on_cpu(tree, tmp_path, capsys):
    exp_dir = str(tmp_path / "exp")
    state = train_unet.main(_train_args(tree, exp_dir, "--epochs", "2", "--save_every", "1", "--device", "cpu"))
    base = os.path.join(exp_dir, "conditional", "AV45")
    assert state.step == 4  # 5 subjects at batch 2, drop_last: 2 steps per epoch
    meta = json.loads(open(os.path.join(base, "ckpt", "meta.json"), encoding="utf-8").read())
    assert meta["last_epoch"] == 1 and meta["best_epoch"] in (0, 1) and np.isfinite(meta["best_metric"])
    assert {"epoch_0", "epoch_1", "best"} <= set(os.listdir(os.path.join(base, "ckpt")))
    for e in (0, 1):
        for name in ("rec", "ori", "t1"):
            assert nifti.read_array(os.path.join(base, "visual", f"epoch{e}_{name}.nii.gz")).shape == CROP
    records = [json.loads(line) for line in open(os.path.join(base, "log", "metrics.jsonl"), encoding="utf-8")]
    assert [r["prefix"] for r in records] == ["eval", "eval"] and all(np.isfinite(r["g_loss"]) for r in records)
    payload = CheckpointManager(os.path.join(base, "ckpt")).restore()
    assert set(payload) == {"unet", "discriminator", "optimizer_g", "optimizer_d", "step", "epoch"}
    assert payload["step"] == 4 and payload["epoch"] == 1

    resumed = train_unet.main(_train_args(tree, exp_dir, "--epochs", "3", "--save_every", "1", "--device", "cpu",
                                          "--resume"))
    assert resumed.step == 6  # the restored 4, then epoch 2's two steps
    assert json.loads(open(os.path.join(base, "ckpt", "meta.json"), encoding="utf-8").read())["last_epoch"] == 2
    assert resumed.opt_g.state_dict()["state"][0]["step"].item() == 6
    out = capsys.readouterr().out
    assert out.count(" eval g_loss ") == 3

    results = output_predict.main([
        "--exp_dir", exp_dir, "--config", tree["cfg"], "--eval_info_csv", tree["test"], "--PET_dir", tree["pet"],
        "--T1_dir", tree["t1"], "--min_and_max", tree["stats"], "--crop_size", *map(str, CROP), "--use_condition",
        "--dtype", "f32", "--device", "cpu", "--output_dir", str(tmp_path / "pred"),
    ])
    assert all(np.isfinite(v) for v in results.summary().values())
    assert len(list((tmp_path / "pred").rglob("rec.nii.gz"))) == 2


def test_train_cli_needs_cuda_unless_asked_and_refuses_unported_flags(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_unet.main(_train_args(tree, str(tmp_path / "a"), "--epochs", "1"))
    # --perceptual_weights is ported (tests/test_torch_port_classifier.py); --n_space 2 needs
    # ranks it divides (tests/test_torch_port_space.py), and one process is refused
    with pytest.raises(ValueError, match="--n_space 2 does not divide"):
        train_unet.main(_train_args(tree, str(tmp_path / "b"), "--device", "cpu", "--n_space", "2"))


def test_train_cli_profile_dir_writes_a_trace_of_steps_10_to_15(tree, tmp_path):
    prof_dir = tmp_path / "prof"
    state = train_unet.main(_train_args(tree, str(tmp_path / "exp"), "--epochs", "8", "--max_steps", "16",
                                        "--eval_every", "100", "--save_every", "100", "--device", "cpu",
                                        "--profile_dir", str(prof_dir)))
    assert state.step == 16
    trace = json.loads((prof_dir / "trace.json").read_text())
    assert any(e.get("name") == "aten::convolution" for e in trace["traceEvents"])
