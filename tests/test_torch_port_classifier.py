"""The PyTorch port's MCI classifier, and the two flagship repairs of its slice,
against the JAX package on the CPU.

  * the flagship's perceptual term: a tiny AttenUNet GAN (tests/test_torch_port_train.py's,
    at its (12, 16, 12) crop) with LPIPS squeeze at weight 0.5, three train steps
    against JAX's, and `train_unet --perceptual_weights` with --resume;
  * the streaming random crop: `--streaming --random_crop_size` batches against
    the JAX package's synchronous streaming path (its native prefetch pool
    patched away: it decodes at crop_size and skips the crop) bit for bit;
  * the MCI dataset, its float16 store and loader against JAX's, bit for bit;
  * the numpy metrics against scikit-learn's;
  * the classifier (tests/test_cli_workloads.py's `TINY_CLS_CFG`: channels (8, 8),
    attention at level 1 with 4-channel heads) at an (8, 16, 8) crop, 2 channels,
    K = 5 covariates, against JAX's packed and unpacked model; three train steps
    with dropout off; both CLIs end to end.

Every parameter is drawn from a seeded numpy generator; everything is fp32.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn import metrics as skm

from cips_tpu.cli import common as jax_common
from cips_tpu.data import dataset as jax_dataset
from cips_tpu.eval import classification as jax_cls
from cips_tpu.training import classifier_task as jax_classifier
from cips_tpu.training import unet_synthesis as jax_synthesis
from cips_tpu.training.common import TrainState
from cips_tpu.training.common import adam as jax_adam
from cips_tpu_torch.cli import common, test_mci, train_classifier, train_unet
from cips_tpu_torch.data import dataset, nifti
from cips_tpu_torch.data.jax_params import encoder_from_jax_params, from_jax_params, perceptual_from_jax_params
from cips_tpu_torch.data.jax_params import discriminator_from_jax_params
from cips_tpu_torch.eval import classification
from cips_tpu_torch.training import classifier_task, unet_synthesis
from cips_tpu_torch.training.common import CheckpointManager
from test_cli_workloads import TINY_CLS_CFG
from test_torch_port_causal import _adam_grads, _assert_grads_close, _close, _np_tree, _random_tree

AV45 = ["ABETA", "Age", "Sex", "APOE4", "PTEDUCAT"]
K = len(AV45)
CROP = (8, 16, 8)
GAN_CROP = (12, 16, 12)
GAN_K = 3
GAN_CFG = {
    "atten_unet_def": {
        "spatial_dims": 3, "in_channels": 1, "out_channels": 1, "num_channels": [8, 8], "num_res_blocks": 1,
        "attention_levels": [False, True], "norm_num_groups": 8, "norm_eps": 1e-6, "resblock_updown": True,
        "num_head_channels": [0, 4],
    },
    "discriminator": {"num_channels": 8, "num_layers_d": 2},
    "perceptual_network": {"spatial_dims": 3, "network_type": "squeeze"},
    "training": {"base_lr": 1e-3, "disc_lr": 1e-4, "perceptual_weight": 0.5, "adv_weight": 0.1},
}



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


def _gan_batch(rng, b=2):
    t1 = rng.random((b, *GAN_CROP, 1), np.float32)
    pet = np.clip(t1 * 0.8 + 0.1 * rng.random((b, *GAN_CROP, 1), np.float32), 0, 1)
    return {"t1": t1, "pet": pet, "info": rng.random((b, 1, GAN_K), np.float32)}


@pytest.fixture(scope="module")
def gan():
    """JAX's tiny G, D and LPIPS squeeze (unpacked, no remat) and their random params."""
    g, d, p = jax_synthesis.build_models(GAN_CFG, n_covariates=GAN_K, dtype=jnp.float32, remat=False, s2d=False)
    rng = np.random.default_rng(0)
    x, ctx, key = jnp.zeros((1, *GAN_CROP, 1)), jnp.zeros((1, 1, GAN_K)), jax.random.key(0)
    params = {"g": _random_tree(jax.eval_shape(g.init, key, x, ctx), rng),
              "d": _random_tree(jax.eval_shape(d.init, key, x), rng),
              "p": _random_tree(jax.eval_shape(p.init, key, x, x), rng)}
    return g, d, p, params


def test_flagship_perceptual_step_matches_jax_over_three_steps(gan):
    # The repaired perceptual term: three G+D steps with LPIPS at weight 0.5. The
    # metrics (p_loss among them) within 1e-4 relative, the parameters after the
    # last step within 6 lr (as tests/test_torch_port_train.py holds the plain step).
    g, d, p, params = gan
    train_cfg = GAN_CFG["training"]
    jax_state = jax_synthesis.GANState(
        g=TrainState.create(params["g"], jax_adam(train_cfg["base_lr"])),
        d=TrainState.create(params["d"], jax_adam(train_cfg["disc_lr"])), p_params=params["p"],
        step=jnp.zeros((), jnp.int32))
    jax_step = jax.jit(jax_synthesis.make_train_step(g, d, p, train_cfg))
    generator, discriminator, perceptual = unet_synthesis.build_models(GAN_CFG, GAN_K, dtype=torch.float32,
                                                                       device="cpu")
    assert perceptual is not None and not any(t.requires_grad for t in perceptual.parameters())
    generator.load_state_dict(from_jax_params(params["g"], 2))
    discriminator.load_state_dict(discriminator_from_jax_params(params["d"], 2))
    perceptual.load_state_dict(perceptual_from_jax_params(params["p"]))
    state = unet_synthesis.init_state(generator, discriminator, train_cfg, perceptual)
    step = unet_synthesis.make_train_step(train_cfg)
    rng = np.random.default_rng(1)
    for i in range(3):
        batch = _gan_batch(rng)
        jax_state, want = jax_step(jax_state, {k: jnp.asarray(v) for k, v in batch.items()})
        got = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(want["p_loss"]) > 0
        for key in want:
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i} {key}")
    for model, tree, convert, lr in (
        (state.g, jax_state.g.params, lambda t: from_jax_params(t, 2), train_cfg["base_lr"]),
        (state.d, jax_state.d.params, lambda t: discriminator_from_jax_params(t, 2), train_cfg["disc_lr"]),
    ):
        want = convert(_np_tree(tree))
        for name, t in model.state_dict().items():
            np.testing.assert_allclose(t.numpy(), want[name].numpy(), atol=6 * lr, rtol=0, err_msg=name)
    eval_want = jax.jit(jax_synthesis.make_eval_step(g, d, p, train_cfg))(
        jax_state, {k: jnp.asarray(v) for k, v in batch.items()})
    eval_got = unet_synthesis.make_eval_step(train_cfg)(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("p_loss", "g_loss"):
        np.testing.assert_allclose(float(eval_got[key]), float(eval_want[key]), rtol=1e-3, err_msg=key)


def _write_subjects(root, names, shape, rng, dates=("2011-01-01", "2011-01-10")):
    for subj in names:
        for kind, date in (("t1", dates[0]), ("pet", dates[1])):
            nifti.write(str(root / kind / subj / date / "img.nii.gz"), rng.random(shape).astype(np.float32))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Eight subjects of (10, 18, 10) (pad/crop runs) with AV45 covariates and
    their stats. Train: s0-s5, plus s3's second session after its conversion
    date (dropped) and s6, who is not in the converter CSV (dropped); test: s6,
    s7 and s4. Synthesized PET (rec.nii.gz) for the test sessions, and the tiny
    classifier and flagship configs."""
    root = tmp_path_factory.mktemp("mci_tree")
    rng = np.random.default_rng(0)
    header = "Subject,T1_date,PET_date," + ",".join(AV45)
    rows = {}
    for i in range(8):
        subj = f"s{i}"
        dates = (f"2011-0{i + 1}-01", f"2011-0{i + 1}-10")
        _write_subjects(root, [subj], (10, 18, 10), rng, dates)
        rows[subj] = f"{subj},{dates[0]},{dates[1]},{400 + 100 * i},{70 + i},{'Female' if i % 2 else 'Male'},{i % 3},16"
        nifti.write(str(root / "fake" / subj / dates[1] / "rec.nii.gz"), rng.random(CROP).astype(np.float32))
    _write_subjects(root, ["s3"], (10, 18, 10), rng, ("2021-05-01", "2021-05-10"))
    late = f"s3,2021-05-01,2021-05-10,900,74,Female,0,16"
    (root / "train.csv").write_text("\n".join([header] + [rows[f"s{i}"] for i in range(7)] + [late]) + "\n")
    (root / "test.csv").write_text("\n".join([header, rows["s6"], rows["s7"], rows["s4"]]) + "\n")
    (root / "conv.csv").write_text("Subject,MCI_converter,Converter_date\ns0,0,\ns1,1,2015-01-01\ns2,0,\n"
                                   "s3,1,2020-01-01\ns4,0,\ns5,1,2015-01-01\ns7,1,2015-01-01\n")
    (root / "stats.json").write_text(json.dumps({"ABETA": [0, 2000], "Age": [55, 94], "PTEDUCAT": [6, 20]}))
    (root / "cls.json").write_text(json.dumps(TINY_CLS_CFG))
    (root / "gan.json").write_text(json.dumps(GAN_CFG))
    return root


def _mci_kw(root, **extra):
    stats = json.loads((root / "stats.json").read_text())
    return dict(converter_csv=str(root / "conv.csv"), pet_dir=str(root / "pet"), t1_dir=str(root / "t1"),
                crop_size=CROP, need_values=AV45, min_and_max=stats, **extra)


@pytest.mark.parametrize("opts", [dict(), dict(use_t1=False), dict(use_pet=False),
                                  dict(pet_name="rec.nii.gz", split="test")], ids=["pet_t1", "pet", "t1", "fake"])
def test_mci_dataset_store_and_loader_match_jax(tree, tmp_path, opts):
    opts = dict(opts)
    csv = str(tree / f"{opts.pop('split', 'train')}.csv")
    if "pet_name" in opts:
        opts["pet_dir"] = str(tree / "fake")
    kw = {**_mci_kw(tree), **opts}
    port, ref = dataset.MCIClassificationDataset(csv, **kw), jax_dataset.MCIClassificationDataset(csv, **kw)
    assert len(port) == len(ref) == (2 if "pet_name" in opts else 6)  # s6 and a converter's late session dropped
    assert port.labels == ref.labels and port.paths == ref.paths
    for i in range(len(port)):
        for a, b in zip(port[i], ref[i]):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            else:
                assert a == b
    dataset.pack_mci(port, str(tmp_path / "port"))
    jax_dataset.pack_mci(ref, str(tmp_path / "jax"))
    for name in ("volumes.npy", "covariates.npy", "labels.npy"):
        a, b = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    meta = json.loads((tmp_path / "port" / "index.json").read_text())
    assert meta == json.loads((tmp_path / "jax" / "index.json").read_text())
    assert meta["pet_source"] == ("fake" if "pet_name" in opts else "real")
    # each package reads the other's store
    store = dataset.PackedMCIDataset(str(tmp_path / "jax"))
    ref_store = jax_dataset.PackedMCIDataset(str(tmp_path / "port"))
    for loader_opts in (dict(seed=3), dict(shuffle=False, drop_last=False), dict(seed=1, batch_size=4)):
        batch_size = loader_opts.pop("batch_size", 2)
        got = dataset.MCIBatchLoader(store, batch_size, **loader_opts)
        want = jax_dataset.MCIBatchLoader(ref_store, batch_size, **loader_opts)
        assert got.steps_per_epoch() == want.steps_per_epoch()
        for epoch in (0, 1):
            pairs = list(zip(got.epoch(epoch), want.epoch(epoch), strict=True))
            assert len(pairs) == got.steps_per_epoch()
            for a, b in pairs:
                assert a.keys() == b.keys() == {"imgs", "info", "labels"}
                for key in a:
                    assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key


def _args(root, exp_dir, *extra):
    return ["--exp_dir", str(exp_dir), "--training_info_csv", str(root / "train.csv"),
            "--eval_info_csv", str(root / "test.csv"), "--PET_dir", str(root / "pet"), "--T1_dir", str(root / "t1"),
            "--min_and_max", str(root / "stats.json"), "--batch_size", "2", *extra]


def test_streaming_random_crop_matches_jax_synchronous_path(tree, tmp_path, monkeypatch):
    # JAX's native prefetch pool decodes at crop_size and skips the crop; its
    # synchronous path, which the port's is, crops.
    monkeypatch.setattr(jax_dataset, "_native", lambda: None)
    gan_args = ["--crop_size", "10", "16", "10", "--streaming", "--random_crop_size", "6", "8", "4", "--seed", "4"]
    got = common.make_loaders(common_parser().parse_args(_args(tree, tmp_path / "port", *gan_args)), AV45)
    want = jax_common.make_loaders(common_parser().parse_args(_args(tree, tmp_path / "jax", *gan_args)), AV45)
    for port_loader, jax_loader, shape in ((got[0], want[0], (2, 6, 8, 4, 1)), (got[1], want[1], (1, 10, 16, 10, 1))):
        for epoch in (0, 1):
            pairs = list(zip(port_loader.epoch(epoch), jax_loader.epoch(epoch), strict=True))
            assert pairs
            for a, b in pairs:
                assert a.keys() == b.keys() == {"t1", "pet", "info"} and a["t1"].shape == shape
                for key in a:
                    assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
    batch = next(iter(got[0].epoch(2)))
    assert np.allclose(batch["t1"].max(axis=(1, 2, 3, 4)), 1.0)  # each crop re-max-normalised
    assert not (tmp_path / "port").exists()  # nothing packed


def common_parser():
    import argparse

    p = argparse.ArgumentParser()
    common.add_common_data_args(p)
    p.add_argument("--exp_dir")
    return p


def test_train_unet_perceptual_weights_and_resume(tree, tmp_path, gan):
    # --perceptual_weights loads the JAX package's LPIPS .npz (flat "/" keys);
    # the checkpoint carries the network and --resume restores it.
    _, _, _, params = gan
    flat = {"/".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params["p"]["params"])[0]}
    npz = tmp_path / "lpips.npz"
    np.savez(npz, **flat)
    exp = tmp_path / "exp"
    args = _args(tree, exp, "--config", str(tree / "gan.json"), "--crop_size", *map(str, GAN_CROP), "--dtype", "f32",
                 "--device", "cpu", "--use_condition", "--save_every", "1", "--perceptual_weights", str(npz))
    state = train_unet.main(args + ["--epochs", "1"])
    want = perceptual_from_jax_params(params["p"])
    assert all(torch.equal(t, want[k]) for k, t in state.perceptual.state_dict().items())
    ckpt = CheckpointManager(str(exp / "conditional" / "AV45" / "ckpt"))
    assert set(ckpt.restore()["perceptual"]) == set(want)
    records = [json.loads(line) for line in open(exp / "conditional" / "AV45" / "log" / "metrics.jsonl")]
    assert records and all(np.isfinite(r["g_loss"]) for r in records)
    resumed = train_unet.main([a for a in args if a not in ("--perceptual_weights", str(npz))]
                              + ["--epochs", "2", "--resume"])
    assert resumed.step == 2 * state.step
    assert all(torch.equal(t, want[k]) for k, t in resumed.perceptual.state_dict().items())


@pytest.mark.parametrize("case", ["random", "ties", "one_class", "no_positive_predictions"])
def test_metrics_match_sklearn(case):
    # the JAX package's metrics are scikit-learn's; AUC also against roc_auc_score directly
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 2, 40)
    logits = rng.standard_normal((40, 2)).astype(np.float32)
    if case == "ties":
        logits = np.round(logits, 0)  # many tied class-1 probabilities
    elif case == "one_class":
        labels = np.zeros(40, np.int64)
    elif case == "no_positive_predictions":
        logits[:, 0] += 10.0
    got = classification.classification_metrics(labels, logits)
    want = jax_cls.classification_metrics(labels, logits)
    probs = classification.softmax_np(logits)
    assert set(got) == set(want) == {"accuracy", "precision", "recall", "f1", "auc"}
    for key in ("accuracy", "precision", "recall", "f1"):
        assert got[key] == pytest.approx(want[key], abs=1e-12), key
    if case == "one_class":
        assert np.isnan(got["auc"]) and np.isnan(want["auc"])
    else:
        assert got["auc"] == pytest.approx(skm.roc_auc_score(labels, probs[:, 1]), abs=1e-12)
    preds = logits.argmax(-1)
    assert np.array_equal(classification.confusion_matrix(labels, preds), skm.confusion_matrix(labels, preds,
                                                                                                labels=[0, 1]))
    assert classification.metrics_row(got) == jax_cls.metrics_row(want) or case == "one_class"


def test_confusion_matrix_figure(tmp_path):
    path = str(tmp_path / "cm" / "fig.jpg")
    assert classification.save_confusion_matrix_figure(np.array([0, 1, 1]), np.array([0, 0, 1]), path) == path
    assert os.path.getsize(path) > 0


def _unpacked(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["atten_encoder_def"]["s2d"] = False
    return cfg


@pytest.fixture(scope="module")
def classifier():
    """JAX's classifier (PET + T1, K covariates) packed and unpacked, its random params."""
    models = {layout: jax_classifier.build_model(cfg, in_channels=2, n_covariates=K, dtype=jnp.float32)
              for layout, cfg in (("packed", TINY_CLS_CFG), ("unpacked", _unpacked(TINY_CLS_CFG)))}
    assert models["packed"].s2d and not models["unpacked"].s2d
    x, ctx = jnp.zeros((1, *CROP, 2)), jnp.zeros((1, 1, K))
    params = _random_tree(jax.eval_shape(models["unpacked"].init, jax.random.key(0), x, ctx),
                          np.random.default_rng(6))
    return models, params


def _cls_batch(rng, b=2):
    return {"imgs": rng.random((b, *CROP, 2), np.float32), "info": rng.random((b, 1, K), np.float32),
            "labels": rng.integers(0, 2, b).astype(np.int32)}


def _port_classifier(params):
    model = classifier_task.build_model(TINY_CLS_CFG, in_channels=2, input_shape=CROP, n_covariates=K,
                                        dtype=torch.float32, device="cpu")
    model.load_state_dict(encoder_from_jax_params(params))
    return model


@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_classifier_forward_matches_jax(classifier, layout):
    # fp32, summation order only: the logits within 1e-5 of max|out|
    models, params = classifier
    batch = _cls_batch(np.random.default_rng(7), b=3)
    want = jax.jit(jax_classifier.make_predict_fn(models[layout], use_tabular=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    predict = classifier_task.make_predict_fn(_port_classifier(params), use_tabular=True)
    got = predict({k: torch.from_numpy(v) for k, v in batch.items()})
    _close(got.numpy(), want, msg=layout)
    assert got.dtype == torch.float32 and np.ptp(np.asarray(want)) > 0.01


def test_weighted_cross_entropy_matches_jax():
    rng = np.random.default_rng(8)
    logits, labels = rng.standard_normal((6, 2)).astype(np.float32), rng.integers(0, 2, 6).astype(np.int32)
    want = float(jax_classifier.weighted_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = classifier_task.weighted_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)).item()
    assert got == pytest.approx(want, rel=1e-6)
    assert classifier_task.CLASS_WEIGHTS == jax_classifier.CLASS_WEIGHTS


def test_classifier_train_step_matches_jax_over_three_steps(classifier):
    # Three steps with dropout off (JAX draws it from its key), each from JAX's
    # parameters (the port's Adam moments run on): the loss, accuracy and logits,
    # each step's gradients (JAX's from its Adam moments) within 1e-4 of each
    # max|grad|, and the parameters after the last step within 2 lr.
    models, params = classifier
    lr = TINY_CLS_CFG["training"]["base_lr"]
    jax_step = jax.jit(jax_classifier.make_train_step(models["packed"], use_tabular=True, dropout=False))
    jax_state = jax_classifier.ClassifierState(model=TrainState.create(params, jax_adam(lr)),
                                               step=jnp.zeros((), jnp.int32))
    state = classifier_task.init_state(_port_classifier(params), lr)
    step = classifier_task.make_train_step(use_tabular=True, dropout=False)
    rng = np.random.default_rng(9)
    for i in range(3):
        state.model.load_state_dict(encoder_from_jax_params(_np_tree(jax_state.model.params)))
        batch = _cls_batch(rng)
        new_state, want = jax_step(jax_state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(i))
        grads = _adam_grads(new_state.model, jax_state.model)
        jax_state = new_state
        got = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(got) == set(want) == {"ce_loss", "accuracy", "logits"}
        np.testing.assert_allclose(float(got["ce_loss"]), float(want["ce_loss"]), rtol=1e-4, err_msg=f"step {i}")
        assert float(got["accuracy"]) == float(want["accuracy"])
        _close(got["logits"].numpy(), want["logits"], msg=f"step {i} logits")
        _assert_grads_close(state.model, encoder_from_jax_params(grads), f"step {i}")
    assert state.step == int(jax_state.step) == 3
    want = encoder_from_jax_params(_np_tree(jax_state.model.params))
    for name, t in state.model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), atol=2 * lr, rtol=0, err_msg=name)


def _cls_args(root, exp, *extra):
    return _args(root, exp, "--converter_csv", str(root / "conv.csv"), "--config", str(root / "cls.json"),
                 "--crop_size", *map(str, CROP), "--dtype", "f32", "--use_T1", "--use_tabular_info", *extra)


def test_classifier_clis_end_to_end_on_cpu(tree, tmp_path, capsys):
    exp = tmp_path / "exp"
    state = train_classifier.main(_cls_args(tree, exp, "--device", "cpu", "--epochs", "2", "--save_every", "1"))
    run = exp / "pet_t1_tab"
    assert state.step == 6  # 6 training sessions at batch 2
    assert (run / "packed_train" / "volumes.npy").exists() and (run / "packed_eval" / "volumes.npy").exists()
    meta = json.loads((run / "ckpt" / "meta.json").read_text())
    assert meta["last_epoch"] == 1 and np.isfinite(meta["best_metric"])
    assert (run / "log" / "cm_epoch1.jpg").exists()
    records = [json.loads(line) for line in open(run / "log" / "metrics.jsonl", encoding="utf-8")]
    assert [r["prefix"] for r in records] == ["training", "eval"] * 2
    out = capsys.readouterr().out
    assert "train 6 sessions, eval 2 sessions" in out and out.count(" eval:  ") == 2

    test_args = _cls_args(tree, run, "--device", "cpu", "--best")
    real = test_mci.main(test_args)
    assert set(real) == {"accuracy", "precision", "recall", "f1", "auc"} and np.isfinite(real["auc"])
    fake = test_mci.main(test_args + ["--test_fake_pet", "--fake_pet_dir", str(tree / "fake")])
    assert set(fake) == set(real) and (run / "confusion_test.jpg").exists()
    assert "2 test sessions (synthesized PET)" in capsys.readouterr().out

    # a real-PET eval store refused for a synthesized-PET run
    with pytest.raises(SystemExit, match="built from real PET"):
        train_classifier.main(_cls_args(tree, exp, "--device", "cpu", "--epochs", "1", "--test_fake_pet",
                                        "--fake_pet_dir", str(tree / "fake"), "--eval_packed_dir",
                                        str(run / "packed_eval")))
    streamed = train_classifier.main(_cls_args(tree, tmp_path / "s", "--device", "cpu", "--epochs", "1",
                                               "--streaming", "--no_attention", "--test_fake_pet",
                                               "--fake_pet_dir", str(tree / "fake"), "--config",
                                               str(tree / "cls.json")))
    assert streamed.step == 3 and not (tmp_path / "s" / "pet_t1_tab_noattn" / "packed_train").exists()


def test_classifier_clis_need_cuda_unless_asked(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (train_classifier.main, test_mci.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(_cls_args(tree, tmp_path / "exp"))
