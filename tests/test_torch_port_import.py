"""The reference-checkpoint import (`data.torch_import`, `cli.import_torch_ckpt`)
against the JAX package's importer on the CPU.

The repo holds no reference checkpoint, so the test writes one the way the
reference does (``torch.save`` of DDP state dicts, every key under ``module.``)
from a port AttenUNet and PatchDiscriminator with random weights, with the
names the port's models do not use: a dead ``time_embed`` and MONAI-generative's
PatchDiscriminator names (``initial_conv``, ``0``, ``final_conv``, ``adn.N``).
The JAX importer's flax model and the port's imported model must give the
same forward within 1e-5 of its scale in fp32; the CLI's checkpoint must
serve through ``output_predict --epoch N`` and resume through ``train_unet
--resume``; each other importer must load its model, as JAX's does.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cips_tpu.data import torch_import as jax_import
from cips_tpu.training import unet_synthesis as jax_synthesis
from cips_tpu_torch.cli import import_torch_ckpt, output_predict, train_unet
from cips_tpu_torch.data import jax_params, nifti, torch_import
from cips_tpu_torch.models import bmgan
from cips_tpu_torch.training import causal_task, unet_synthesis
from cips_tpu_torch.training.common import CheckpointManager
from test_cli_workloads import TINY_CAUSAL_CFG
from test_torch_port_bmgan import E_KW, G_KW, SHAPE as BMGAN_SHAPE
from test_torch_port_train import CFG

AV45 = ["ABETA", "Age", "Sex", "APOE4", "PTEDUCAT"]
CROP = (12, 16, 12)
EPOCH = 7


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _randomise(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter drawn from ``seed``: kernels at 1/sqrt(fan-in), vectors at 0.1
    (the zero-initialised output convs included)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            scale = p[0].numel() ** -0.5 if p.ndim > 1 else 0.1
            p.copy_(torch.randn(p.shape, generator=g) * scale)
    return model


def _monai_discriminator_names(state: dict) -> dict:
    """The port's PatchDiscriminator names as MONAI-generative's Sequential
    names them: initial_conv, 0 .. n-1 (conv + adn.N), final_conv."""
    out = {}
    for key, value in state.items():
        module, leaf = key.rsplit(".", 1)
        if module == "conv_0.conv":
            name = "initial_conv.conv"
        elif module == "conv_out.conv":
            name = "final_conv.conv"
        elif module.startswith("conv_"):
            name = ("penultimate" if "penultimate" in module else str(int(module.split("_")[1].split(".")[0]) - 1))
            name = f"{name}.conv"
        else:
            name = ("penultimate" if "penultimate" in module else str(int(module.split("_")[1]) - 1)) + ".adn.N"
        out[f"{name}.{leaf}"] = value
    last = max(int(k.split(".")[0]) for k in out if k[0].isdigit()) + 1
    return {k.replace("penultimate", str(last)): v for k, v in out.items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """A reference-style .ckpt of a port G and D with random weights, the port models it came from, and a tree."""
    root = tmp_path_factory.mktemp("import")
    g, d, _ = unet_synthesis.build_models(CFG, len(AV45), dtype=torch.float32, device="cpu", seed=1)
    _randomise(g, 2)
    _randomise(d, 3)
    unet = {f"module.{k}": v.clone() for k, v in g.state_dict().items()}
    unet["module.time_embed.0.weight"] = torch.ones(4, 8)  # the reference's dead timestep path
    disc = {f"module.{k}": v.clone() for k, v in _monai_discriminator_names(d.state_dict()).items()}
    path = str(root / "ref_epoch7.ckpt")
    torch.save({"unet": unet, "discriminator": disc, "epoch": EPOCH, "eval_loss": torch.tensor(0.25)}, path)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(3):
        for kind, date in (("t1", "2012-01-01"), ("pet", "2012-01-15")):
            nifti.write(str(root / kind / f"s{i}" / date / "img.nii.gz"), rng.random((14, 18, 14)).astype(np.float32))
        rows.append(f"s{i},2012-01-01,2012-01-15,{500 + 150 * i},{70 + i},{'Female' if i % 2 else 'Male'},{i % 3},"
                    f"{12 + i}")
    (root / "m.csv").write_text("Subject,T1_date,PET_date," + ",".join(AV45) + "\n" + "\n".join(rows) + "\n")
    (root / "stats.json").write_text(json.dumps({"ABETA": [200, 1700], "Age": [55, 95], "PTEDUCAT": [6, 20]}))
    (root / "cfg.json").write_text(json.dumps(CFG))
    return root, path, g, d


def test_the_import_matches_jax_importer_forward(reference):
    root, path, g_src, d_src = reference
    g, d, _ = unet_synthesis.build_models(CFG, len(AV45), dtype=torch.float32, device="cpu", seed=9)
    out = torch_import.import_checkpoint(path, g, d)
    assert out["epoch"] == EPOCH and out["eval_loss"] == 0.25 and out["discriminator"] is None
    for model, src in ((g, g_src), (d, d_src)):  # the mapped names carry every tensor
        for k, v in src.state_dict().items():
            assert torch.equal(model.state_dict()[k], v), k

    imported = jax_import.import_checkpoint(path, num_levels=len(CFG["atten_unet_def"]["num_channels"]))
    jax_g, jax_d, _ = jax_synthesis.build_models(CFG, n_covariates=len(AV45), dtype=jnp.float32, remat=False, s2d=False)
    rng = np.random.default_rng(1)
    x = rng.random((2, *CROP, 1), np.float32)
    ctx = rng.random((2, 1, len(AV45)), np.float32)
    want = np.asarray(jax.jit(jax_g.apply)(imported["unet"], jnp.asarray(x), jnp.asarray(ctx)))
    with torch.no_grad():
        got = g(torch.from_numpy(x), torch.from_numpy(ctx)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    d_params = {"params": jax_import.import_patch_discriminator(
        torch.load(path, weights_only=False)["discriminator"], CFG["discriminator"]["num_layers_d"])}
    want_d = np.asarray(jax.jit(jax_d.apply)(d_params, jnp.asarray(x))[-1])
    with torch.no_grad():
        got_d = d(torch.from_numpy(x))[-1].numpy()
    assert np.abs(got_d - want_d).max() <= 1e-5 * np.abs(want_d).max()


def test_a_misfit_is_refused_and_a_misfit_discriminator_skipped(reference, tmp_path, capsys):
    root, path, _, _ = reference
    wide = dict(CFG, atten_unet_def=dict(CFG["atten_unet_def"], num_channels=[16, 16]))
    (tmp_path / "wide.json").write_text(json.dumps(wide))
    with pytest.raises(SystemExit, match="wrong --config / --pet_kind / --use_condition"):
        import_torch_ckpt.main(["--torch_ckpt", path, "--exp_dir", str(tmp_path / "e"), "--config",
                                str(tmp_path / "wide.json"), "--use_condition", "--crop_size", *map(str, CROP)])
    deeper = dict(CFG, discriminator=dict(CFG["discriminator"], num_layers_d=3))
    (tmp_path / "deeper.json").write_text(json.dumps(deeper))
    import_torch_ckpt.main(["--torch_ckpt", path, "--exp_dir", str(tmp_path / "e"), "--config",
                            str(tmp_path / "deeper.json"), "--use_condition", "--crop_size", *map(str, CROP)])
    assert "skipping discriminator: discriminator: expected 5 convs" in capsys.readouterr().out


def test_the_cli_checkpoint_serves_and_resumes(reference, tmp_path):
    root, path, g_src, _ = reference
    exp = str(tmp_path / "exp")
    ckpt_dir = import_torch_ckpt.main(["--torch_ckpt", path, "--exp_dir", exp, "--config", str(root / "cfg.json"),
                                       "--use_condition", "--crop_size", *map(str, CROP)])
    meta = json.loads(open(os.path.join(ckpt_dir, "meta.json"), encoding="utf-8").read())
    assert meta == {"last_epoch": EPOCH, "best_metric": 0.25, "best_epoch": EPOCH}
    payload = CheckpointManager(ckpt_dir).restore(epoch=EPOCH)
    assert payload["step"] == 0 and payload["optimizer_g"]["state"] == {} and payload["epoch"] == EPOCH
    data = ["--PET_dir", str(root / "pet"), "--T1_dir", str(root / "t1"), "--min_and_max", str(root / "stats.json"),
            "--crop_size", *map(str, CROP), "--use_condition", "--device", "cpu", "--dtype", "f32",
            "--exp_dir", exp, "--config", str(root / "cfg.json")]
    results = output_predict.main(data + ["--eval_info_csv", str(root / "m.csv"), "--epoch", str(EPOCH),
                                          "--output_dir", str(tmp_path / "pred")])
    assert len(list((tmp_path / "pred").rglob("rec.nii.gz"))) == 3
    assert all(np.isfinite(v) for v in results.summary().values())
    state = train_unet.main(data + ["--training_info_csv", str(root / "m.csv"), "--eval_info_csv", str(root / "m.csv"),
                                    "--batch_size", "2", "--resume", "--epochs", str(EPOCH + 2), "--max_steps", "1",
                                    "--streaming"])
    assert state.step == 1 and state.opt_g.state_dict()["state"][0]["step"].item() == 1
    moved = [(state.g.state_dict()[k] - v).abs().max().item() for k, v in g_src.state_dict().items()]
    assert 0 < max(moved) <= 2e-3  # one Adam step (lr 1e-3) from the imported weights


def test_each_other_importer_loads_its_model_as_jax_does():
    enc, t1_dec, pet_dec, _, _ = causal_task.build_models(TINY_CAUSAL_CFG, 5, dtype=torch.float32, device="cpu", seed=2)
    for model, port_import, jax_side, back in (
        (enc, torch_import.import_diffusion_encoder,
         lambda sd: jax_import.import_diffusion_encoder(sd, num_levels=2), jax_params.encoder_from_jax_params),
        (t1_dec, torch_import.import_vae_decoder,
         lambda sd: jax_import.import_vae_decoder(sd, num_channels=[8, 8], num_res_blocks=1),
         jax_params.vae_decoder_from_jax_params),
        (pet_dec, torch_import.import_diffusion_decoder,
         lambda sd: jax_import.import_diffusion_decoder(sd, num_levels=2),
         jax_params.diffusion_decoder_from_jax_params),
    ):
        src = {k: v.clone() for k, v in _randomise(model, 4).state_dict().items()}
        reference_sd = {f"module.{k}": v for k, v in src.items() if not k.startswith(("out_norm.", "conv_out."))}
        if model is enc:
            reference_sd["module.time_embed.2.bias"] = torch.zeros(3)
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
        port_import(reference_sd, model)
        for k, v in src.items():  # the encoder's spatial head, absent from the file, keeps the model's (zeros)
            lacking = model is enc and k.startswith(("out_norm.", "conv_out."))
            assert torch.equal(model.state_dict()[k], torch.zeros_like(v) if lacking else v), k
        # JAX's importer reads the same names: its tree maps back onto the same tensors
        back_sd = back({"params": jax_side(reference_sd)})
        for k, v in back_sd.items():
            assert torch.equal(v, src[k]), k

    g = _randomise(bmgan.DenseUNetGenerator(dtype=torch.float32, **G_KW), 5)
    e = _randomise(bmgan.ResNetEncoder(input_shape=BMGAN_SHAPE, dtype=torch.float32, **E_KW), 6)
    for model, port_import, jax_side, back in (
        (g, torch_import.import_bmgan_generator, jax_import.import_bmgan_generator,
         jax_params.bmgan_generator_from_jax_params),
        (e, torch_import.import_bmgan_encoder, jax_import.import_bmgan_encoder,
         jax_params.bmgan_encoder_from_jax_params),
    ):
        norms = {f"{n}.{leaf}" for n, m in model.named_modules() if isinstance(m, torch_import.InstanceNorm)
                 for leaf in ("weight", "bias")}
        src = {k: v.clone() for k, v in model.state_dict().items()}
        reference_sd = {f"module.{k}": v for k, v in src.items() if k not in norms}  # affine-free norms
        port_import(reference_sd, model)
        for k, v in src.items():
            want = v if k not in norms else (torch.ones_like(v) if k.endswith("weight") else torch.zeros_like(v))
            assert torch.equal(model.state_dict()[k], want), k
        back_sd = back({"params": jax_side(reference_sd)})
        assert back_sd.keys() == src.keys()
        for k, v in back_sd.items():
            assert torch.equal(v, model.state_dict()[k]), k
