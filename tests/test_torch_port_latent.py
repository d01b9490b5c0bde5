"""The KL-VAE's Encoder and AutoencoderKL, the latent dataset and LPIPS's random
slice subset against the JAX package on the CPU, in fp32.

  * `Encoder` and `AutoencoderKL` with flax's weights carried by
    `jax_params.vae_encoder_from_jax_params` / `autoencoder_kl_from_jax_params`
    (the non-local blocks on and off): mu, sigma and the reconstruction within
    1e-5 of their scale; the reparameterised forward is mu + sigma * eps, eps
    drawn from the caller's `torch.Generator`;
  * `PairedLatentDataset` against JAX's on the files `cli.gen_latents` writes;
  * LPIPS's random subset: the indices JAX's ``rng`` branch draws (its
    ``jax.random.choice`` per axis), handed to the port, give JAX's loss within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cips_tpu.data import dataset as jax_dataset
from cips_tpu.models.autoencoder_kl import AutoencoderKL as JaxAutoencoderKL
from cips_tpu.models.autoencoder_kl import Encoder as JaxEncoder
from cips_tpu.models.perceptual import PerceptualLoss as JaxPerceptualLoss
from cips_tpu_torch.data import jax_params, nifti
from cips_tpu_torch.data.dataset import PairedLatentDataset
from cips_tpu_torch.models.autoencoder_kl import AutoencoderKL, Encoder
from cips_tpu_torch.models.perceptual import PerceptualLoss, slice_subsets

VAE = dict(latent_channels=3, num_channels=(8, 16), num_res_blocks=1, norm_num_groups=4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _params(model, seed, *inputs):
    """flax params of ``model`` drawn from ``seed`` (tests/test_torch_port_train.py's
    draw) on the shapes `jax.eval_shape` gives, with no init run."""
    from test_torch_port_train import _random_tree

    shapes = jax.eval_shape(model.init, jax.random.key(0), *(jnp.asarray(x) for x in inputs))
    return _random_tree(shapes, np.random.default_rng(seed))


def _close(got: torch.Tensor, want, what: str, tol: float = 1e-5) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape, what
    assert np.abs(got.detach().numpy() - want).max() <= tol * np.abs(want).max(), what


@pytest.mark.parametrize("nonlocal_attn", [False, True])
def test_autoencoder_kl_matches_flax(nonlocal_attn):
    cfg = dict(VAE, with_encoder_nonlocal_attn=nonlocal_attn, with_decoder_nonlocal_attn=nonlocal_attn)
    x = np.random.default_rng(0).random((2, 8, 8, 8, 1), np.float32)
    flax_model = JaxAutoencoderKL(**cfg)
    params = _params(flax_model, 1, x)
    rec, mu, sigma = jax.jit(flax_model.apply)(params, jnp.asarray(x))
    model = AutoencoderKL(**cfg)
    model.load_state_dict(jax_params.autoencoder_kl_from_jax_params(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        for g, w, what in zip(got, (rec, mu, sigma), ("reconstruction", "mu", "sigma")):
            _close(g, w, what)
        mu_t, sigma_t = model.encode(torch.from_numpy(x))
        sampled, _, _ = model(torch.from_numpy(x), generator=torch.Generator().manual_seed(3))
        eps = torch.randn(mu_t.shape, generator=torch.Generator().manual_seed(3))
        assert torch.allclose(sampled, model.decode(mu_t + sigma_t * eps), rtol=0, atol=0)
        assert not torch.allclose(sampled, got[0])
    names = set(model.state_dict())
    assert {"encoder.blocks.0.conv.weight", "encoder.blocks.2.conv.conv.weight", "encoder.conv_mu.conv.weight",
            "encoder.conv_log_var.conv.bias", "decoder.blocks.0.conv.weight"} <= names  # MONAI's flat blocks


def test_encoder_alone_matches_flax():
    x = np.random.default_rng(2).random((1, 8, 12, 8, 1), np.float32)
    flax_model = JaxEncoder(latent_channels=4, num_channels=(8, 8, 16), num_res_blocks=(1, 2, 1), norm_num_groups=4)
    params = _params(flax_model, 2, x)
    mu, log_var = jax.jit(flax_model.apply)(params, jnp.asarray(x))
    model = Encoder(latent_channels=4, num_channels=(8, 8, 16), num_res_blocks=(1, 2, 1), norm_num_groups=4)
    model.load_state_dict(jax_params.vae_encoder_from_jax_params(params), strict=True)
    with torch.no_grad():
        got_mu, got_log_var = model(torch.from_numpy(x))
    _close(got_mu, mu, "mu")
    _close(got_log_var, log_var, "log_var")
    assert got_mu.shape == (1, 2, 3, 2, 4)


def test_paired_latent_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    rows = []
    for i in range(4):
        nifti.write(str(tmp_path / "t1" / f"s{i}" / "2014-01-01" / "t1.nii.gz"),
                    (rng.random((11, 14, 9)) * 50).astype(np.float32))
        if i != 2:  # one session without a latent: skipped by both
            folder = tmp_path / "latents" / f"s{i}" / "2014-03-01"
            folder.mkdir(parents=True)
            np.save(folder / "latent.npy", rng.standard_normal((3, 4, 3, 6)).astype(np.float32))
        rows.append(f"s{i},2014-01-01,2014-03-01,{70 + i}")
    (tmp_path / "m.csv").write_text("Subject,T1_date,PET_date,Age\n" + "\n".join(rows) + "\n")
    kw = dict(info_csv=str(tmp_path / "m.csv"), latent_dir=str(tmp_path / "latents"), t1_dir=str(tmp_path / "t1"),
              crop_size=(12, 12, 8), need_values=["Age"], min_and_max={"Age": (50, 90)})
    got, want = PairedLatentDataset(**kw), jax_dataset.PairedLatentDataset(**kw)
    assert len(got) == len(want) == 3 and got.paths == want.paths
    for i in range(3):
        a, b = got[i], want[i]
        np.testing.assert_allclose(a[0], b[0], rtol=1e-6)  # the T1, decoded natively here
        for x, y in zip(a[1:3], b[1:3]):
            np.testing.assert_array_equal(x, y)
        assert a[3:] == b[3:]


def test_lpips_random_subset_matches_jax_with_its_drawn_indices():
    rng = np.random.default_rng(4)
    a, b = (rng.random((2, 8, 10, 6, 1), np.float32) for _ in range(2))
    flax_model = JaxPerceptualLoss(network_type="squeeze")
    params = _params(flax_model, 3, a, b)
    key = jax.random.key(5)
    want = float(jax.jit(flax_model.apply)(params, jnp.asarray(a), jnp.asarray(b), rng=key))
    # the indices JAX's rng branch draws: one key per axis, int(m * 0.5) of m = batch x slices
    subsets = [torch.from_numpy(np.asarray(jax.random.choice(k, 2 * n, (n,), replace=False)).astype(np.int64))
               for k, n in zip(jax.random.split(key, 3), (8, 10, 6))]
    model = PerceptualLoss(network_type="squeeze")
    model.load_state_dict(jax_params.perceptual_from_jax_params(params))
    got = float(model(torch.from_numpy(a), torch.from_numpy(b), subsets=subsets))
    assert abs(got - want) <= 1e-5 * abs(want)
    assert abs(float(model(torch.from_numpy(a), torch.from_numpy(b))) - got) > 1e-5 * abs(want)  # not every k-th
    drawn = slice_subsets((2, 8, 10, 6), 0.5, torch.Generator().manual_seed(1))
    assert [len(s) for s in drawn] == [8, 10, 6] and all(len(set(s.tolist())) == len(s) for s in drawn)
    again = slice_subsets((2, 8, 10, 6), 0.5, torch.Generator().manual_seed(1))
    assert all(torch.equal(x, y) for x, y in zip(drawn, again))
    assert float(model(torch.from_numpy(a), torch.from_numpy(b), generator=torch.Generator().manual_seed(1))) == \
        float(model(torch.from_numpy(a), torch.from_numpy(b), subsets=drawn))
