"""Whole-model parity: the PyTorch port's AttenUNet against the JAX AttenUNet.

A tiny conditional model (channels (8, 16, 16), 4 groups, cross-attention at
the last level with 8-channel heads, K = 5 covariates, crop (8, 16, 8)) with
every parameter drawn from a seeded numpy generator. The port computes the
unpacked function; the JAX model is run both unpacked and with its default
space-to-depth packing, which has the same parameters and the same math.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cips_tpu.data.torch_import import import_atten_unet
from cips_tpu.models.atten_unet import AttenUNet as JaxAttenUNet
from cips_tpu_torch.data.jax_params import from_jax_params
from cips_tpu_torch.models.atten_unet import AttenUNet
from cips_tpu_torch.models.discriminator import PatchDiscriminator
from cips_tpu_torch.training import unet_synthesis

CFG = dict(
    spatial_dims=3, in_channels=1, out_channels=1, num_channels=(8, 16, 16), num_res_blocks=2,
    attention_levels=(False, False, True), norm_num_groups=4, norm_eps=1e-6, resblock_updown=True,
    num_head_channels=(0, 0, 8), with_conditioning=True, cross_attention_dim=5,
)
CROP = (8, 16, 8)


@pytest.fixture(scope="module")
def jax_model():
    rng = np.random.default_rng(0)
    x = rng.random((2, *CROP, 1), dtype=np.float32)
    ctx = rng.random((2, 1, 5), dtype=np.float32)
    model = JaxAttenUNet(**CFG)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.asarray(x), jnp.asarray(ctx))
    params = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32), shapes
    )
    return params, x, ctx


@pytest.mark.parametrize("s2d", [False, True], ids=["unpacked", "default_packing"])
def test_forward_matches_jax_f32(jax_model, s2d):
    # fp32 in both frameworks; ~30 conv/GN/attention layers of summation-order
    # noise. The JAX full-model gate calibrates that at ~1e-3 relative
    # (tests/test_halo_full_model.py); this model measures ~1e-6.
    params, x, ctx = jax_model
    jm = JaxAttenUNet(**CFG, s2d=s2d)
    if s2d:
        assert jm.level_factors()[0] is not None
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(ctx)))
    model = AttenUNet(**CFG)
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params), 3))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(ctx)).numpy()
    assert got.shape == want.shape == (2, *CROP, 1)
    scale = np.abs(want).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


def test_forward_matches_jax_self_attention_conv_resample():
    # The other factory arms: no conditioning (AttentionBlock, self-attention)
    # and strided-conv / upsample-conv transitions instead of resnet up/down.
    cfg = {**CFG, "with_conditioning": False, "cross_attention_dim": None, "resblock_updown": False}
    rng = np.random.default_rng(2)
    x = rng.random((1, *CROP, 1), dtype=np.float32)
    jm = JaxAttenUNet(**cfg)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32), shapes)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    model = AttenUNet(**cfg)
    model.load_state_dict(from_jax_params(params, 3))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_forward_matches_jax_bf16(jax_model):
    # bf16 rounds at other points in the two frameworks through ~30 layers;
    # compare loosely against the output scale.
    params, x, ctx = jax_model
    jm = JaxAttenUNet(**CFG, dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(ctx)), np.float32)
    model = AttenUNet(**CFG, dtype=torch.bfloat16)
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params), 3))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(ctx))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=5e-2 * np.abs(want).max(), rtol=0)


def test_weight_bridge_round_trips_exactly(jax_model):
    params, _, _ = jax_model
    state = from_jax_params(jax.tree_util.tree_map(np.asarray, params), 3)
    assert set(state) == set(AttenUNet(**CFG).state_dict())
    back = import_atten_unet(state, 3)
    flat_want = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_want) == len(flat_got)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(leaf))
    with pytest.raises(ValueError):
        from_jax_params(jax.tree_util.tree_map(np.asarray, params), 4)


def test_build_models_and_condition():
    cfg = {"atten_unet_def": {k: v for k, v in CFG.items() if k not in ("with_conditioning", "cross_attention_dim")}}
    generator, disc, perceptual = unet_synthesis.build_models(cfg, 0, dtype=torch.float32, device="cpu")
    assert isinstance(disc, PatchDiscriminator) and perceptual is None  # no perceptual weight, no LPIPS network
    assert disc.num_layers_d == 3 and disc.conv_0.conv.weight.shape == (64, 1, 4, 4, 4)  # the JAX defaults
    assert generator.down_blocks[2].attentions[0].transformer_blocks[0].attn2.to_k.weight.shape == (16, 1)
    assert generator.out[2].conv.weight.abs().max() == 0  # zero-initialised output conv
    batch = {"t1": torch.rand(2, *CROP, 1), "info": torch.zeros(2, 1, 0)}
    cond = unet_synthesis._condition(batch, True)
    assert cond.shape == (2, 1, 1) and not cond.any()
    info = torch.rand(2, 1, 3)
    assert torch.equal(unet_synthesis._condition({"info": info}, True), info)
    assert not unet_synthesis._condition({"info": info}, False).any()
    out = unet_synthesis.make_predict_fn(generator)(batch)
    assert out.shape == (2, *CROP, 1)
    for bad in (dict(with_conditioning=True), dict(cross_attention_dim=3), dict(norm_num_groups=3)):
        with pytest.raises(ValueError):
            AttenUNet(**{**CFG, "with_conditioning": False, "cross_attention_dim": None, **bad})
