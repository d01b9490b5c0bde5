"""Module parity of the PyTorch port's AttenUNet blocks against the JAX package.

Each case builds the flax module, draws EVERY parameter from a seeded numpy
generator (zero-initialised output convs included, or the residual branch
would vanish), carries the weights over with `convert_tree` and compares the
outputs on the same numpy input. JAX is channels-last, the port NCDHW.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cips_tpu.models import blocks as jb
from cips_tpu_torch.data.jax_params import convert_tree
from cips_tpu_torch.models import blocks as tb

SPATIAL = (4, 6, 4)


def _case(name):
    """(flax module, port module, input channels, context width or None, wrap key)."""
    if name == "groupnorm":
        return jb.GroupNorm(4, 1e-6), tb.GroupNorm(4, 16, 1e-6), 16, None, None
    if name == "resnet":
        return (jb.ResnetBlock(3, 24, norm_num_groups=4), tb.ResnetBlock(3, 16, 24, norm_num_groups=4), 16, None, None)
    if name == "resnet_up":
        return (jb.ResnetBlock(3, 8, up=True, norm_num_groups=4),
                tb.ResnetBlock(3, 16, 8, up=True, norm_num_groups=4), 16, None, None)
    if name == "resnet_down":
        return (jb.ResnetBlock(3, 16, down=True, norm_num_groups=4),
                tb.ResnetBlock(3, 16, 16, down=True, norm_num_groups=4), 16, None, None)
    if name == "spatial_transformer":
        return (jb.SpatialTransformer(3, 16, 2, 8, norm_num_groups=4, cross_attention_dim=5),
                tb.SpatialTransformer(3, 16, 2, 8, norm_num_groups=4, cross_attention_dim=5), 16, 5, None)
    if name == "attention_block":
        return (jb.AttentionBlock(3, 16, num_head_channels=8, norm_num_groups=4),
                tb.AttentionBlock(3, 16, num_head_channels=8, norm_num_groups=4), 16, None, None)
    if name == "geglu":
        return jb.GEGLUFeedForward(16), tb.GEGLUFeedForward(16), 16, None, "ff"
    if name == "downsample_conv":
        return jb.Downsample(3, True, 24), tb.Downsample(3, 16, True, 24), 16, None, None
    if name == "upsample_conv":
        return jb.Upsample(3, True, 8), tb.Upsample(3, 16, True, 8), 16, None, None
    raise KeyError(name)


def _run(name, dtype):
    jmod, tmod, cin, ctx_dim, wrap = _case(name)
    if dtype == "bfloat16" and hasattr(jmod, "dtype"):
        jmod = jmod.clone(dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    if name == "geglu":
        x = rng.standard_normal((2, 24, cin)).astype(np.float32)
    else:
        x = rng.standard_normal((2, *SPATIAL, cin)).astype(np.float32)
    args = (jnp.asarray(x, dtype),)
    targs = (torch.from_numpy(x).to(getattr(torch, dtype)),)
    if name != "geglu":
        targs = (targs[0].movedim(-1, 1),)
    if ctx_dim:
        ctx = rng.standard_normal((2, 1, ctx_dim)).astype(np.float32)
        args += (jnp.asarray(ctx, dtype),)
        targs += (torch.from_numpy(ctx).to(getattr(torch, dtype)),)
    shapes = jax.eval_shape(jmod.init, jax.random.key(0), *args)
    params = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.5).astype(np.float32), shapes
    )
    want = np.asarray(jax.jit(jmod.apply)(params, *args), np.float32)
    tree = params["params"] if wrap is None else {wrap: params["params"]}
    state = convert_tree(jax.tree_util.tree_map(np.asarray, tree))
    if wrap is not None:
        state = {k[len(wrap) + 1:]: v for k, v in state.items()}
    tmod.load_state_dict(state)
    with torch.no_grad():
        got = tmod(*targs)
    if name != "geglu":
        got = got.movedim(1, -1)
    assert got.dtype == targs[0].dtype
    return got.float().numpy(), want


NAMES = ["groupnorm", "resnet", "resnet_up", "resnet_down", "spatial_transformer", "attention_block", "geglu",
         "downsample_conv", "upsample_conv"]


@pytest.mark.parametrize("name", NAMES)
def test_block_parity_f32(name):
    # fp32 in both frameworks: only convolution/matmul algorithms and
    # summation orders differ (~1e-6 relative); 1e-4 leaves room for outputs
    # of magnitude ~10.
    got, want = _run(name, "float32")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["groupnorm", "resnet_down", "spatial_transformer"])
def test_block_parity_bf16(name):
    # bf16 rounds at other points in the two frameworks (conv accumulation,
    # avg-pool sums, P before P.V), each worth ~2^-8 relative; compare against
    # the output scale.
    got, want = _run(name, "bfloat16")
    np.testing.assert_allclose(got, want, atol=5e-2 * np.abs(want).max(), rtol=0)


def test_up_down_resample_and_heads():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 6, 2, 3)).astype(np.float32)
    xt = torch.from_numpy(x).movedim(-1, 1)
    np.testing.assert_array_equal(
        tb.nearest_upsample_2x(xt).movedim(1, -1).numpy(), np.asarray(jb.nearest_upsample_2x(jnp.asarray(x)))
    )
    np.testing.assert_allclose(
        tb.avg_pool_2x(xt).movedim(1, -1).numpy(), np.asarray(jb.avg_pool_2x(jnp.asarray(x))), atol=1e-6
    )
    for channels, head in [(128, 32), (16, 0), (16, 5), (16, 32), (16, None)]:
        assert tb.heads_for(channels, head) == jb.heads_for(channels, head)
    for has_attn in (False, True):
        for cond in (False, True):
            assert tb.attention_mode(has_attn, cond) == jb.attention_mode(has_attn, cond)
