"""Phase-structured packed conv of the PyTorch port against the JAX package.

The port's s2d helpers and kernel packers are held bit-exact to the JAX ones; the
plain `phase_conv` to the Pallas kernel itself, run in TPU interpret mode, and to
the JAX packed convs; each probe variant's plain version to the identity that
defines it. The CUDA kernel runs only on a card; its test skips elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from cips_tpu.ops import s2d as jax_s2d
from cips_tpu.ops.pallas.phase_conv import phase_conv as jax_phase_conv
from cips_tpu_torch.models.atten_unet import AttenUNet, init_params
from cips_tpu_torch.ops import phase_conv as pc
from cips_tpu_torch.ops import s2d
from cips_tpu_torch.scripts import probe_phase_conv


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def test_s2d_reshapes_bit_exact():
    x = _normal((2, 4, 6, 8, 16), 0)
    packed = s2d.space_to_depth(torch.from_numpy(x))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_s2d.space_to_depth(jnp.asarray(x))))
    xp = _normal((2, 2, 3, 4, 128), 1)
    np.testing.assert_array_equal(s2d.depth_to_space(torch.from_numpy(xp)).numpy(),
                                  np.asarray(jax_s2d.depth_to_space(jnp.asarray(xp))))
    assert torch.equal(s2d.depth_to_space(packed), torch.from_numpy(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_packers_bit_exact(dtype):
    w = torch.from_numpy(_normal((3, 3, 3, 16, 16), 2)).to(dtype)
    wj = jnp.asarray(w.float().numpy(), jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    np.testing.assert_array_equal(s2d.pack_conv_kernel(w).float().numpy(),
                                  np.asarray(jax_s2d.pack_conv_kernel(wj), np.float32))
    phase = s2d.pack_conv_kernel_phase(w)
    assert phase.shape == (2, 2, 2, 128, 128) and phase.dtype == dtype
    np.testing.assert_array_equal(phase.float().numpy(), np.asarray(jax_s2d.pack_conv_kernel_phase(wj), np.float32))
    assert (phase != 0).float().mean().item() == pytest.approx(27 / 64, abs=0.01)  # 27/64 dense for nonzero w


def test_phase_shift_input_bit_exact():
    x = _normal((1, 3, 4, 5, 256), 3)
    np.testing.assert_array_equal(s2d._phase_shift_input(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_s2d._phase_shift_input(jnp.asarray(x))))


@pytest.mark.parametrize("shape,dtype,tol", [
    # bf16: both round an fp32 sum to bf16; the Pallas kernel's interpret-mode dots
    # may round differently, within one bf16 ulp (2^-7 relative) of max|out|
    ((1, 4, 8, 16, 128), jnp.bfloat16, 8e-3),
    # fp32: the sums differ in order only
    ((2, 4, 4, 8, 256), jnp.float32, 1e-5),
], ids=["pc128-bf16", "pc256-f32"])
def test_plain_matches_pallas_interpret(shape, dtype, tol):
    c = shape[-1] // 8
    x = _normal(shape, 4)
    w = _normal((3, 3, 3, c, c), 5, 0.1)
    with pltpu.force_tpu_interpret_mode():
        want = jax_phase_conv(jnp.asarray(x, dtype), jnp.asarray(w), tz=4)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    got = pc.phase_conv(torch.from_numpy(x).to(tdtype), torch.from_numpy(w))
    assert got.dtype == tdtype and got.shape == shape
    assert _rel(got.float().numpy(), want) <= tol


def test_plain_matches_jax_packed_convs():
    # fp32; the JAX packed convs (halo by default, and the XLA phase form) and the
    # port's own packed_conv (the unpacked conv between reshapes) sum in other orders
    x = _normal((2, 3, 5, 4, 128), 6)
    w = _normal((3, 3, 3, 16, 16), 7, 0.2)
    got = pc.phase_conv(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    for want in (jax_s2d.packed_conv(jnp.asarray(x), jnp.asarray(w)),
                 jax_s2d.packed_conv_phase(jnp.asarray(x), jnp.asarray(w)),
                 s2d.packed_conv(torch.from_numpy(x), torch.from_numpy(w)).numpy()):
        assert _rel(got, want) <= 1e-5
    assert torch.equal(pc.packed_conv_phase(torch.from_numpy(x), torch.from_numpy(w)), torch.from_numpy(got))


def test_variant_identities():
    x = torch.from_numpy(_normal((2, 3, 4, 5, 128), 8))
    wp = torch.from_numpy(_normal((2, 2, 2, 128, 128), 9, 0.1))
    _, z, y, xd, _ = x.shape
    assert torch.equal(pc.phase_conv_stage(x, None, "shift"), s2d._phase_shift_input(x)[:, :z, :y, :xd])
    assert torch.equal(pc.phase_conv_stage(x, None, "copy"), x)
    rest = wp.clone()
    rest[0, 0, 0] = 0
    full = pc.phase_conv_stage(x, wp, "full")
    split = pc.phase_conv_stage(x, wp, "one_tap") + pc.phase_conv_stage(x, rest, "full")
    torch.testing.assert_close(split, full, rtol=0, atol=1e-5 * full.abs().max().item())
    # noshift: every group reads x[c + k - 1], a k2 conv over x padded by 1 on each side
    conv = torch.nn.functional.conv3d(x.permute(0, 4, 1, 2, 3), wp.permute(4, 3, 0, 1, 2), padding=1)
    noshift = pc.phase_conv_stage(x, wp, "noshift")
    torch.testing.assert_close(noshift, conv[:, :, :z, :y, :xd].permute(0, 2, 3, 4, 1),
                               rtol=0, atol=1e-5 * noshift.abs().max().item())
    w8 = wp.reshape(8, 128, 128)
    dot = pc.phase_conv_stage(x, w8, "dot")
    torch.testing.assert_close(dot, x @ w8.sum(0), rtol=0, atol=1e-5 * dot.abs().max().item())


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32], ids=["bf16", "f32"])
def test_lane_select_matches_the_probe_arithmetic(dtype):
    # scripts/probe_pallas_dot.py:k_sel's arithmetic in jnp, rounded in x's dtype at each step
    x = _normal((1, 2, 3, 4, 128), 10, 100.0)
    xj = jnp.asarray(x, dtype)
    m1 = jnp.arange(128) % 2 == 0
    v = jnp.where(m1, xj, xj * 2.0)
    v = jnp.where(m1, v, v * 0.5)
    want = np.asarray(jnp.where(m1, v, v * 3.0), np.float32)
    got = pc.lane_select(torch.from_numpy(x).to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_flagship_level0_identity_on_cpu():
    # a tiny AttenUNet whose level 0 has the flagship's 16 channels
    model = AttenUNet(num_channels=(16, 32), num_res_blocks=1, attention_levels=(False, False),
                      norm_num_groups=4, num_head_channels=0)
    init_params(model, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(11).random((2, 8, 16, 8, 1), dtype=np.float32))
    got, want = chip_smoke.level0_tie(model, x, None)
    assert got.shape == want.shape == (2, 4, 8, 4, 128)
    assert _rel(got.numpy(), want.numpy()) <= 1e-5


def test_wrapper_errors():
    x = torch.zeros((1, 2, 2, 2, 128))
    wp = torch.zeros((2, 2, 2, 128, 128))
    with pytest.raises(ValueError, match="multiple of 128"):
        pc.phase_conv_apply(torch.zeros((1, 2, 2, 2, 64)), torch.zeros((2, 2, 2, 64, 64)))
    with pytest.raises(ValueError, match="weights of shape"):
        pc.phase_conv_apply(x, torch.zeros((3, 3, 3, 128, 128)))
    with pytest.raises(ValueError, match="weights of shape"):
        pc.phase_conv_stage(x, wp, "dot")
    with pytest.raises(ValueError, match="takes no weights"):
        pc.phase_conv_stage(x, wp, "shift")
    with pytest.raises(ValueError, match="dtype"):
        pc.phase_conv_apply(x, wp.to(torch.bfloat16))
    with pytest.raises(ValueError, match="unknown variant"):
        pc.phase_conv_stage(x, wp, "nosel")
    # off the CPU a tensor that requires grad raises before any launch (no VJP)
    meta = torch.zeros((1, 2, 2, 2, 128), device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError):
        pc.phase_conv_apply(meta, torch.zeros((2, 2, 2, 128, 128), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        pc.lane_select(torch.zeros((1, 2, 2, 2, 128), device="meta"))
    before = (dict(pc.phase_conv_stage.launches), pc.lane_select.launches)
    pc.phase_conv_apply(x, wp)
    pc.lane_select(x)
    assert (dict(pc.phase_conv_stage.launches), pc.lane_select.launches) == before  # the CPU launches nothing


@pytest.mark.parametrize("argv", [["phase"], ["dot"], ["bisect", "nosel"], ["stages"]])
def test_probe_entry_on_cpu(argv, monkeypatch):
    for name, shape in (("PROBE", (1, 2, 3, 2, 128)), ("WIDE", (1, 2, 2, 2, 256)),
                        ("PHASE_CHECK", (1, 4, 6, 4, 16)), ("STAGES", (1, 2, 3, 2, 128))):
        monkeypatch.setattr(probe_phase_conv, name, shape)
    monkeypatch.setattr(probe_phase_conv, "ITERS", 1)
    result = probe_phase_conv.main(argv + ["--device", "cpu"])
    if argv[0] == "phase":
        assert result["fp32_err"] < 1e-4 and result["level0"]["rel"] <= 1e-2 and result["wide"]["rel"] <= 1e-2
    else:
        assert set(result) == set(probe_phase_conv.MODES[argv[0]] if len(argv) == 1 else argv[1:])
    if argv[0] == "stages":
        assert all(r["finite"] for r in result.values())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)], ids=["bf16", "f32"])
def test_kernel_matches_plain_version_on_card(cuda_device, dtype, tol):
    # a ragged shape: no axis a multiple of any tile; each variant against its plain
    # version computed in fp32 from the same inputs, relative to max|out|
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((1, 5, 7, 9, 128), device=cuda_device, generator=g).to(dtype)
    weights = {"dot": torch.randn((8, 128, 128), device=cuda_device, generator=g).to(dtype) * 0.1}
    for variant in ("full", "noshift", "one_tap"):
        weights[variant] = torch.randn((2, 2, 2, 128, 128), device=cuda_device, generator=g).to(dtype) * 0.1
    for variant in pc.VARIANTS:
        wp = weights.get(variant)
        got = pc.phase_conv_stage(x, wp, variant)
        torch.cuda.synchronize()
        want = pc.phase_conv_stage_reference(x.float(), None if wp is None else wp.float(), variant)
        assert got.dtype == dtype and torch.isfinite(got).all()
        assert (got.float() - want).abs().max().item() <= tol * want.abs().max().item(), variant
    assert torch.equal(pc.lane_select(x), pc.lane_select_reference(x))
