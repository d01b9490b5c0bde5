"""Phase-structured packed conv of the PyTorch port against the JAX package.

The port's s2d helpers and kernel packers are held bit-exact to the JAX ones; the
plain `phase_conv` to the Pallas kernel itself, run in TPU interpret mode, and to
the JAX packed convs; the plain `dot`, `noshift`, `copy`, `shift` and `one_tap` to
the TPU probes' own Pallas kernels (`scripts/probe_pallas_dot.py`,
`scripts/probe_pallas_bisect.py`, `scripts/debug_pallas_stages.py`) in TPU
interpret mode; each probe variant's plain version to the identity that defines
it; the bf16 `dot` kernel's and the fp32 kernel's rounding models to the plain
version. The CUDA kernels run only on a card; their test skips elsewhere.
"""

import collections
import importlib.util
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from cips_tpu.ops import s2d as jax_s2d
from cips_tpu.ops.pallas.phase_conv import phase_conv as jax_phase_conv
from cips_tpu_torch.models.atten_unet import AttenUNet, init_params
from cips_tpu_torch.ops import phase_conv as pc
from cips_tpu_torch.ops import s2d
from cips_tpu_torch.scripts import probe_phase_conv, time_full_kernel, time_phase_f32, time_stage_kernels

SCRIPTS = pathlib.Path(__file__).resolve().parents[1] / "scripts"


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


def _probe_module(name, monkeypatch):
    """A TPU probe script imported by path. Its import-time settings (sys.path, the
    compilation cache directory) are put back once it is loaded."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    cache_dir = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(f"_tpu_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return module


@pytest.mark.parametrize("mode", ["dot4d", "dot2d"])
def test_plain_dot_matches_the_tpu_probe(mode, monkeypatch):
    # scripts/probe_pallas_dot.py:run's pallas_call (its grid, specs and scratch) with
    # the probe's own k_dot4d / k_dot2d at a small shape, in TPU interpret mode. Both
    # sides round an fp32 sum to bf16: within one bf16 ulp (2^-7) of max|out|.
    probe = _probe_module("probe_pallas_dot", monkeypatch)
    b, z, y, xd, p = 1, 4, 4, 8, 128
    tz, ty = 2, 2
    x = _normal((b, z, y, xd, p), 12)
    w = _normal((8, p, p), 13, 0.1)
    kern = {"dot4d": probe.k_dot4d, "dot2d": probe.k_dot2d}[mode]
    scratch = [pltpu.VMEM((tz * ty * xd, p) if mode == "dot2d" else (tz, ty, xd, p), jnp.float32)]
    with pltpu.force_tpu_interpret_mode():
        want = pl.pallas_call(
            kern,
            out_shape=jax.ShapeDtypeStruct((b, z, y, xd, p), jnp.bfloat16),
            grid=(b, z // tz, y // ty),
            in_specs=[
                pl.BlockSpec((1, tz, ty, xd, p), lambda bi, i, j: (bi, i, j, 0, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((8, p, p), lambda bi, i, j: (0, 0, 0), memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((1, tz, ty, xd, p), lambda bi, i, j: (bi, i, j, 0, 0),
                                   memory_space=pltpu.VMEM),
            scratch_shapes=scratch,
        )(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    want = np.asarray(want, np.float32)
    xt, wt = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16)
    got = pc.phase_conv_stage(xt, wt, "dot")
    assert got.dtype == torch.bfloat16 and got.shape == (b, z, y, xd, p)
    assert _rel(got.float().numpy(), want) <= 8e-3
    # the bf16 kernel's rounding model (sum_k W[k] rounded once) stays inside the same limit
    assert _rel(pc.dot_rounded_reference(xt, wt).float().numpy(), want) <= 8e-3


def test_plain_noshift_matches_the_tpu_probe(monkeypatch):
    # scripts/probe_pallas_bisect.py:main.f in MODE nosel: the padded, x-shifted inputs,
    # the probe's own _kernel (its DMAs, halo buffers and 8 window dots), its specs and
    # scratch, at a small shape in TPU interpret mode. fp32: the sums differ in order only.
    probe = _probe_module("probe_pallas_bisect", monkeypatch)
    monkeypatch.setattr(probe, "MODE", "nosel")
    b, z, y, xd, p = 1, 4, 4, 8, 128
    tz = 2
    x = _normal((b, z, y, xd, p), 14)
    wp = _normal((2, 2, 2, p, p), 15, 0.1)
    xpad = jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (1, 1), (0, 0)))
    shifted = [xpad[:, :, :, kx:kx + xd, :] for kx in range(3)]
    with pltpu.force_tpu_interpret_mode():
        want = pl.pallas_call(
            probe._kernel,
            out_shape=jax.ShapeDtypeStruct((b, z, y, xd, p), jnp.float32),
            grid=(b, z // tz),
            in_specs=[pl.BlockSpec(memory_space=pltpu.ANY)] * 3 + [
                pl.BlockSpec((2, 2, 2, p, p), lambda bi, i: (0, 0, 0, 0, 0), memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((1, tz, y, xd, p), lambda bi, i: (bi, i, 0, 0, 0), memory_space=pltpu.VMEM),
            scratch_shapes=[pltpu.VMEM((1, tz + 2, y + 2, xd, p), jnp.float32)] * 3
            + [pltpu.VMEM((tz + 1, y + 1, xd, p), jnp.float32)] * 2
            + [pltpu.VMEM((tz, y, xd, p), jnp.float32), pltpu.SemaphoreType.DMA((3,))],
        )(*shifted, jnp.asarray(wp))
    want = np.asarray(want)
    got = pc.phase_conv_stage(torch.from_numpy(x), torch.from_numpy(wp), "noshift")
    assert got.dtype == torch.float32 and got.shape == (b, z, y, xd, p)
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("stage,variant", [(1, "copy"), (2, "shift"), (3, "one_tap"), (4, "full")])
def test_plain_stages_match_the_tpu_probe(stage, variant, monkeypatch):
    # scripts/debug_pallas_stages.py:run (its padding, grid, specs, DMA and scratch) with the
    # script's own _kernel at stage 1 (DMA and copy), 2 (the phase shifts), 3 (tap (0, 0, 0)
    # only) and 4 (all 8 taps: the full conv), fp32, in TPU interpret mode. The script reads its
    # stage from sys.argv at import.
    monkeypatch.setattr(sys, "argv", ["debug_pallas_stages.py"])
    probe = _probe_module("debug_pallas_stages", monkeypatch)
    monkeypatch.setattr(probe, "STAGE", stage)
    shape = (1, 4, 8, 8, 128)
    x = _normal(shape, 18)
    wp = _normal((2, 2, 2, 128, 128), 19, 0.1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(probe.run(jnp.asarray(x), jnp.asarray(wp), tz=2, ty=4))
    sums = variant in ("one_tap", "full")
    got = pc.phase_conv_stage(torch.from_numpy(x), torch.from_numpy(wp) if sums else None, variant)
    assert got.dtype == torch.float32 and got.shape == shape
    if sums:  # the sums differ in order only
        assert _rel(got.numpy(), want) <= 1e-5
    else:  # no arithmetic: exact
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [128, 256])
def test_dot_rounding_model(p):
    # the bf16 dot kernel computes x . bf16(sum_k W[k]) (fp32 sums, out in bf16); it stays
    # within half of the card's 1e-2 limit of the fp32 sum over the 8 products
    x = torch.from_numpy(_normal((1, 4, 4, 8, p), 16)).to(torch.bfloat16)
    w = torch.from_numpy(_normal((8, p, p), 17, 0.1)).to(torch.bfloat16)
    want = pc.phase_conv_stage_reference(x.float(), w.float(), "dot")
    got = pc.dot_rounded_reference(x, w)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert _rel(got.float().numpy(), want.numpy()) <= 0.5e-2
    # the model rounds S itself: it is not the plain version's arithmetic
    assert not torch.equal(got, pc.phase_conv_stage_reference(x, w, "dot"))


@pytest.mark.parametrize("p", [128, 256])
@pytest.mark.parametrize("variant", ["full", "noshift", "one_tap", "dot"])
def test_tf32x3_rounding_model(variant, p):
    # the fp32 kernel's arithmetic: every product as 3xTF32, sums of 32 channels of one tap
    # added in fp32; within 3e-6 of max|out| of the plain fp32 version (the card's limit for the
    # kernel is 1e-5), and not the plain version's arithmetic
    x = torch.from_numpy(_normal((1, 3, 4, 5, p), 20))
    w = torch.from_numpy(_normal((8, p, p) if variant == "dot" else (2, 2, 2, p, p), 21, 0.1))
    want = pc.phase_conv_stage_reference(x, w, variant)
    got = pc.phase_conv_tf32x3_reference(x, w, variant)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _rel(got.numpy(), want.numpy()) <= 3e-6
    assert not torch.equal(got, want)


def test_tf32x3_rounding_model_splits_each_operand():
    # a product whose operands carry bits below tf32's 10: the model keeps them (big + small),
    # where one tf32 pass would drop them
    x = torch.full((1, 1, 1, 1, 128), 1.0 + 2.0 ** -15)
    w = torch.zeros((2, 2, 2, 128, 128))
    w[0, 0, 0, 0, 0] = 1.0 + 2.0 ** -14
    got = pc.phase_conv_tf32x3_reference(x, w, "one_tap")[0, 0, 0, 0, 0].item()
    assert got == pytest.approx((1.0 + 2.0 ** -15) * (1.0 + 2.0 ** -14), rel=2.0 ** -22)
    with pytest.raises(ValueError, match="fp32 product variants"):
        pc.phase_conv_tf32x3_reference(x, None, "shift")


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


def test_bf16_one_tap_width_raises_off_the_cpu():
    # the bf16 one_tap kernel keeps Wp[0, 0, 0]'s (8C, 128) column slab in shared memory: 8C of
    # 128 or 256 only; fp32 and the CPU's plain version take any width
    x = torch.zeros((1, 1, 1, 2, 384), dtype=torch.bfloat16)
    wp = torch.zeros((2, 2, 2, 384, 384), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 one_tap kernel"):
        pc.phase_conv_stage(x.to("meta"), wp.to("meta"), "one_tap")
    with pytest.raises(ValueError, match="CUDA"):  # fp32 passes the width check, then finds no card
        pc.phase_conv_stage(x.float().to("meta"), wp.float().to("meta"), "one_tap")
    assert pc.phase_conv_stage(x, wp, "one_tap").shape == x.shape


def test_bf16_dot_width_raises_off_the_cpu():
    # the bf16 dot kernel keeps sum_k W[k] in shared memory: 8C of 128 or 256 only; the
    # wrapper says so before any launch, while the CPU's plain version takes any width
    x = torch.zeros((1, 1, 1, 2, 384), dtype=torch.bfloat16)
    w = torch.zeros((8, 384, 384), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 dot kernel"):
        pc.phase_conv_stage(x.to("meta"), w.to("meta"), "dot")
    assert pc.phase_conv_stage(x, w, "dot").shape == x.shape


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


def test_full_timing_copies_edit_the_source():
    # The timing-only copies of the bf16 full kernel are text edits of its source; each must
    # find its target exactly once, so that they follow the kernel as it changes.
    with open(pathlib.Path(pc.cuda_library.CSRC) / "phase_conv_sm90.cu", encoding="utf-8") as f:
        source = f.read()
    for name, edits in time_full_kernel.COPIES.items():
        assert (time_full_kernel.edited(source, edits) == source) == (name == "kernel"), name
    with pytest.raises(ValueError, match="found 0 times"):
        time_full_kernel.edited(source, [("no such text", "")])


def test_f32_timing_copies_edit_the_source():
    # The design and timing-only copies of the fp32 (3xTF32) kernel are text edits of its
    # source; each must find its target exactly once, and every copy that keeps the function
    # is one that the script holds to the plain version.
    with open(pathlib.Path(pc.cuda_library.CSRC) / time_phase_f32.SOURCE, encoding="utf-8") as f:
        source = f.read()
    for name, edits in time_phase_f32.COPIES.items():
        assert (time_full_kernel.edited(source, edits) == source) == (name == "kernel"), name
    assert set(time_phase_f32.WITH_RESULT) <= set(time_phase_f32.COPIES)


@pytest.mark.parametrize("kernel", sorted(time_stage_kernels.KERNELS))
def test_stage_timing_copies_edit_the_source(kernel):
    # The tuning and timing-only copies of the copy and one_tap kernels are text edits of
    # their source; each must find its target exactly once.
    with open(pathlib.Path(pc.cuda_library.CSRC) / "phase_conv_sm90.cu", encoding="utf-8") as f:
        source = f.read()
    for name, edits in time_stage_kernels.KERNELS[kernel].items():
        assert (time_full_kernel.edited(source, edits) == source) == (name == "kernel"), name


def test_device_time_from_a_trace_that_lost_records(capsys):
    # chip_smoke.device_ms's arithmetic on a torch.profiler trace's device records over
    # 200 calls: a kernel recorded 190 times (CUPTI dropped 10) still counts once a call at
    # its mean, one recorded about twice a call twice, one recorded once is spread over the calls
    record = collections.namedtuple("record", "count self_device_time_total")
    records = [record(190, 190 * 100.0), record(400, 400 * 10.0), record(1, 50.0)]
    assert chip_smoke.kernel_ms_per_call(records, 200, "fn") == pytest.approx((100.0 + 2 * 10.0 + 50.0 / 200) / 1e3)
    assert "lost 10 device records" in capsys.readouterr().out
    assert chip_smoke.kernel_ms_per_call(records[1:], 200, "fn") == pytest.approx((2 * 10.0 + 50.0 / 200) / 1e3)
    assert capsys.readouterr().out == ""


def test_device_records_drop_user_annotations(capsys):
    # chip_smoke.device_records on a trace's key_averages: host records and a record_function
    # range that came back as a device record (Adam's Optimizer.step) are dropped, the second
    # with a line that says so; kernels and copies stay. A torch whose records do not say
    # whether they are annotations fails instead of keeping them.
    record = collections.namedtuple("record", "key device_type is_user_annotation count self_device_time_total")
    kernel = record("multi_tensor_apply_kernel", "DeviceType.CUDA", False, 2, 1200.0)
    copy = record("Memcpy DtoD (Device -> Device)", "DeviceType.CUDA", False, 4, 30.0)
    host = record("aten::add_", "DeviceType.CPU", False, 400, 0.0)
    step = record("Optimizer.step#Adam.step", "DeviceType.CUDA", True, 2, 38727.0)
    trace = types.SimpleNamespace(key_averages=lambda: [kernel, host, step, copy])
    assert chip_smoke.device_records(trace, "profile train step") == [kernel, copy]
    assert capsys.readouterr().out == ("profile train step: dropped a user annotation from the device records: "
                                       "Optimizer.step#Adam.step x2, 38.727 ms\n")
    old = collections.namedtuple("old", "key device_type count self_device_time_total")("k", "DeviceType.CUDA", 1, 1.0)
    with pytest.raises(AttributeError):
        chip_smoke.device_records(types.SimpleNamespace(key_averages=lambda: [old]), "trace")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


CARD_SHAPES = {"ragged": (1, 5, 7, 9, 128), "pc256": (1, 5, 7, 9, 256), "b2-ragged": (2, 3, 9, 17, 128),
               "under-one-tile": (1, 1, 2, 3, 128), "one-cell": (1, 1, 1, 1, 128)}
CARD_CASES = [pytest.param(shape, dtype, tol, id=f"{label}-{name}") for label, shape in CARD_SHAPES.items()
              for name, dtype, tol in (("bf16", torch.bfloat16, 1e-2), ("f32", torch.float32, 1e-5))]
# fp32 takes any multiple of 128 (the bf16 dot and one_tap take 128 or 256)
CARD_CASES.append(pytest.param((1, 3, 5, 7, 384), torch.float32, 1e-5, id="pc384-f32"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,tol", CARD_CASES)
def test_kernel_matches_plain_version_on_card(cuda_device, dtype, tol, shape):
    # ragged shapes (no axis a multiple of any tile), pc 256, batch 2, a volume of fewer
    # cells than one tile and one cell (256 or 512 bytes: copy's one chunk is its remainder,
    # as the last chunk of (1, 5, 7, 9, 128) is), and pc 384 in fp32; each variant against its
    # plain version computed in fp32 from the same inputs, relative to max|out|
    g = torch.Generator(device=cuda_device).manual_seed(0)
    p = shape[-1]
    x = torch.randn(shape, device=cuda_device, generator=g).to(dtype)
    weights = {"dot": torch.randn((8, p, p), device=cuda_device, generator=g).to(dtype) * 0.1}
    for variant in ("full", "noshift", "one_tap"):
        weights[variant] = torch.randn((2, 2, 2, p, p), device=cuda_device, generator=g).to(dtype) * 0.1
    for variant in pc.VARIANTS:
        wp = weights.get(variant)
        got = pc.phase_conv_stage(x, wp, variant)
        torch.cuda.synchronize()
        want = pc.phase_conv_stage_reference(x.float(), None if wp is None else wp.float(), variant)
        assert got.dtype == dtype and got.shape == shape and torch.isfinite(got).all()
        assert (got.float() - want).abs().max().item() <= tol * want.abs().max().item(), variant
    assert torch.equal(pc.lane_select(x), pc.lane_select_reference(x))
