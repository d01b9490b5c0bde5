"""Flash-attention backward of the PyTorch port against the JAX package.

The plain backward (`flash_attention_backward_reference`) is held to the
Pallas dQ and dK/dV kernels run in interpret mode on the same residuals, and
`FlashAttention` under autograd to ``jax.grad`` of the Pallas
`flash_attention`. The fp32 kernels' rounding model (3xTF32,
`flash_attention_bwd_tf32x3_reference`) is held to the plain backward and to
the Pallas kernels. The CUDA kernels themselves run only on a card; their
tests skip elsewhere.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cips_tpu.ops.pallas.flash_attention import _flash_backward_pallas, _flash_forward, flash_attention
from cips_tpu_torch.ops import cuda_library as cl
from cips_tpu_torch.ops import flash_attention as fa
from cips_tpu_torch.scripts import time_flash_f32

CASES = [((1, 2, 512, 32), 128, 256), ((2, 1, 256, 64), 64, 128)]


def _arrays(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _pallas_and_plain(shape, block_q, block_k, jdt, tdt, seed):
    """(JAX Pallas grads, port plain grads) from one set of residuals: the JAX
    forward's out and lse feed both backwards."""
    q, k, v, g = _arrays(shape, 4, seed)
    scale = 1.0 / shape[-1] ** 0.5
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    out, lse = _flash_forward(jq, jk, jv, scale, block_q, block_k, True)
    jg = jnp.asarray(g, jdt)
    want = _flash_backward_pallas(scale, block_q, block_k, True, (jq, jk, jv, out, lse), jg)
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v, g)]
    t_out = torch.from_numpy(np.array(out, np.float32)).to(tdt)
    got = fa.flash_attention_backward_reference(t[0], t[1], t[2], t_out, torch.from_numpy(np.array(lse)), t[3],
                                                scale)
    return [np.asarray(w, np.float32) for w in want], got


@pytest.mark.parametrize("shape,block_q,block_k", CASES)
def test_plain_backward_matches_pallas_interpret_f32(shape, block_q, block_k):
    # fp32 throughout: the same products, summed tile by tile in the Pallas
    # kernels and in one matmul here; the bound of tests/test_flash_attention.py.
    want, got = _pallas_and_plain(shape, block_q, block_k, jnp.float32, torch.float32, seed=0)
    for name, w, t in zip(("dq", "dk", "dv"), want, got):
        assert t.dtype == torch.float32 and t.shape == shape
        np.testing.assert_allclose(t.numpy(), w, atol=2e-5, rtol=2e-5, err_msg=name)


@pytest.mark.parametrize("shape,block_q,block_k", CASES)
def test_plain_backward_matches_pallas_interpret_bf16(shape, block_q, block_k):
    # Both round dS and P to bf16 at the same points and accumulate in fp32, but
    # in another order, so a dS element near a rounding edge may land one bf16
    # step (2^-8 relative) apart; the grads are rounded to bf16 at the end
    # (2^-9 relative). The measured worst is 0.28 % of max|grad| (dQ at Dh 64);
    # the limit is 1 %.
    want, got = _pallas_and_plain(shape, block_q, block_k, jnp.bfloat16, torch.bfloat16, seed=1)
    for name, w, t in zip(("dq", "dk", "dv"), want, got):
        assert t.dtype == torch.bfloat16
        np.testing.assert_allclose(t.float().numpy(), w, atol=1e-2 * np.abs(w).max(), rtol=0, err_msg=name)


@pytest.mark.parametrize("scale", [-0.3, 0.0], ids=["negative", "zero"])
def test_scale_mapping_matches_pallas_interpret(scale):
    # The CUDA branch runs every kernel on (k', scale') = fa._positive_scale(k, scale) and
    # multiplies dK by its sign; composed with the plain versions, that mapping must give
    # JAX's forward and backward at the scale itself. fp32 throughout: the tolerance of
    # test_plain_backward_matches_pallas_interpret_f32.
    shape, block_q, block_k = (1, 2, 256, 32), 64, 128
    q, k, v, g = _arrays(shape, 4, seed=4)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    out, lse = _flash_forward(jq, jk, jv, scale, block_q, block_k, True)
    want = _flash_backward_pallas(scale, block_q, block_k, True, (jq, jk, jv, out, lse), jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    k2, scale2, dk_sign = fa._positive_scale(tk, scale)
    assert scale2 > 0
    got_out, got_lse = fa.flash_attention_reference(tq, k2, tv, scale2)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out), atol=2e-5, rtol=2e-5, err_msg="out")
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), atol=2e-5, rtol=2e-5, err_msg="lse")
    t_out, t_lse = torch.from_numpy(np.array(out)), torch.from_numpy(np.array(lse))
    delta = fa._delta(tg, t_out)
    dq = fa.flash_attention_bwd_dq_reference(tq, k2, tv, tg, t_lse, delta, scale2)
    dk, dv = fa.flash_attention_bwd_dkv_reference(tq, k2, tv, tg, t_lse, delta, scale2)
    for name, w, t in zip(("dq", "dk", "dv"), want, (dq, dk * dk_sign, dv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=2e-5, rtol=2e-5, err_msg=name)
    if scale == 0:  # the softmax is uniform: dQ and dK are exactly 0
        assert not dq.any() and not (dk * dk_sign).any()


@pytest.mark.parametrize("shape", [(1, 2, 256, 32), (1, 1, 200, 64)])
def test_autograd_function_matches_jax_grad(shape):
    # The loss of tests/test_flash_attention.py: sum((attention - target)^2);
    # fp32 in both, so only summation order differs. L = 200 takes one
    # 200-token block in the Pallas kernels and any L in the port.
    q, k, v, tgt = _arrays(shape, 4, seed=2)
    scale = 1.0 / shape[-1] ** 0.5

    blocks = 64 if shape[2] % 64 == 0 else None

    def loss(q, k, v):
        o = flash_attention(q, k, v, scale=scale, block_q=blocks, block_k=blocks, interpret=True)
        return jnp.sum((o - jnp.asarray(tgt)) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = (fa.flash_attention_forward.launches, fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    out = fa.FlashAttention.apply(tq, tk, tv, scale)
    got = torch.autograd.grad(((out - torch.from_numpy(tgt)) ** 2).sum(), (tq, tk, tv))
    assert (fa.flash_attention_forward.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == before  # the CPU takes the plain versions
    for name, w, t in zip(("dq", "dk", "dv"), want, got):
        w = np.asarray(w)
        np.testing.assert_allclose(t.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0, err_msg=name)


def test_tf32_split_parts():
    # big + small is x to within 2^-21 relative (x normal), and each part is a tf32 value: its
    # 13 low mantissa bits are 0. Rounding is to nearest with ties away from zero (cvt.rna):
    # 1 + 2^-11 lies halfway between the tf32 values 1 and 1 + 2^-10.
    rng = np.random.default_rng(5)
    x = torch.from_numpy(np.concatenate([rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096),
                                         [1.0 + 2.0**-12, 1.0 + 2.0**-11, -1.0 - 2.0**-11]]).astype(np.float32))
    big, small = fa.tf32_split(x)
    for part in (big, small):
        assert part.dtype == torch.float32 and not (part.view(torch.int32) & 0x1FFF).any()
    rebuilt = big.double() + small.double()
    assert ((rebuilt - x.double()).abs() <= 2.0**-21 * x.double().abs()).all()
    assert big[-3:].tolist() == [1.0, 1.0 + 2.0**-10, -1.0 - 2.0**-10]


def _model_and_plain(shape, seed):
    """(3xTF32 model, plain fp32 backward) of one set of fp32 residuals (the plain
    forward's out and lse), computed head by head; each is (dq, dk, dv) of all heads."""
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(shape, 4, seed))
    scale = shape[-1] ** -0.5
    model, plain = [], []
    for h in range(shape[1]):
        qh, kh, vh, gh = (t[:, h:h + 1] for t in (q, k, v, g))
        out, lse = fa.flash_attention_reference(qh, kh, vh, scale)
        delta = fa._delta(gh, out)
        model.append(fa.flash_attention_bwd_tf32x3_reference(qh, kh, vh, gh, lse, delta, scale))
        plain.append((fa.flash_attention_bwd_dq_reference(qh, kh, vh, gh, lse, delta, scale),
                      *fa.flash_attention_bwd_dkv_reference(qh, kh, vh, gh, lse, delta, scale)))
    return [torch.cat(ts, dim=1) for ts in zip(*model)], [torch.cat(ts, dim=1) for ts in zip(*plain)]


@pytest.mark.parametrize("shape", [(1, 4, 2304, 32), (1, 2, 4608, 64), (1, 1, 1000, 128)])
def test_tf32x3_model_within_half_the_fp32_limit(shape):
    # The fp32 kernels take every product as 3xTF32; their rounding model stays within half of
    # the limit that holds them to the plain backward (chip_smoke.TOL_F32_GRAD_REL of each
    # max|grad|), at the flagship's attention, a longer one at Dh 64 and one at Dh 128.
    # Measured: at most 2.2e-6.
    model, plain = _model_and_plain(shape, seed=6)
    for name, m, p in zip(("dq", "dk", "dv"), model, plain):
        assert m.dtype == torch.float32 and m.shape == shape
        rel = ((m - p).abs().max() / p.abs().max()).item()
        assert rel <= 0.5 * chip_smoke.TOL_F32_GRAD_REL, (shape, name, rel)


def test_tf32x3_model_is_not_the_plain_version():
    model, plain = _model_and_plain((1, 2, 256, 32), seed=7)
    assert not any(torch.equal(m, p) for m, p in zip(model, plain))


@pytest.mark.parametrize("shape,block_q,block_k", CASES)
def test_tf32x3_model_matches_pallas_interpret(shape, block_q, block_k):
    # The model against the Pallas kernels in fp32 on the same residuals, within the fp32
    # kernels' limit of each max|grad|.
    q, k, v, g = _arrays(shape, 4, seed=8)
    scale = 1.0 / shape[-1] ** 0.5
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    out, lse = _flash_forward(jq, jk, jv, scale, block_q, block_k, True)
    want = _flash_backward_pallas(scale, block_q, block_k, True, (jq, jk, jv, out, lse), jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    delta = fa._delta(tg, torch.from_numpy(np.array(out)))
    got = fa.flash_attention_bwd_tf32x3_reference(tq, tk, tv, tg, torch.from_numpy(np.array(lse)), delta, scale)
    for name, w, t in zip(("dq", "dk", "dv"), want, got):
        w = np.asarray(w)
        np.testing.assert_allclose(t.numpy(), w, atol=chip_smoke.TOL_F32_GRAD_REL * np.abs(w).max(), rtol=0,
                                   err_msg=name)


def test_fp32_flash_bound_is_3xtf32_at_the_tf32_peak(monkeypatch):
    # chip_smoke.bound_ms at the flagship's attention, (2, 4, 2304, 32) fp32, on an H100 SXM (132
    # SMs at 1,980 MHz): dQ does 6 B H L^2 Dh operations and dK/dV 8, each taken three times at
    # the TF32 peak (989 / 2 TFLOP/s); beside it the FMA figure (128 lanes x 2 x SMs x clock).
    monkeypatch.setattr(chip_smoke, "sm_clocks_per_s", lambda: 132 * 1980e6)
    b, h, l, d = chip_smoke.TRAIN_ATTN
    pairs = b * h * l * l
    nbytes = 6 * b * h * l * d * 4 + 2 * b * h * l * 4
    for flops, want, fma in ((6.0 * pairs * d, 0.0495, 0.1219), (8.0 * pairs * d, 0.0660, 0.1625)):
        ms, by = chip_smoke.bound_ms(flops, nbytes, float(pairs), torch.float32)
        assert by == "operations" and ms == pytest.approx(want, abs=5e-5)
        assert ms == pytest.approx(3 * flops / (chip_smoke.H100_BF16_FLOPS / 2) * 1e3)
        assert chip_smoke.fma_ms(flops) == pytest.approx(fma, abs=5e-5)
    assert chip_smoke.bound_ms(6.0 * pairs * d, 0.0)[0] == pytest.approx(6.0 * pairs * d / 989e12 * 1e3)  # bf16


def test_fp32_timing_copies_edit_the_sources():
    # The copies that time_flash_f32 builds are text edits of the kernels' sources; each edit
    # must find its target exactly once, so that they follow the kernels as they change.
    text = time_flash_f32.sources()
    for name, edits in time_flash_f32.COPIES.items():
        changed = [time_flash_f32.edited(text[f], edits.get(f, [])) != text[f] for f in time_flash_f32.SOURCES]
        assert any(changed) == (name != "kernel"), name


def test_function_backward_is_the_plain_backward_on_cpu():
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16) for a in _arrays((1, 2, 100, 32), 4, seed=3))
    scale = 0.2
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.FlashAttention.apply(qg, kg, vg, scale)
    got = torch.autograd.grad(out, (qg, kg, vg), g)
    ref_out, lse = fa.flash_attention_reference(q, k, v, scale)
    assert torch.equal(out, ref_out)
    want = fa.flash_attention_backward_reference(q, k, v, ref_out, lse, g, scale)
    for t, w in zip(got, want):
        assert t.dtype == torch.bfloat16 and torch.equal(t, w)


def test_build_depends_on_every_source(tmp_path, monkeypatch):
    # The library is rebuilt when any csrc source or header is newer than it.
    deps = cl._dependencies()
    sources = {"flash_attention_fwd.cu", "flash_attention_bwd.cu", "phase_conv.cu", "mma_bf16.cuh"}
    assert sources <= {os.path.basename(p) for p in deps}
    lib = tmp_path / "libcips_kernels.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(cl, "LIBRARY", str(lib))
    monkeypatch.setattr(cl, "BUILD_DIR", str(tmp_path))
    newest = max(os.path.getmtime(p) for p in deps)
    os.utime(lib, (newest + 1, newest + 1))
    assert cl.build() == str(lib)  # up to date: nothing is compiled

    class Compiled(Exception):
        pass

    def popen(cmd, **kwargs):
        raise Compiled(cmd[-1])

    monkeypatch.setattr(cl.shutil, "which", lambda name: sys.executable)
    monkeypatch.setattr(cl.subprocess, "Popen", popen)
    header = next(p for p in deps if p.endswith(".cuh"))
    os.utime(lib, (os.path.getmtime(header) - 1,) * 2)  # older than the newest source
    with pytest.raises(Compiled, match=r"\.cu$"):
        cl.build()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-5)])
def test_bwd_kernels_match_plain_version_on_card(cuda_device, dtype, tol):
    # Limits as in chip_smoke.py, relative to each grad's max|grad|, against the
    # plain backward in fp32 on the same inputs: bf16 rounds dS, P and the grads
    # (measured worst about 0.55 %); fp32 takes every product as 3xTF32 (its rounding
    # model, flash_attention_bwd_tf32x3_reference, stays within 2.2e-6 on the CPU).
    # Every tile edge (L 1, 17, 127, 129 and the flagship's 2,304 plus one, at Dh 32, 64
    # and 128), the causal generator's 18,432 tokens, and the dQ kernel's key-side edges:
    # fewer keys than one tile, Lq != Lk both ways and ragged, at Dh 128 too; then a
    # negative and a zero scale, which the wrapper maps onto a positive one.
    g = torch.Generator(device=cuda_device).manual_seed(0)
    cases = [((1, 4, 2304, 32), None), ((1, 2, 1000, 32), None), ((1, 1, 333, 64), None), ((1, 1, 130, 128), None),
             ((1, 2, 1, 32), None), ((1, 2, 17, 64), None), ((1, 2, 127, 128), None), ((1, 2, 129, 32), None),
             ((1, 1, 2305, 32), None), ((1, 1, 129, 64), None), ((1, 1, 18432, 32), None),
             ((1, 2, 100, 32), 40), ((1, 2, 130, 64), 77), ((1, 2, 77, 64), 130), ((1, 1, 129, 128), 191),
             ((1, 2, 1, 128), 130), ((1, 2, 200, 32), 300, -0.3), ((1, 2, 200, 64), 150, 0.0)]
    for shape, lk, *scales in cases:
        kshape = shape if lk is None else (*shape[:2], lk, shape[3])
        q, dout = (torch.randn(shape, device=cuda_device, generator=g).to(dtype) for _ in range(2))
        k, v = (torch.randn(kshape, device=cuda_device, generator=g).to(dtype) for _ in range(2))
        scale = scales[0] if scales else shape[-1] ** -0.5
        out, lse = fa.flash_attention_forward(q, k, v, scale)
        delta = (dout.float() * out.float()).sum(-1)
        before = (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches)
        got = (fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale),
               *fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale))
        torch.cuda.synchronize()
        assert (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches) == (
            before[0] + 1, before[1] + 1)
        f32 = [t.float() for t in (q, k, v, dout)]
        want = (fa.flash_attention_bwd_dq_reference(*f32, lse, delta, scale),
                *fa.flash_attention_bwd_dkv_reference(*f32, lse, delta, scale))
        # At Lk = 1 or scale 0 the softmax is constant, so dQ and dK are exactly 0 and both sides
        # hold only fp32 rounding noise of dP - delta (about 1e-8): they are held to the largest
        # max|grad| of the three (dV's).
        largest = max(w.abs().max().item() for w in want)
        constant = kshape[2] == 1 or scale == 0
        for name, t, w in zip(("dq", "dk", "dv"), got, want):
            assert t.dtype == dtype
            ref = largest if constant and name != "dv" else w.abs().max().item()
            assert (t.float() - w).abs().max().item() <= tol * ref, (shape, lk, scale, name)


@pytest.mark.cuda
def test_function_launches_the_bwd_kernels_on_card(cuda_device):
    q, k, v = (torch.randn((2, 4, 256, 32), device=cuda_device, dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    before = (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches)
    out = fa.FlashAttention.apply(q, k, v, 32**-0.5)
    out.float().square().sum().backward()
    assert (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    assert all(t.grad is not None and t.grad.dtype == torch.bfloat16 for t in (q, k, v))
