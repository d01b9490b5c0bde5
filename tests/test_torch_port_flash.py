"""Flash-attention forward of the PyTorch port against the JAX package.

The plain version (`flash_attention_reference`) is held to the Pallas kernel
run in interpret mode, the way tests/test_flash_attention.py runs it on the
CPU, and so is the fp32 kernel's rounding model (3xTF32,
`flash_attention_tf32x3_reference`), which is also held to the plain version.
The CUDA kernel itself runs only on a card; its tests skip elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cips_tpu.ops.attention import _reference_attention as jax_reference_attention
from cips_tpu.ops.pallas.flash_attention import _flash_forward
from cips_tpu_torch.ops import attention
from cips_tpu_torch.ops import flash_attention as fa
from cips_tpu_torch.scripts import time_flash_f32
from cips_tpu_torch import profiling


def _qkv(shape, seed=0, lk=None):
    rng = np.random.default_rng(seed)
    kshape = shape if lk is None else shape[:2] + (lk,) + shape[3:]
    return [rng.standard_normal(s).astype(np.float32) for s in (shape, kshape, kshape)]


CASES = [((1, 2, 512, 32), 128, 256), ((2, 1, 256, 64), 64, 128)]


@pytest.mark.parametrize("shape,block_q,block_k", CASES)
def test_plain_matches_pallas_interpret_f32(shape, block_q, block_k):
    # fp32 throughout; only the online (tiled) vs one-pass softmax order
    # differs, so the bound of tests/test_flash_attention.py applies.
    q, k, v = _qkv(shape)
    scale = 1.0 / shape[-1] ** 0.5
    want_out, want_lse = _flash_forward(*(jnp.asarray(a) for a in (q, k, v)), scale, block_q, block_k, True)
    got_out, got_lse = fa.flash_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shape,block_q,block_k", CASES)
def test_plain_matches_pallas_interpret_bf16(shape, block_q, block_k):
    # Both round P to bf16 before P.V, but the Pallas kernel rounds
    # exp(s - running max) tile by tile and the plain version exp(s - row max),
    # and the output is rounded to bf16 (2^-9 relative). Here max|out| is about
    # 0.5 and the measured error about 0.35 % of it; the limit is 1 % of
    # max|out|. lse stays fp32 from identical bf16 inputs.
    q, k, v = _qkv(shape, seed=1)
    scale = 1.0 / shape[-1] ** 0.5
    want_out, want_lse = _flash_forward(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scale, block_q, block_k, True
    )
    got_out, got_lse = fa.flash_attention_reference(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), scale
    )
    assert got_out.dtype == torch.bfloat16
    want_out = np.asarray(want_out, np.float32)
    np.testing.assert_allclose(got_out.float().numpy(), want_out, atol=1e-2 * np.abs(want_out).max(), rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=1e-4, rtol=1e-5)


# The flagship's attention, Dh 64 and 128, a ragged L (one key and one q row past a tile) and
# Lq != Lk both ways.
MODEL_CASES = [((1, 4, 2304, 32), None), ((1, 2, 1000, 64), None), ((1, 1, 1000, 128), None),
               ((1, 2, 129, 32), None), ((1, 2, 300, 64), 77), ((1, 2, 100, 128), 300)]


@pytest.mark.parametrize("shape,lk", MODEL_CASES)
def test_tf32x3_forward_model_within_half_the_fp32_limits(shape, lk):
    # The fp32 kernel takes both products as 3xTF32; its rounding model stays within half of the
    # limits that hold the kernel to the plain version (chip_smoke.TOL_F32_OUT_REL of max|out|,
    # chip_smoke.TOL_LSE absolute). Measured: at most 2.0e-6 of max|out| and 9.6e-7 in lse.
    q, k, v = (torch.from_numpy(a) for a in _qkv(shape, seed=5, lk=lk))
    scale = shape[-1] ** -0.5
    m_out, m_lse = fa.flash_attention_tf32x3_reference(q, k, v, scale)
    p_out, p_lse = fa.flash_attention_reference(q, k, v, scale)
    assert m_out.dtype == torch.float32 and m_out.shape == shape and m_lse.shape == shape[:3]
    assert ((m_out - p_out).abs().max() / p_out.abs().max()).item() <= 0.5 * chip_smoke.TOL_F32_OUT_REL
    assert (m_lse - p_lse).abs().max().item() <= 0.5 * chip_smoke.TOL_LSE


def test_tf32x3_forward_model_is_not_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 256, 32), seed=6))
    model, plain = fa.flash_attention_tf32x3_reference(q, k, v, 0.2), fa.flash_attention_reference(q, k, v, 0.2)
    assert not torch.equal(model[0], plain[0]) and not torch.equal(model[1], plain[1])


@pytest.mark.parametrize("shape,block_q,block_k", CASES)
def test_tf32x3_forward_model_matches_pallas_interpret(shape, block_q, block_k):
    # The model against the Pallas forward in fp32, within the limits that hold the fp32 kernel to
    # the plain version: chip_smoke.TOL_F32_OUT_REL of max|out| and chip_smoke.TOL_LSE absolute.
    q, k, v = _qkv(shape, seed=7)
    scale = 1.0 / shape[-1] ** 0.5
    want_out, want_lse = _flash_forward(*(jnp.asarray(a) for a in (q, k, v)), scale, block_q, block_k, True)
    got_out, got_lse = fa.flash_attention_tf32x3_reference(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    want_out = np.asarray(want_out)
    np.testing.assert_allclose(got_out.numpy(), want_out, atol=chip_smoke.TOL_F32_OUT_REL * np.abs(want_out).max(),
                               rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=chip_smoke.TOL_LSE, rtol=0)


def test_fp32_forward_timing_copies_edit_the_source():
    # The forward copies that time_flash_f32 builds are text edits of the kernel's source; each
    # edit must find its target exactly once, so that they follow the kernel as it changes.
    text = time_flash_f32.sources(time_flash_f32.FWD_SOURCES)
    for name, edits in time_flash_f32.FWD_COPIES.items():
        changed = [time_flash_f32.edited(text[f], edits.get(f, [])) != text[f] for f in time_flash_f32.FWD_SOURCES]
        assert any(changed) == (name != "kernel"), name


def test_wrapper_takes_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 100, 32), seed=2))
    before = profiling.COUNTERS["flash.fwd.launches"]
    out, lse = fa.flash_attention_forward(q, k, v)
    want_out, want_lse = fa.flash_attention_reference(q, k, v, 1.0 / 32**0.5)
    assert profiling.COUNTERS["flash.fwd.launches"] == before
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    assert out.shape == (1, 2, 100, 32) and lse.shape == (1, 2, 100) and lse.dtype == torch.float32


@pytest.mark.parametrize("dtype,upcast", [("float32", False), ("float32", True), ("bfloat16", False),
                                          ("bfloat16", True)])
def test_cross_attention_reference_matches_jax(dtype, upcast):
    # Lk = 1 (the covariate token) takes the einsum-style reference path in both
    # packages; a second case with Lk = 7 exercises a real softmax. The port
    # always forms fp32 scores, which is what JAX's ``upcast`` gives too.
    for lk in (1, 7):
        q, k, v = _qkv((2, 4, 64, 8), seed=3, lk=lk)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        want = jax_reference_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), 0.3, upcast)
        got = attention.multi_head_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), scale=0.3)
        tol = 1e-6 if dtype == "float32" else 2e-2  # bf16: output rounding only
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


def test_equal_lengths_dispatch_to_flash():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 64, 32), seed=4))
    got = attention.multi_head_attention(q, k, v, scale=0.2)
    assert torch.equal(got, fa.flash_attention_reference(q, k, v, 0.2)[0])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)])
def test_kernel_matches_plain_version_on_card(cuda_device, dtype, tol):
    # Tolerances as in chip_smoke.py, relative to max|out|: bf16 rounds P and
    # the output (2^-9 relative each); fp32 takes both products as 3xTF32.
    # Every tile edge: one row, a part of one tile, one tile less or more a row, the
    # flagship's L plus one, Lq != Lk both ways, and the causal generator's 18,432 tokens.
    g = torch.Generator(device=cuda_device).manual_seed(0)
    cases = [((1, 4, 2304, 32), None), ((1, 2, 1000, 32), None), ((1, 1, 333, 64), None), ((1, 1, 130, 128), None),
             ((1, 2, 1, 32), None), ((1, 2, 17, 64), None), ((1, 2, 127, 128), None), ((1, 2, 129, 32), None),
             ((1, 1, 2305, 32), None), ((1, 2, 100, 32), 300), ((1, 2, 300, 64), 77), ((1, 1, 129, 128), 17),
             ((1, 1, 18432, 32), None)]
    for shape, lk in cases:
        kshape = shape if lk is None else (*shape[:2], lk, shape[3])
        q = torch.randn(shape, device=cuda_device, generator=g).to(dtype)
        k, v = (torch.randn(kshape, device=cuda_device, generator=g).to(dtype) for _ in range(2))
        before = profiling.COUNTERS["flash.fwd.launches"]
        out, lse = fa.flash_attention_forward(q, k, v)
        torch.cuda.synchronize()
        assert profiling.COUNTERS["flash.fwd.launches"] == before + 1
        ref_out, ref_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), shape[-1] ** -0.5)
        assert (out.float() - ref_out).abs().max().item() <= tol * ref_out.abs().max().item()
        assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs_on_card(cuda_device):
    q = torch.zeros((1, 1, 64, 32), device=cuda_device)
    with pytest.raises(ValueError):
        fa.flash_attention_forward(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        fa.flash_attention_forward(q[..., :16], q[..., :16], q[..., :16])
    with pytest.raises(ValueError):
        fa.flash_attention_forward(q.transpose(2, 3), q.transpose(2, 3), q.transpose(2, 3))
    # Any scale, as JAX's kernel takes: the wrapper maps a negative or zero scale onto a positive
    # one (negated or zero K) before the bf16 kernel, which takes the row max before the scale.
    g = torch.Generator(device=cuda_device).manual_seed(1)
    qs = torch.randn((1, 2, 100, 32), device=cuda_device, generator=g).bfloat16()
    ks, vs = (torch.randn((1, 2, 77, 32), device=cuda_device, generator=g).bfloat16() for _ in range(2))
    for scale in (-0.3, 0.0):
        out, lse = fa.flash_attention_forward(qs, ks, vs, scale)
        ref_out, ref_lse = fa.flash_attention_reference(qs.float(), ks.float(), vs.float(), scale)
        assert (out.float() - ref_out).abs().max().item() <= 1e-2 * ref_out.abs().max().item()
        assert (lse - ref_lse).abs().max().item() <= 1e-4
    # Inputs that need a gradient are served: FlashAttention records the backward.
    qg = q.clone().requires_grad_()
    before = profiling.COUNTERS["flash.fwd.launches"]
    out, _ = fa.flash_attention_forward(qg, q, q)
    assert profiling.COUNTERS["flash.fwd.launches"] == before + 1 and out.shape == q.shape
    assert fa.FlashAttention.apply(qg, q, q, 32**-0.5).requires_grad


@pytest.mark.cuda
def test_fp32_kernel_matches_plain_version_and_model_on_card(cuda_device):
    # The fp32 (3xTF32) kernel against the plain version and against its rounding model, each
    # within chip_smoke.py's fp32 limits: TOL_F32_OUT_REL of max|out|, TOL_LSE absolute. Every
    # tile edge at Dh 32, 64 and 128, Lq != Lk both ways, the causal generator's 18,432 tokens and
    # a negative and a zero scale, which the wrapper maps onto a positive one.
    g = torch.Generator(device=cuda_device).manual_seed(2)
    cases = [((1, 4, 2304, 32), None, None), ((1, 2, 1, 32), None, None), ((1, 2, 17, 64), None, None),
             ((1, 2, 127, 128), None, None), ((1, 2, 129, 32), None, None), ((1, 1, 2305, 32), None, None),
             ((1, 2, 100, 32), 300, None), ((1, 2, 300, 64), 77, None), ((1, 1, 129, 128), 191, None),
             ((1, 1, 18432, 32), None, None), ((1, 2, 200, 32), 300, -0.3), ((1, 2, 200, 64), 150, 0.0)]
    for shape, lk, scale in cases:
        kshape = shape if lk is None else (*shape[:2], lk, shape[3])
        q = torch.randn(shape, device=cuda_device, generator=g)
        k, v = (torch.randn(kshape, device=cuda_device, generator=g) for _ in range(2))
        scale = shape[-1] ** -0.5 if scale is None else scale
        before = profiling.COUNTERS["flash.fwd.launches"]
        out, lse = fa.flash_attention_forward(q, k, v, scale)
        torch.cuda.synchronize()
        assert profiling.COUNTERS["flash.fwd.launches"] == before + 1
        for ref_out, ref_lse in (fa.flash_attention_reference(q, k, v, scale),
                                 fa.flash_attention_tf32x3_reference(q, k, v, scale)):
            rel = ((out - ref_out).abs().max() / ref_out.abs().max()).item()
            assert rel <= chip_smoke.TOL_F32_OUT_REL, (shape, rel)
            assert (lse - ref_lse).abs().max().item() <= chip_smoke.TOL_LSE, shape
