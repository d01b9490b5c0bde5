"""Flash-attention forward of the PyTorch port against the JAX package.

The plain version (`flash_attention_reference`) is held to the Pallas kernel
run in interpret mode, the way tests/test_flash_attention.py runs it on the
CPU. The CUDA kernel itself runs only on a card; its test skips elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cips_tpu.ops.attention import _reference_attention as jax_reference_attention
from cips_tpu.ops.pallas.flash_attention import _flash_forward
from cips_tpu_torch.ops import attention
from cips_tpu_torch.ops import flash_attention as fa


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


def test_wrapper_takes_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 100, 32), seed=2))
    before = fa.flash_attention_forward.launches
    out, lse = fa.flash_attention_forward(q, k, v)
    want_out, want_lse = fa.flash_attention_reference(q, k, v, 1.0 / 32**0.5)
    assert fa.flash_attention_forward.launches == before
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


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)])
def test_kernel_matches_plain_version_on_card(cuda_device, dtype, tol):
    # Tolerances as in chip_smoke.py, relative to max|out|: bf16 rounds P and
    # the output (2^-9 relative each); fp32 differs in summation order only.
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for shape in ((1, 4, 2304, 32), (1, 2, 1000, 32), (1, 1, 333, 64), (1, 1, 130, 128)):
        q, k, v = (torch.randn(shape, device=cuda_device, generator=g).to(dtype) for _ in range(3))
        before = fa.flash_attention_forward.launches
        out, lse = fa.flash_attention_forward(q, k, v)
        torch.cuda.synchronize()
        assert fa.flash_attention_forward.launches == before + 1
        ref_out, ref_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), shape[-1] ** -0.5)
        assert (out.float() - ref_out).abs().max().item() <= tol * ref_out.abs().max().item()
        assert (lse - ref_lse).abs().max().item() <= 1e-4


def test_kernel_rejects_bad_inputs_on_card(cuda_device):
    q = torch.zeros((1, 1, 64, 32), device=cuda_device)
    with pytest.raises(ValueError):
        fa.flash_attention_forward(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        fa.flash_attention_forward(q[..., :16], q[..., :16], q[..., :16])
    with pytest.raises(ValueError):
        fa.flash_attention_forward(q.transpose(2, 3), q.transpose(2, 3), q.transpose(2, 3))
    with pytest.raises(NotImplementedError):  # no backward kernel yet
        fa.flash_attention_forward(q.clone().requires_grad_(), q, q)
