"""Flash-attention backward of the PyTorch port against the JAX package.

The plain backward (`flash_attention_backward_reference`) is held to the
Pallas dQ and dK/dV kernels run in interpret mode on the same residuals, and
`FlashAttention` under autograd to ``jax.grad`` of the Pallas
`flash_attention`. The CUDA kernels themselves run only on a card; their
tests skip elsewhere.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cips_tpu.ops.pallas.flash_attention import _flash_backward_pallas, _flash_forward, flash_attention
from cips_tpu_torch.ops import cuda_library as cl
from cips_tpu_torch.ops import flash_attention as fa

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
    # (measured worst about 0.55 %); fp32 differs in summation order only.
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for shape in ((1, 4, 2304, 32), (1, 2, 1000, 32), (1, 1, 333, 64), (1, 1, 130, 128)):
        q, k, v, dout = (torch.randn(shape, device=cuda_device, generator=g).to(dtype) for _ in range(4))
        scale = shape[-1] ** -0.5
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
        for t, w in zip(got, want):
            assert t.dtype == dtype
            assert (t.float() - w).abs().max().item() <= tol * w.abs().max().item()


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
