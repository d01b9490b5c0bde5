"""The port's fused GroupNorm / InstanceNorm with its activation (`ops.group_norm`).

On the CPU (the plain version runs): `GroupNorm(x, act)` and `InstanceNorm(x,
act)` equal ``act`` of the norm as `GroupNorm.forward` computed it before it
took the activation, bit for bit, forward and backward, for no activation,
SiLU and LeakyReLU 0.2, in fp32 and fp64, with and without a one-rank space
group; the models' parameter names did not move; the wrapper's launch plan.

On a card (marked ``cuda``; no CPU mode): the kernels against the plain version
at the two cells' shapes, in bf16 and fp32, rows (NCDHW) and channels last. The forward within the reordering
of its fp32 sums; dx, dw and db no farther from the plain graph one precision
up (fp32 for bf16, fp64 for fp32) than the plain version in the same dtype is;
two runs equal bit for bit; one launch counted a call each way; refused launches
raise. This file imports no JAX: on the card run it with ``--noconftest``.
"""

import hashlib
import math

import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from cips_tpu_torch import profiling
from cips_tpu_torch.models.blocks import GroupNorm
from cips_tpu_torch.models.discriminator import InstanceNorm
from cips_tpu_torch.ops import cuda_library
from cips_tpu_torch.ops import group_norm as gn
from cips_tpu_torch.parallel import spatial
from cips_tpu_torch.training import causal_task, unet_synthesis

ACT_FNS = {None: lambda z: z, "silu": F.silu, "leaky_relu": lambda z: F.leaky_relu(z, 0.2)}


def _norm_before_act(module, x):
    """`GroupNorm.forward` as it was before it took an activation: fp32 (fp64)
    statistics, scale and offset rounded to x's dtype, one multiply-add."""
    n, c = x.shape[:2]
    g = module.num_groups
    stats = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(stats).reshape(n, g, c // g * math.prod(x.shape[2:]))
    if module.space is None:
        mean = x32.mean(dim=-1)
        meansq = (x32 * x32).mean(dim=-1)
    else:
        mean, meansq = spatial.group_moments(x32, module.space)
    inv = torch.rsqrt((meansq - mean * mean).clamp_min(0.0) + module.eps)
    w = module.weight.to(stats).reshape(1, g, c // g)
    scale = (inv[:, :, None] * w).reshape(n, c)
    offset = (module.bias.to(stats).reshape(1, g, c // g) - (mean * inv)[:, :, None] * w).reshape(n, c)
    shape = (n, c) + (1,) * (x.ndim - 2)
    return x * scale.reshape(shape).to(x.dtype) + offset.reshape(shape).to(x.dtype)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A space group of one rank (gloo, this process), torn down after the module."""
    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    store = dist.FileStore(str(tmp_path_factory.mktemp("store") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield spatial.new_group([0])
    finally:
        dist.destroy_process_group()


def _module(kind, dtype):
    torch.manual_seed(0)
    module = GroupNorm(4, 16) if kind == "group_norm" else InstanceNorm(8)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        module.weight.copy_(torch.randn(module.weight.shape, generator=g) * 0.5 + 1.0)
        module.bias.copy_(torch.randn(module.bias.shape, generator=g) * 0.5)
    return module.to(dtype)


def _run(module, x, gout, fn):
    """(output, dx, dw, db) of ``fn(x)`` against the seeded linear loss."""
    for p in module.parameters():
        p.grad = None
    x = x.clone().requires_grad_(True)
    y = fn(x)
    (y * gout).sum().backward()
    return y.detach(), x.grad, module.weight.grad, module.bias.grad


@pytest.mark.parametrize("space", [False, True], ids=["alone", "one_rank"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("act", [None, "silu", "leaky_relu"])
@pytest.mark.parametrize("kind", ["group_norm", "instance_norm"])
def test_norm_with_act_equals_act_of_the_norm_bit_for_bit(kind, act, dtype, space, request):
    module = _module(kind, dtype)
    g = torch.Generator().manual_seed(2)
    c = module.num_channels
    x = (torch.randn(2, c, 3, 4, 5, generator=g) * 2.0 + 0.5).to(dtype)
    gout = torch.randn(x.shape, generator=g).to(dtype)
    group = request.getfixturevalue("one_rank") if space else None
    with spatial.sharded([module], group):
        plain = profiling.COUNTERS["group_norm.plain.calls"]
        got = _run(module, x, gout, lambda t: module(t, act=act))
        assert profiling.COUNTERS["group_norm.plain.calls"] == plain + 1  # a CPU tensor takes the plain version
        want = _run(module, x, gout, lambda t: ACT_FNS[act](_norm_before_act(module, t)))
    for name, a, b in zip(("y", "dx", "dw", "db"), got, want):
        assert a.dtype == b.dtype == dtype and torch.equal(a, b), name


def test_activation_names():
    x = torch.randn(1, 4, 2, 2, 2)
    norm = GroupNorm(2, 4)
    with pytest.raises(ValueError, match="unknown activation"):
        norm(x, act="relu")
    with pytest.raises(ValueError, match="bf16 or fp32 CUDA"):
        gn.group_norm(x.to("meta"), norm.weight, norm.bias, 2, 1e-6)  # neither the CPU nor a card


# sha256 of the sorted "name shape" lines of each model's state dict at the tiny
# configs below, taken from the models before their norms took the activation.
STATE_DIGESTS = {
    "atten_unet": "3d308ae5d3ebc5f5fc28da50398ad428af69bbd33dac1e5070b0a6a71bf68d5a",
    "atten_unet.discriminator": "a200448802ef527064aa3a8f7562949b6c064ae09a7a1a42938c4f2e0de87a89",
    "causal.encoder": "54ecf87cdd4191726d826fefe1de5e27a0e089fe5648665ee0d7981364b5391b",
    "causal.t1_decoder": "9d0e19ca02e8ac4557dc2dcf19e3ee81d5dc6fb3766611839004c62fef0ad2ea",
    "causal.pet_decoder": "429946b972e3a6ac5c5ef199352d741d26fcee53b85a33a01f7709bf56351e92",
    "causal.discriminator": "a200448802ef527064aa3a8f7562949b6c064ae09a7a1a42938c4f2e0de87a89",
}

TINY_UNET = {
    "atten_unet_def": {"spatial_dims": 3, "in_channels": 1, "out_channels": 1, "num_channels": [8, 16],
                       "num_res_blocks": 1, "attention_levels": [False, True], "norm_num_groups": 8,
                       "resblock_updown": True, "num_head_channels": [0, 8]},
    "discriminator": {"num_channels": 8, "num_layers_d": 2},
    "perceptual_network": {"spatial_dims": 3},
    "training": {"perceptual_weight": 0},
}
TINY_CAUSAL = {
    "t1_autoencoder_def": {
        "atten_encoder": {"spatial_dims": 3, "in_channels": 1, "out_channels": 6, "num_channels": [8, 16],
                          "num_res_blocks": 1, "attention_levels": [False, True], "norm_num_groups": 8,
                          "resblock_updown": True, "num_head_channels": [0, 8], "with_conditioning": True},
        "decoder": {"spatial_dims": 3, "in_channels": 3, "out_channels": 1, "num_channels": [8, 16],
                    "num_res_blocks": 1, "norm_num_groups": 8, "attention_levels": [False, False]},
    },
    "pet_decoder_def": {"spatial_dims": 3, "in_channels": 3, "out_channels": 1, "num_channels": [16, 8],
                        "num_res_blocks": 1, "norm_num_groups": 8, "attention_levels": [True, False],
                        "num_head_channels": [8, 0], "with_conditioning": True},
    "discriminator": {"num_channels": 8, "num_layers_d": 2},
    "perceptual_network": {"spatial_dims": 3},
    "training": {"perceptual_weight": 0},
}


def _digest(model):
    lines = sorted(f"{k} {tuple(v.shape)}" for k, v in model.state_dict().items())
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


def _models():
    g, d, _ = unet_synthesis.build_models(TINY_UNET, 5, dtype=torch.float32, device="cpu")
    enc, t1, pet, cd, _ = causal_task.build_models(TINY_CAUSAL, 5, dtype=torch.float32, device="cpu")
    return {"atten_unet": g, "atten_unet.discriminator": d, "causal.encoder": enc, "causal.t1_decoder": t1,
            "causal.pet_decoder": pet, "causal.discriminator": cd}


def test_state_dict_names_are_unchanged():
    models = _models()
    assert {name: _digest(m) for name, m in models.items()} == STATE_DIGESTS
    # the SiLU keeps its Sequential slot, unused, so the out-conv stays out.2
    for name in ("atten_unet", "causal.pet_decoder"):
        keys = models[name].state_dict()
        assert "out.0.weight" in keys and "out.2.conv.weight" in keys and not any(k.startswith("out.1") for k in keys)


@pytest.mark.parametrize("shape,dtype,layout,mode,chunk", [
    ((4, 64, 96, 128, 96), torch.bfloat16, "rows", 1, 65536),  # the causal encoder's level 0: 18 chunks a row
    ((4, 16, 96, 128, 96), torch.bfloat16, "rows", 1, 16384),  # the flagship's level 0
    ((4, 128, 12, 16, 12), torch.bfloat16, "rows", 1, 8192),  # short rows: one chunk each
    ((4, 512, 11, 15, 11), torch.bfloat16, "rows", 0, 1024),  # odd S: element by element
    ((4, 64, 96, 128, 96), torch.float32, "rows", 1, 65536),
    ((4, 64, 96, 128, 96), torch.bfloat16, "channels_last", 2, 1024),  # positions: 64K elements a block
    ((4, 16, 96, 128, 96), torch.bfloat16, "channels_last", 2, 1024),
    ((4, 512, 11, 15, 11), torch.bfloat16, "channels_last", 2, 16),  # odd S goes by vectors of channels
    ((4, 64, 96, 128, 96), torch.float32, "channels_last", 2, 1024),
])
def test_launch_plan(shape, dtype, layout, mode, chunk):
    x = torch.empty(shape, dtype=dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last_3d)
    assert gn.takes_channels_last(x) == (layout == "channels_last")
    n, c, s = shape[0], shape[1], math.prod(shape[2:])
    launch = gn._Launch(x, 4, "silu", layout == "channels_last")
    assert launch.mode == mode and launch.chunk == chunk and launch.chunks == -(-s // chunk)
    width = gn.vector_width(dtype) if mode else 1
    step = gn.THREADS * width * gn.UNROLL // (c if mode == 2 else 1)
    rows = n if mode == 2 else n * c
    assert chunk % step == 0 and (rows * launch.chunks >= gn.TARGET_BLOCKS or chunk == step)


@pytest.mark.parametrize("shape,memory_format,takes", [
    ((2, 96, 4, 4, 4), torch.channels_last_3d, False),  # 12 vectors of channels do not divide 256 threads
    ((2, 4, 4, 4, 4), torch.channels_last_3d, False),  # fewer channels than a vector
    ((2, 1024, 2, 2, 2), torch.channels_last_3d, False),  # over the 512 channels of the per-channel tables
    ((2, 512, 2, 2, 2), torch.channels_last_3d, True),
    ((2, 1, 4, 4, 4), torch.channels_last_3d, False),  # one channel: NCDHW too, so by rows
    ((2, 64, 4, 4, 4), torch.contiguous_format, False),
    ((2, 64, 4, 4), torch.channels_last, False),  # 4-D: by rows
])
def test_layouts_the_channels_last_kernels_refuse(shape, memory_format, takes):
    x = torch.empty(shape, dtype=torch.bfloat16).contiguous(memory_format=memory_format)
    assert gn.takes_channels_last(x) == takes


def test_launch_refuses_what_no_grid_takes():
    with pytest.raises(ValueError, match="do not part"):
        gn._Launch(torch.empty(1, 6, 4), 4, None, False)
    # rows lie on the grid's x extent, which takes any N * C: InstanceNorm at 512 channels, batch 160
    launch = gn._Launch(torch.empty(160, 512, 2), 512, None, False)
    assert launch.n * launch.c == 81920 and launch.chunks == 1


@pytest.mark.parametrize("rows,length,step", [
    (1, 2**40, 1024),  # one row longer than MAX_CHUNKS chunks of the target's size
    (1, 65535 * 1024 + 1, 1024),  # one element past MAX_CHUNKS steps
    (81920, 2**30, 8192),
])
def test_plan_keeps_a_row_within_the_grid(rows, length, step):
    chunk = gn.plan(rows, length, step)
    assert chunk % step == 0 and -(-length // chunk) <= gn.MAX_CHUNKS
    assert chunk == step or -(-length // (chunk // 2)) > gn.MAX_CHUNKS or rows * -(-length // chunk) >= gn.TARGET_BLOCKS


# --- on the card ------------------------------------------------------------------------------

FULL = (96, 128, 96)
VOLUMES = {"full": FULL, "half": (48, 64, 48), "quarter": (24, 32, 24)}
# (channels, groups): the AttenUNet's and the causal encoder's 16 groups, the decoders' 32,
# the discriminators' InstanceNorm
WIDTHS = [(16, 16), (32, 16), (64, 16), (128, 16), (32, 32), (64, 32), (64, 64), (128, 128)]
# the discriminators' deepest maps, whose odd sizes take the element-by-element path
ODD = [((256, 256), (23, 31, 23)), ((512, 512), (11, 15, 11))]
CARD_CASES = [(w, v) for w in WIDTHS for v in VOLUMES] + [(w, "x".join(map(str, s))) for w, s in ODD]
ACTS = [None, "silu", "leaky_relu"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the group norm kernels have no CPU mode")
    return torch.device("cuda")


def _volume(name):
    return VOLUMES.get(name) or tuple(int(v) for v in name.split("x"))


def _card_inputs(width, volume, dtype, seed, layout=torch.contiguous_format):
    (c, groups), s = width, _volume(volume)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((4, c, *s), device="cuda", generator=g) * 1.5 + 0.3).to(dtype).contiguous(memory_format=layout)
    gout = torch.randn((4, c, *s), device="cuda", generator=g).to(dtype).contiguous(memory_format=layout)
    w = torch.randn(c, device="cuda", generator=g) * 0.5 + 1.0
    b = torch.randn(c, device="cuda", generator=g) * 0.5
    return x, gout, w, b, groups


def _grads(fn, x, w, b, gout, dtype):
    """(y, dx, dw, db) of fn at x cast to ``dtype`` (w and b fp32, or fp64 with it), from fresh leaves."""
    pdt = torch.float64 if dtype == torch.float64 else torch.float32
    xs = x.detach().to(dtype).clone().requires_grad_(True)
    ws, bs = (t.detach().to(pdt).clone().requires_grad_(True) for t in (w, b))
    y = fn(xs, ws, bs)
    y.backward(gout.to(dtype))
    return [t.detach() for t in (y, xs.grad, ws.grad, bs.grad)]


def _plain_up(x, w, b, groups, act):
    """The plain graph for ``_grads`` one precision up from x's dtype. Its LeakyReLU takes
    the branch that the plain forward in x's own dtype took: where rounding moves z across 0
    the two precisions take different slopes, an error that both paths in x's dtype share
    and that would hide which of them rounds less."""
    with torch.no_grad():
        branch = gn.group_norm_reference(x, w, b, groups, 1e-6) > 0

    def fn(t, ws, bs):
        z = gn.group_norm_reference(t, ws, bs, groups, 1e-6)
        return torch.where(branch, z, z * gn.LEAKY_SLOPE) if act == "leaky_relu" else gn.activate(z, act)

    return fn


def _rel(a, ref):
    """Relative L2 distance of ``a`` from ``ref``, in fp64."""
    a, ref = a.double(), ref.double()
    return ((a - ref).norm() / ref.norm().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [torch.contiguous_format, torch.channels_last_3d], ids=["rows", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("width,volume", CARD_CASES, ids=[f"{c}c{g}g-{v}" for (c, g), v in CARD_CASES])
def test_kernels_match_plain_version_on_card(cuda_device, width, volume, dtype, layout):
    i = CARD_CASES.index((width, volume))
    act = ACTS[i % len(ACTS)]
    x, gout, w, b, groups = _card_inputs(width, volume, dtype, i, layout)
    # the models' activations lie channels last, and the kernels keep them so
    assert gn.takes_channels_last(x) == (layout == torch.channels_last_3d)
    up = torch.float64 if dtype == torch.float32 else torch.float32  # the plain graph one precision up

    def kernel(t, ws, bs):
        return gn.group_norm(t, ws, bs, groups, 1e-6, act)

    def plain(t, ws, bs):
        return gn.group_norm_reference(t, ws, bs, groups, 1e-6, act)

    before = (profiling.COUNTERS["group_norm.fwd.launches"], profiling.COUNTERS["group_norm.bwd.launches"])
    got = _grads(kernel, x, w, b, gout, dtype)
    again = _grads(kernel, x, w, b, gout, dtype)
    torch.cuda.synchronize()
    assert (profiling.COUNTERS["group_norm.fwd.launches"], profiling.COUNTERS["group_norm.bwd.launches"]) == (
        before[0] + 2, before[1] + 2)
    plain_same = _grads(plain, x, w, b, gout, dtype)
    ref = _grads(_plain_up(x, w, b, groups, act), x, w, b, gout, up)
    for name, a, a2 in zip(("y", "dx", "dw", "db"), got, again):
        assert torch.equal(a, a2), f"{name}: two runs differ"
    assert got[0].is_contiguous(memory_format=layout) and got[1].is_contiguous(memory_format=layout)
    # the forward: the same roundings, sums in another order. A bf16 scale or offset
    # rounds otherwise only when it lies within the sums' reordering of a rounding
    # boundary; fp32 outputs move in their last bits.
    y, y_plain = got[0].float(), plain_same[0].float()
    assert got[0].dtype == dtype
    tol = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
    assert (y - y_plain).abs().max().item() <= tol * y_plain.abs().max().item(), "forward"
    # Distances from the wider graph. bf16: the kernels round dx once and keep dz and the sums in
    # fp32, the plain version rounds at each op (measured ratios 0.77-0.99 for dx, under 0.7 for
    # dw and db; the forward equal bit for bit). fp32: both sum in fp32 in other orders, the
    # kernels' blocks in fp64; held within one fp32 rounding (2^-23) of the plain version's.
    slack = 0.0 if dtype == torch.bfloat16 else 2.0**-23
    assert _rel(got[0], ref[0]) <= 1.01 * _rel(plain_same[0], ref[0]) + slack, "forward against the wider graph"
    for name, k, p, r in zip(("dx", "dw", "db"), got[1:], plain_same[1:], ref[1:]):
        assert k.dtype == p.dtype
        assert _rel(k, r) <= _rel(p, r) + slack, (name, _rel(k, r), _rel(p, r))


@pytest.mark.cuda
def test_module_runs_the_kernels_and_fp64_the_plain_version_on_card(cuda_device):
    norm = InstanceNorm(8).to(cuda_device)
    before, plain = profiling.COUNTERS["group_norm.fwd.launches"], profiling.COUNTERS["group_norm.plain.calls"]
    norm(torch.randn(2, 8, 4, 4, 4, device=cuda_device, dtype=torch.bfloat16), act="leaky_relu")
    norm.float()(torch.randn(2, 8, 4, 4, 4, device=cuda_device), act="silu")
    assert profiling.COUNTERS["group_norm.fwd.launches"] == before + 2
    assert profiling.COUNTERS["group_norm.plain.calls"] == plain
    norm.double()(torch.randn(2, 8, 4, 4, 4, device=cuda_device, dtype=torch.float64))
    assert profiling.COUNTERS["group_norm.fwd.launches"] == before + 2
    assert profiling.COUNTERS["group_norm.plain.calls"] == plain + 1
    with pytest.raises(ValueError, match="bf16 or fp32 CUDA"):
        norm.half()(torch.randn(2, 8, 4, 4, 4, device=cuda_device, dtype=torch.float16))


@pytest.mark.cuda
def test_refused_launches_raise_on_card(cuda_device):
    lib = gn._library()
    x = torch.zeros(16, device=cuda_device)
    scratch = torch.zeros(1 << 20, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    # a row of 70,000 chunks, past the grid's y extent: the card refuses the launch
    # (cudaErrorInvalidConfiguration)
    rc = lib.cips_group_norm_moments(x.data_ptr(), scratch.data_ptr(), scratch.data_ptr(), 0, 0, 1, 1, 1, 70000,
                                     1, stream)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_library.check(rc, "cips_group_norm_moments")
    # a 16-byte path over a row it does not divide, and channels last over 96 channels (12
    # vectors, which do not divide a block's 256 threads): refused before any launch
    rc = lib.cips_group_norm_moments(x.data_ptr(), scratch.data_ptr(), scratch.data_ptr(), 1, 1, 1, 1, 1, 15, 8192,
                                     stream)
    assert rc == 1  # cudaErrorInvalidValue
    rc = lib.cips_group_norm_moments(x.data_ptr(), scratch.data_ptr(), scratch.data_ptr(), 1, 2, 1, 96, 32, 8, 64,
                                     stream)
    assert rc == 1
    torch.cuda.synchronize()
