"""GroupNorm and InstanceNorm with the activation that follows them: hand-written
CUDA kernels, their plain version, and the autograd Function that joins them.

The kernels (`csrc/group_norm.cu`, built into the port's one kernel library by
`cuda_library`) replace no TPU kernel: the JAX package leaves the norm to XLA,
which fuses it. Run eagerly, the plain version is about a dozen PyTorch passes
over the activation forward and backward, and autograd keeps an fp32 copy of
the activation and the activation's input; the kernels make it two passes
each way and keep x and the per-group statistics alone.

Which path runs follows the input only:

  * a CPU tensor, or an fp64 tensor anywhere (a reference run), takes the plain
    version, `group_norm_reference`;
  * a bf16 or fp32 CUDA tensor launches the kernels, `GroupNormFunction`;
  * any other CUDA tensor raises. There is no fallback.

Both compute, per (sample, group) of ``num_groups`` consecutive channels:
mean = E[x], inv = rsqrt(max(E[x^2] - mean^2, 0) + eps) in fp32 (fp64 for an
fp64 input); per (sample, channel) scale = inv w and offset = b - mean inv w in
fp32, each rounded to x's dtype; z = x * scale + offset in x's dtype, then
``act`` (None, ``"silu"`` or ``"leaky_relu"``, slope 0.2) of z. Over a
``space`` group (`parallel.spatial`) the statistics are the whole volume's: the
kernels' sums go through one all-reduce (`spatial.group_moments`'s message:
sums and count) before the affine, and the backward's per-(sample, channel)
sums through one before dx.

The kernels read x as it lies, by rows (NCDHW) or channels last (NDHWC: the
models' activations, their input being a channels-last volume), and write y
and dx in x's layout, so that the convolutions around a norm see the layout
they saw without it.

Each forward of the Function counts one ``group_norm.fwd.launches`` and each
backward one ``group_norm.bwd.launches`` in `cips_tpu_torch.profiling.COUNTERS`
(a call, which is three kernels each way); each call of the plain version counts
one ``group_norm.plain.calls``, so that a run on the card can show that none of
its bf16 or fp32 norms took it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from cips_tpu_torch import profiling
from cips_tpu_torch.ops import cuda_library
from cips_tpu_torch.parallel import spatial

ACTS = {None: 0, "silu": 1, "leaky_relu": 2}
LEAKY_SLOPE = 0.2
THREADS = 256  # csrc/group_norm.cu kThreads
UNROLL = 4  # csrc/group_norm.cu kLoads: a forward block's pass covers THREADS x vector x UNROLL elements
TARGET_BLOCKS = 4 * 132 * 8  # four waves of 256-thread blocks, 8 resident on each of 132 SMs
MAX_CHUNKS = 65535  # a row's blocks: the grid's y extent
MAX_CL_CHANNELS = 512  # csrc/group_norm.cu kMaxClChannels


def activate(z: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """``act`` of ``z``: None, SiLU, or LeakyReLU with slope 0.2."""
    if act is None:
        return z
    if act == "silu":
        return F.silu(z)
    if act == "leaky_relu":
        return F.leaky_relu(z, LEAKY_SLOPE)
    raise ValueError(f"unknown activation {act!r}; expected one of {tuple(ACTS)}")


def group_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float,
                         act: Optional[str] = None,
                         space: Optional[spatial.SpaceGroup] = None) -> torch.Tensor:
    """The plain version: ``act`` of the norm of (N, C, *S) ``x``, as PyTorch ops."""
    profiling.COUNTERS["group_norm.plain.calls"] += 1
    n, c = x.shape[:2]
    g = num_groups
    stats = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(stats).reshape(n, g, c // g * math.prod(x.shape[2:]))  # a slab may hold no plane
    if space is None:
        mean = x32.mean(dim=-1)
        meansq = (x32 * x32).mean(dim=-1)
    else:
        mean, meansq = spatial.group_moments(x32, space)
    inv = torch.rsqrt((meansq - mean * mean).clamp_min(0.0) + eps)  # (N, G)
    w = weight.to(stats).reshape(1, g, c // g)
    scale = (inv[:, :, None] * w).reshape(n, c)
    offset = (bias.to(stats).reshape(1, g, c // g) - (mean * inv)[:, :, None] * w).reshape(n, c)
    shape = (n, c) + (1,) * (x.ndim - 2)
    return activate(x * scale.reshape(shape).to(x.dtype) + offset.reshape(shape).to(x.dtype), act)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float,
               act: Optional[str] = None, space: Optional[spatial.SpaceGroup] = None) -> torch.Tensor:
    """``act`` of the group norm of (N, C, *S) ``x``: the plain version for a CPU
    or an fp64 tensor, the kernels for a bf16 or fp32 CUDA tensor; raises for
    any other."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}; expected one of {tuple(ACTS)}")
    if x.device.type == "cpu" or x.dtype == torch.float64:
        return group_norm_reference(x, weight, bias, num_groups, eps, act, space)
    if not x.is_cuda or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the group norm kernels take bf16 or fp32 CUDA tensors, got {x.dtype} on {x.device}")
    return GroupNormFunction.apply(x, weight.float(), bias.float(), num_groups, eps, act, space)


@functools.cache
def _library() -> ctypes.CDLL:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    shape = [i32, i32, i32, i64, i64]  # n, c, groups, s, chunk
    return cuda_library.load({
        "cips_group_norm_moments": [ptr] * 3 + [i32] * 2 + shape + [ptr],
        "cips_group_norm_apply": [ptr] * 6 + [i32] * 3 + shape + [ctypes.c_float, ptr],
        "cips_group_norm_bwd_sums": [ptr] * 8 + [i32] * 3 + shape + [ptr],
        "cips_group_norm_bwd_dx": [ptr] * 7 + [i32] * 3 + shape + [ptr],
    })


def vector_width(dtype: torch.dtype) -> int:
    """Elements in one 16-byte load."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def takes_channels_last(x: torch.Tensor) -> bool:
    """Whether the channels-last kernels take ``x`` as it lies: a 5-D tensor laid out
    channels last (NDHWC, and not also NCDHW: a tensor of one channel or one voxel
    goes by rows), 16-byte aligned, its channels (at most ``MAX_CL_CHANNELS``)
    parting into 16-byte vectors whose count divides a block's threads."""
    if x.dim() != 5 or x.is_contiguous() or not x.is_contiguous(memory_format=torch.channels_last_3d):
        return False
    c, width = x.shape[1], vector_width(x.dtype)
    return c % width == 0 and THREADS % (c // width) == 0 and c <= MAX_CL_CHANNELS and x.data_ptr() % 16 == 0


def plan(rows: int, length: int, step: int) -> int:
    """A block's slice of a row of ``length`` (its chunk): the largest power-of-two
    multiple of one forward block pass, ``step``, that still gives the grid (``rows``
    x chunks) ``TARGET_BLOCKS`` blocks, so a long row parts over many blocks and a
    short one takes one; larger, where a row would need more than ``MAX_CHUNKS``
    blocks. A row is an (n, c) of S elements, or a channels-last sample of S
    positions."""
    chunk = step
    while chunk < length and (rows * -(-length // (2 * chunk)) >= TARGET_BLOCKS
                              or -(-length // chunk) > MAX_CHUNKS):
        chunk *= 2
    return chunk


class _Launch:
    """One call's layout (``mode``: 0 rows element by element, 1 rows in 16-byte
    vectors, 2 channels last), shape and plan, which its four entry points share.
    ``x`` is contiguous, or channels last when ``channels_last``; ``others`` lie
    as ``x`` does."""

    def __init__(self, x: torch.Tensor, num_groups: int, act: Optional[str], channels_last: bool,
                 *others: torch.Tensor):
        n, c = x.shape[:2]
        if c % num_groups:
            raise ValueError(f"{c} channels do not part into {num_groups} groups")
        self.n, self.c, self.groups, self.s = n, c, num_groups, math.prod(x.shape[2:])
        width = vector_width(x.dtype)
        if channels_last:
            self.mode = 2
            self.chunk = plan(n, self.s, THREADS * width // c * UNROLL)  # positions
        else:
            aligned = all(t.data_ptr() % 16 == 0 for t in (x, *others))
            self.mode = int(self.s % width == 0 and aligned)
            self.chunk = plan(n * c, self.s, THREADS * (width if self.mode else 1) * UNROLL)
        self.chunks = max(1, -(-self.s // self.chunk))
        self.is_bf16 = int(x.dtype == torch.bfloat16)
        self.act = ACTS[act]
        self.device = x.device

    def shape(self) -> tuple:
        return self.n, self.c, self.groups, self.s, self.chunk

    def partial(self) -> torch.Tensor:
        return torch.empty(2 * self.n * self.c * self.chunks, dtype=torch.float32, device=self.device)

    def __call__(self, name: str, *args) -> None:
        with torch.cuda.device(self.device):
            rc = getattr(_library(), name)(*args, torch.cuda.current_stream(self.device).cuda_stream)
        cuda_library.check(rc, name)


class GroupNormFunction(torch.autograd.Function):
    """``act`` of the group norm of a bf16 or fp32 CUDA tensor with the kernels,
    forward and backward. A channels-last input (`takes_channels_last`: the models'
    activations, whose input is a channels-last volume) is read as it lies and y
    and dx are channels last too; any other is made contiguous first. Saves x,
    the weight and bias, and the (N, G) mean, 1/std and clamp gate with the
    element count (``stats``): no fp32 copy and no activation input. ``weight``
    and ``bias`` are fp32; their gradients are this rank's (over a space group,
    its slab's), as autograd's of the plain version."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float,
                act: Optional[str], space: Optional[spatial.SpaceGroup]) -> torch.Tensor:
        channels_last = takes_channels_last(x)
        if not channels_last:
            x = x.contiguous()
        y = torch.empty_like(x)  # in x's layout
        launch = _Launch(x, num_groups, act, channels_last, y)
        ng = launch.n * num_groups
        sums = torch.empty(2 * ng + 1, dtype=torch.float32, device=x.device)
        stats = torch.empty(3 * ng + 1, dtype=torch.float32, device=x.device)
        launch("cips_group_norm_moments", x.data_ptr(), launch.partial().data_ptr(), sums.data_ptr(),
               launch.is_bf16, launch.mode, *launch.shape())
        if space is not None:
            spatial.all_reduce_(sums, space, "norm")
        launch("cips_group_norm_apply", x.data_ptr(), weight.data_ptr(), bias.data_ptr(), sums.data_ptr(),
               stats.data_ptr(), y.data_ptr(), launch.is_bf16, launch.mode, launch.act, *launch.shape(), float(eps))
        profiling.COUNTERS["group_norm.fwd.launches"] += 1
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.num_groups, ctx.act, ctx.space, ctx.channels_last = num_groups, act, space, channels_last
        return y

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, weight, bias, stats = ctx.saved_tensors
        layout = torch.channels_last_3d if ctx.channels_last else torch.contiguous_format
        dy = dy.to(x.dtype).contiguous(memory_format=layout)  # in x's layout
        if ctx.channels_last and dy.data_ptr() % 16:
            dy = dy.clone(memory_format=layout)
        dx = torch.empty_like(x)
        launch = _Launch(x, ctx.num_groups, ctx.act, ctx.channels_last, dy, dx)
        sums_nc = torch.empty(2 * launch.n * launch.c, dtype=torch.float32, device=x.device)
        dwdb = torch.empty(2 * launch.c, dtype=torch.float32, device=x.device)
        pointers = (x.data_ptr(), dy.data_ptr(), weight.data_ptr(), bias.data_ptr(), stats.data_ptr())
        flags = (launch.is_bf16, launch.mode, launch.act)
        launch("cips_group_norm_bwd_sums", *pointers, launch.partial().data_ptr(), sums_nc.data_ptr(),
               dwdb.data_ptr(), *flags, *launch.shape())
        if ctx.space is not None:
            spatial.all_reduce_(sums_nc, ctx.space, "norm")
        if ctx.needs_input_grad[0]:
            launch("cips_group_norm_bwd_dx", *pointers, sums_nc.data_ptr(), dx.data_ptr(), *flags, *launch.shape())
        profiling.COUNTERS["group_norm.bwd.launches"] += 1
        dw, db = dwdb.split(launch.c)
        return dx if ctx.needs_input_grad[0] else None, dw, db, None, None, None, None
