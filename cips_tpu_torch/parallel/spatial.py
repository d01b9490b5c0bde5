"""Depth-sharded volumes across ranks: the port of the mesh's ``space`` axis.

The JAX package shards a batch's depth axis over ``space`` with
`cips_tpu.parallel.mesh.batch_sharding(mesh, 1)` and leaves the rest to XLA's
partitioner: the conv halos, the norm reductions and the gathers. Here each is
written out over the ranks of one *space group* (the ranks that hold one
sample's depth slabs), each with its backward:

  * the slab arithmetic: a global depth ``n`` lies over a group of ``S`` ranks
    as contiguous slabs, rank ``i`` holding planes ``[i n // S, (i + 1) n // S)``
    (`slab`); a conv's output lies the same way over its output depth, so a
    stride-1 k4 conv's 11 planes part 5 / 6 over 2 ranks, and a rank may hold none;
  * `halo_conv`: each rank receives the neighbours' planes its output planes
    read (and the zeros of the 'same' padding beyond the volume's ends), then
    runs the local ``F.conv3d``; the backward sends the halo planes' gradients
    back to their owners, who add them;
  * `space_sum`: an fp32 all-reduce whose backward all-reduces the gradients
    (every rank's term depends on the sum); it gives `group_moments` (the plain
    GroupNorm and InstanceNorm statistics; the norm kernels all-reduce their
    sums with `all_reduce_`) and `space_mean` (a mean over a sharded tensor:
    the L1 term, the LSGAN patch means);
  * `gather`: every rank's slab along an axis, in rank order, the whole tensor
    on each rank (self-attention's K and V, the volumes the 2.5-D LPIPS term
    slices across the depth axis); its backward sums each rank's gradient into
    the owner's slab (a reduce-scatter);
  * `gather_ranges`, which both of those use: any planes of a slabbed tensor on
    any rank. The 2x resamplings of `models.blocks` re-slab with it when a
    level's depth does not part into equal slabs of even depth (a pooled pair,
    or an upsampled plane, whose source lies on a neighbour).

Slabs need not be equal. The volumes reach the ranks cut into equal slabs (the
mesh's rule, `mesh.shard_space`: a depth the group's size does not divide
stays whole, and `space_for` then runs it unsharded), but a deeper level's
depth may part unevenly (12 planes over 8 ranks give slabs of 1 and 2) or
leave a rank without a plane (12 over 16), so the models carry each level's
global depth (``depth``) into the functions here.

Every function is written for "sum semantics": rank r's backward returns the
gradient of the sum over the group's ranks of their losses. A term every rank
computes in full (an all-reduced loss, the gathered LPIPS) so reaches each
parameter S times; the train step's DDP mean over the world then divides by
the world size, S times the data-parallel ranks, and every rank's gradient is
the one-process gradient of the global batch.

Transport: NCCL's point-to-point sends and all-reduce on card tensors. Gloo
(the CPU, and ranks that share a card) takes only ``broadcast`` and
``all_reduce`` on CUDA tensors, so its point-to-point messages go through host
copies. Every rank of a group runs the same exchanges in the same order; a
rank with no plane runs them too. The bytes a rank sends (point-to-point) or
all-reduces are counted by kind as ``space.exchanged.<kind>``
(`cips_tpu_torch.profiling.COUNTERS`; `exchanged` reads them).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from cips_tpu_torch import profiling

KINDS = ("halo", "norm", "kv", "volume", "mean", "resample")


@dataclasses.dataclass(frozen=True, eq=False)
class SpaceGroup:
    """The ranks holding one sample's depth slabs: their global ranks in slab
    order, this rank's place among them, the process group and its backend."""

    ranks: Tuple[int, ...]
    index: int
    group: Any
    backend: str

    @property
    def size(self) -> int:
        return len(self.ranks)


def exchanged() -> Dict[str, int]:
    """The bytes this rank sent or all-reduced over its space group, by kind
    (`KINDS`), since ``profiling.reset("space.exchanged.")``."""
    return dict.fromkeys(KINDS, 0) | profiling.counters("space.exchanged.")


def new_group(ranks: Sequence[int], **kwargs) -> Optional[SpaceGroup]:
    """A process group over ``ranks`` (every rank of the world must call this,
    for every group, in the same order; ``kwargs`` go to ``dist.new_group``);
    this rank's `SpaceGroup`, or None when it is not one of them."""
    ranks = tuple(ranks)
    group = dist.new_group(list(ranks), **kwargs)
    me = dist.get_rank()
    if me not in ranks:
        return None
    return SpaceGroup(ranks=ranks, index=ranks.index(me), group=group, backend=dist.get_backend(group))


# --- the slab arithmetic ---------------------------------------------------


def slab(n: int, index: int, count: int) -> Tuple[int, int]:
    """The planes [start, stop) that rank ``index`` of ``count`` holds of a global depth ``n``."""
    return index * n // count, (index + 1) * n // count


def depth_of(x: torch.Tensor, space: SpaceGroup, depth: Optional[int] = None) -> int:
    """The global depth of the slab ``x`` (N, C, d, ...): ``depth`` when given,
    else that of ``space.size`` equal slabs."""
    return x.shape[2] * space.size if depth is None else depth


def space_for(space: Optional[SpaceGroup], local_depth: int, volume_depth: Optional[int]) -> Optional[SpaceGroup]:
    """The group that a batch of volumes of global depth ``volume_depth``, of
    which this rank holds ``local_depth`` planes, is sharded over: ``space`` when
    the mesh's rule cut the volumes into its equal slabs (its size divides the
    depth), None when they reached the ranks whole and run unsharded on each.
    ``volume_depth`` None takes the volumes for slabs. A ValueError when this
    rank's planes are neither."""
    if space is None or volume_depth is None:
        return space
    sharded = volume_depth % space.size == 0
    if local_depth != (volume_depth // space.size if sharded else volume_depth):
        raise ValueError(f"{local_depth} planes on a rank of {space.size}: neither a slab of depth {volume_depth} "
                         f"nor the whole volume")
    return space if sharded else None


def conv_output_size(n: int, kernel: int, stride: int, padding: int) -> int:
    return (n + 2 * padding - kernel) // stride + 1


def conv_windows(n: int, kernel: int, stride: int, padding: int, count: int) -> List[Tuple[int, int, int]]:
    """For each rank of ``count``: (first, last) input planes its output planes
    read, unclipped (below 0 and from ``n`` on is the zero padding), and its
    number of output planes. A rank without an output plane reads the window of
    the output plane its slab starts at, computes that plane and keeps none of
    it, so that every rank runs the same operations (and the weight stays in
    its graph)."""
    n_out = conv_output_size(n, kernel, stride, padding)
    if n_out < 1:
        raise ValueError(f"a k{kernel} s{stride} p{padding} conv has no output plane over depth {n}")
    out = []
    for i in range(count):
        o0, o1 = slab(n_out, i, count)
        computed = max(o1, o0 + 1)
        out.append((o0 * stride - padding, (computed - 1) * stride - padding + kernel, o1 - o0))
    return out


def _overlap(a: Tuple[int, int], b: Tuple[int, int]) -> Optional[Tuple[int, int]]:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else None


# --- transport -------------------------------------------------------------


def _count(kind: str, t: torch.Tensor) -> None:
    profiling.COUNTERS[f"space.exchanged.{kind}"] += t.numel() * t.element_size()


def _p2p(space: SpaceGroup, sends: List[Tuple[int, torch.Tensor]], recvs: List[Tuple[int, Tuple[int, ...]]],
         like: torch.Tensor, kind: str) -> List[torch.Tensor]:
    """Send each (peer, tensor) and receive a tensor of each (peer, shape) from
    that peer (peers by their place in the group), like ``like``'s dtype and
    device; returns the received tensors in ``recvs``' order. Over gloo the
    messages go through host copies."""
    host = space.backend == "gloo"
    ops, received = [], []
    for peer, t in sends:
        t = t.contiguous()
        _count(kind, t)
        ops.append(dist.P2POp(dist.isend, t.cpu() if host else t, space.ranks[peer], space.group))
    for peer, shape in recvs:
        buf = torch.empty(shape, dtype=like.dtype, device="cpu" if host else like.device)
        ops.append(dist.P2POp(dist.irecv, buf, space.ranks[peer], space.group))
        received.append(buf)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(like.device) for b in received]


def all_reduce_(t: torch.Tensor, space: SpaceGroup, kind: str) -> torch.Tensor:
    """Sums ``t`` over the group in place, counting its bytes under ``kind``; no gradient."""
    _count(kind, t)
    dist.all_reduce(t, group=space.group)
    return t


class _SpaceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, space, kind):
        ctx.space, ctx.kind = space, kind
        return all_reduce_(t.clone(), space, kind)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.space, ctx.kind), None, None


def space_sum(t: torch.Tensor, space: SpaceGroup, kind: str) -> torch.Tensor:
    """The sum of every rank's ``t`` over the group (an all-reduce); the
    backward all-reduces the gradients."""
    return _SpaceSum.apply(t, space, kind)


def space_mean(x: torch.Tensor, space: SpaceGroup) -> torch.Tensor:
    """The fp32 mean of a tensor whose slabs lie over the group: the global sum
    over the global count."""
    x = x.float()
    count = torch.full((1,), float(x.numel()), device=x.device)
    total = space_sum(torch.cat([x.sum().reshape(1), count]), space, "mean")
    return total[0] / total[1]


def group_moments(x32: torch.Tensor, space: SpaceGroup) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, mean of squares) over the last axis of (N, G, M) slabs, whose
    other slabs lie on the group's ranks: the fp32 sums and the counts
    all-reduced in one message."""
    n, g, m = x32.shape
    count = torch.full((1,), float(m), dtype=x32.dtype, device=x32.device)
    sums = torch.cat([x32.sum(dim=-1).reshape(-1), (x32 * x32).sum(dim=-1).reshape(-1), count])
    total = space_sum(sums, space, "norm")
    moments = total[:-1].reshape(2, n, g) / total[-1]
    return moments[0], moments[1]


def _with(shape: Sequence[int], dim: int, size: int) -> Tuple[int, ...]:
    shape = list(shape)
    shape[dim] = size
    return tuple(shape)


def _plan(n: int, size: int, ranges: Sequence[Tuple[int, int]]) -> Dict[Tuple[int, int], Tuple[int, int]]:
    """{(holder, wanter): (lo, hi)}: the planes of a global depth ``n`` that rank
    ``holder``'s slab gives to rank ``wanter``, whose range is ``ranges[wanter]``;
    in holder order for each wanter, so a wanter's pieces concatenate in order."""
    return {(q, r): span for r in range(size) for q in range(size)
            for span in [_overlap(slab(n, q, size), ranges[r])] if span is not None}


class _GatherRanges(torch.autograd.Function):
    """Each rank's planes ``ranges[i]`` (clipped to [0, n)) of a tensor whose
    slabs (`slab`) of global size ``n`` along ``dim`` lie over the group."""

    @staticmethod
    def forward(ctx, x, space, dim, n, ranges, kind):
        me, size = space.index, space.size
        own = slab(n, me, size)
        if x.shape[dim] != own[1] - own[0]:
            raise ValueError(f"rank {me} of {size} holds {x.shape[dim]} planes of {n} along axis {dim}, "
                             f"expected {own[1] - own[0]}")
        plan = _plan(n, size, [(max(a, 0), min(max(b, 0), n)) for a, b in ranges])
        ctx.space, ctx.dim, ctx.plan, ctx.kind, ctx.shape, ctx.own = space, dim, plan, kind, x.shape, own
        sends = [(r, x.narrow(dim, lo - own[0], hi - lo)) for (q, r), (lo, hi) in plan.items() if q == me != r]
        mine = [(q, span) for (q, r), span in plan.items() if r == me]
        received = iter(_p2p(space, sends, [(q, _with(x.shape, dim, hi - lo)) for q, (lo, hi) in mine if q != me],
                             x, kind))
        parts = [x.narrow(dim, lo - own[0], hi - lo) if q == me else next(received) for q, (lo, hi) in mine]
        return torch.cat(parts, dim=dim) if parts else x.new_empty(_with(x.shape, dim, 0))

    @staticmethod
    def backward(ctx, grad):
        """Each plane's gradient goes back to its holder, who adds them up."""
        space, dim, plan, own = ctx.space, ctx.dim, ctx.plan, ctx.own
        me = space.index
        mine = [(q, span) for (q, r), span in plan.items() if r == me]
        start = mine[0][1][0] if mine else 0
        given = [(r, span) for (q, r), span in plan.items() if q == me != r]
        received = _p2p(space, [(q, grad.narrow(dim, lo - start, hi - lo)) for q, (lo, hi) in mine if q != me],
                        [(r, _with(ctx.shape, dim, hi - lo)) for r, (lo, hi) in given], grad, ctx.kind)
        out = grad.new_zeros(ctx.shape)
        if (me, me) in plan:
            lo, hi = plan[(me, me)]
            out.narrow(dim, lo - own[0], hi - lo).add_(grad.narrow(dim, lo - start, hi - lo))
        for (_, (lo, hi)), g in zip(given, received):
            out.narrow(dim, lo - own[0], hi - lo).add_(g)
        return out, None, None, None, None, None


def gather_ranges(x: torch.Tensor, space: SpaceGroup, dim: int, n: int, ranges: Sequence[Tuple[int, int]],
                  kind: str) -> torch.Tensor:
    """This rank's planes ``ranges[space.index]`` of the tensor whose slabs of
    global size ``n`` along ``dim`` lie over the group (every rank passes every
    rank's range); the backward sends each plane's gradient back to its owner."""
    return _GatherRanges.apply(x, space, dim, n, list(ranges), kind)


def gather(x: torch.Tensor, space: SpaceGroup, dim: int, kind: str, n: Optional[int] = None) -> torch.Tensor:
    """The whole tensor along ``dim`` on every rank, from its slabs of global size
    ``n`` (by default ``space.size`` equal slabs); the backward sums every rank's
    gradient into the owner's slab."""
    n = x.shape[dim] * space.size if n is None else n
    return gather_ranges(x, space, dim, n, [(0, n)] * space.size, kind)


def halo_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], stride, padding,
              space: SpaceGroup, depth: Optional[int] = None) -> torch.Tensor:
    """A 3-D conv of a depth slab (N, C, d, H, W) of a volume of global depth
    ``depth`` (by default ``space.size`` equal slabs): this rank's slab of the
    output (`slab` of the output depth). Height and width keep their padding."""
    if x.ndim != 5:
        raise ValueError(f"halo_conv takes (N, C, D, H, W) slabs, got {tuple(x.shape)}")
    k, s, p = weight.shape[2], stride[0], padding[0]
    n = depth_of(x, space, depth)
    windows = conv_windows(n, k, s, p, space.size)
    lo, hi, keep = windows[space.index]
    h = gather_ranges(x, space, 2, n, [(a, b) for a, b, _ in windows], "halo")
    h = F.pad(h, (0, 0, 0, 0, max(0, -lo), max(0, hi - n)))
    out = F.conv3d(h, weight, bias, stride=stride, padding=(0, *padding[1:]))
    return out.narrow(2, 0, keep)


@contextlib.contextmanager
def sharded(modules: Iterable[torch.nn.Module], space: Optional[SpaceGroup]):
    """Inside the block, every submodule of ``modules`` that takes a space group
    (a ``space`` class attribute: the convs, norms, resamplers, resnets and
    attentions of `models.blocks`, the AttenUNet, the causal trio's models and
    the PatchDiscriminator) computes on depth slabs over ``space``. A no-op
    without a group."""
    if space is None:
        yield
        return
    marked = [m for module in modules for m in module.modules() if hasattr(type(m), "space")]
    for m in marked:
        m.space = space
    try:
        yield
    finally:
        for m in marked:
            m.space = None
