"""Data-parallel training across cards: the port of the ``data`` axis of
cips_tpu/parallel/mesh.py.

The JAX package lays one mesh over every device and splits each batch over
its ``data`` axis; XLA all-reduces the gradients. The port runs one process a
card, started by torchrun (``python -m torch.distributed.run``), and
DistributedDataParallel all-reduces the gradients of each trained network in
its backward. A JAX *process* is a *node* here (node index and count play
``jax.process_index()`` and ``process_count()``) and a JAX local device is one
local rank:

  * each node's loader yields the batch that JAX's process of the same index
    yields (``--batch_size`` stays the batch of one node), and each rank takes a
    contiguous share of its rows (`Mesh.rows`), or the whole batch when its size
    does not divide by the node's ranks, as JAX then replicates it;
  * random draws of a step (the causal noise, BMGAN's latent) are drawn for the
    global batch, every node's rows in node order, and sliced (`Mesh.global_rows`);
  * forwards whose gradients are not wanted (a frozen critic, a no_grad fake)
    go to the network itself, never through its DDP wrapper.

The ``space`` axis: with ``n_space`` > 1 (`make_mesh`) the ranks form a
(data, space) grid, space innermost as in JAX (rank = data index * n_space +
space index). The ``n_space`` ranks of a *space group* hold the same rows, each
a contiguous depth slab of every volume (`shard_batch` with a spatial axis);
`parallel.spatial` holds what they exchange. The data index takes the place of
the rank in the batch split. Only the flagship trainer (`train_unet`) and its
dry run take ``n_space`` > 1. Without torchrun's environment everything here is
a no-op over one process.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
from typing import Any, Dict, Iterable, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from cips_tpu_torch import default_device
from cips_tpu_torch.parallel.spatial import SpaceGroup, new_group, slab
from cips_tpu_torch import profiling


def shard_rows(n: int, index: int, count: int) -> slice:
    """Rows ``index`` of ``count`` take of a batch of ``n``: a contiguous share when
    ``count`` divides ``n``, else every row (JAX's `shard_batch` replicates such a
    batch: the compute is redundant, the result the same)."""
    if count <= 1 or n % count:
        return slice(0, n)
    share = n // count
    return slice(index * share, (index + 1) * share)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place among the ranks and its device. One process: rank 0
    of 1. ``owns_group``: this process created the process group (`make_mesh`)
    and ends it (`close`). ``space_count`` ranks (the innermost) hold one row's
    depth slabs; ``space`` is this rank's `SpaceGroup` and ``data_group`` the
    process group of the ranks at its space index (both None at ``space_count``
    1, where the data group is the world)."""

    rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    local_world_size: int = 1
    device: torch.device = torch.device("cpu")
    owns_group: bool = False
    space_count: int = 1
    space: Optional[SpaceGroup] = dataclasses.field(default=None, repr=False)
    data_group: Any = dataclasses.field(default=None, repr=False)

    @property
    def space_index(self) -> int:
        return self.rank % self.space_count

    @property
    def data_index(self) -> int:
        return self.rank // self.space_count

    @property
    def data_count(self) -> int:
        return self.world_size // self.space_count

    @property
    def local_data_index(self) -> int:
        """This rank's place among the node's data groups (its rows' share)."""
        return self.local_rank // self.space_count

    @property
    def local_data_count(self) -> int:
        return self.local_world_size // self.space_count

    @property
    def node_index(self) -> int:
        return self.rank // self.local_world_size

    @property
    def node_count(self) -> int:
        return self.world_size // self.local_world_size

    @property
    def distributed(self) -> bool:
        return self.world_size > 1

    @property
    def is_lead(self) -> bool:
        """Rank 0, the one rank that writes logs, visual dumps and checkpoints."""
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a node's batch of ``n`` (`shard_rows` by the data index)."""
        return shard_rows(n, self.local_data_index, self.local_data_count)

    def owns_rows(self, n: int) -> bool:
        """Whether this rank's rows of a node batch of ``n`` are its own: False on
        every rank of a space group but the first, and on every local data group
        but the first when the batch is replicated, so that a gather over ranks
        counts each sample once."""
        return self.space_index == 0 and (self.local_data_index == 0 or n % self.local_data_count == 0)

    def depth_slab(self, n: int) -> slice:
        """This rank's planes of a depth ``n`` that its space group shards (`spatial.slab`)."""
        return slice(*slab(n, self.space_index, self.space_count))

    def global_rows(self, n: int) -> Tuple[int, slice]:
        """(rows of the global batch, this rank's rows in it) for node batches of
        ``n``: every node's batch in node order, as JAX's global array over its
        processes."""
        rows = self.rows(n)
        base = self.node_index * n
        return self.node_count * n, slice(base + rows.start, base + rows.stop)

    def close(self) -> None:
        """End the process group if this process created it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def _topology() -> Tuple[int, int, int, int]:
    """(rank, world size, local rank, local world size) from torchrun's environment."""
    world = _env_int("WORLD_SIZE", 1)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    return _env_int("RANK", 0), world, _env_int("LOCAL_RANK", 0), local_world


def backend_for(device_type: str) -> str:
    """NCCL when each of the node's ranks has a card of its own, else gloo: on the
    CPU, and where the node runs more ranks than it has cards (they share them in
    turn, which NCCL refuses)."""
    _, _, _, local_world = _topology()
    return "nccl" if device_type == "cuda" and local_world <= torch.cuda.device_count() else "gloo"


def initialize_distributed(device_type: str = "cuda", timeout: Optional[float] = None) -> bool:
    """Join the process group that torchrun's environment describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) over `backend_for` the device type; ``timeout`` (seconds)
    bounds its set-up and collectives (PyTorch's default otherwise). A no-op in
    a single process or when a group exists already. Returns True when this
    call created the group."""
    _, world, _, _ = _topology()
    if world <= 1 or dist.is_initialized():
        return False
    dist.init_process_group(backend_for(device_type), init_method="env://", **_timeout(timeout))
    return True


def _timeout(seconds: Optional[float]) -> Dict[str, Any]:
    return {} if seconds is None else {"timeout": datetime.timedelta(seconds=seconds)}


def make_mesh(device: Optional[str] = None, n_space: int = 1, timeout: Optional[float] = None) -> Mesh:
    """This process's `Mesh`, joining torchrun's process group first
    (`initialize_distributed`). Its device is ``cuda:LOCAL_RANK``, made the
    current device (local ranks beyond the node's cards share them in turn), or
    the CPU when ``device`` is "cpu". With ``n_space`` > 1 every rank creates
    the space groups (consecutive ranks, one a data index) and then the data
    groups (one a space index), in that order; a world, or a node, whose rank
    count ``n_space`` does not divide is a ValueError (JAX's `make_mesh`).
    ``timeout`` (seconds) bounds every group's set-up and collectives."""
    dev = default_device(device)
    rank, world, local_rank, local_world = _topology()
    if n_space < 1 or world % n_space or local_world % n_space:
        raise ValueError(f"--n_space {n_space} does not divide the {world} rank(s) ({local_world} on this node)")
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    owns = initialize_distributed(dev.type, timeout)
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    space = data_group = None
    if n_space > 1:
        spaces = [new_group(range(d * n_space, (d + 1) * n_space), **_timeout(timeout))
                  for d in range(world // n_space)]
        datas = [dist.new_group(list(range(s, world, n_space)), **_timeout(timeout)) for s in range(n_space)]
        space, data_group = spaces[rank // n_space], datas[rank % n_space]
    return Mesh(rank=rank, world_size=world, local_rank=local_rank if world > 1 else 0,
                local_world_size=local_world if world > 1 else 1, device=dev, owns_group=owns,
                space_count=n_space, space=space, data_group=data_group)


def barrier(mesh: Mesh) -> None:
    if mesh.distributed:
        dist.barrier()


def shard_space(mesh: Mesh, batch: Mapping[str, Any], spatial_axis: Optional[int] = None) -> Dict[str, Any]:
    """This rank's depth slab of each leaf along ``spatial_axis``, under JAX's
    rule: only where the axis exists and the space count divides it (the
    volumes); any other leaf stays whole, replicated over space (the
    covariate row (B, 1, K))."""
    s = mesh.space_count
    if spatial_axis is None or s == 1:
        return dict(batch)

    def cut(v):
        if v.ndim <= spatial_axis or v.shape[spatial_axis] % s:
            return v
        index = (slice(None),) * spatial_axis + (mesh.depth_slab(v.shape[spatial_axis]),)
        return v[index]

    return {k: cut(v) for k, v in batch.items()}


def shard_batch(mesh: Mesh, batch: Mapping[str, Any], spatial_axis: Optional[int] = None) -> Dict[str, Any]:
    """This rank's rows of a node's batch (arrays or tensors, batch first): JAX's
    `shard_batch` over the data axis (`Mesh.rows`), then over space along
    ``spatial_axis`` (`shard_space`)."""
    return shard_space(mesh, {k: v[mesh.rows(len(v))] for k, v in batch.items()}, spatial_axis)


def _broadcast_(mesh: Mesh, tensor: torch.Tensor) -> None:
    with torch.no_grad():
        buf = tensor.detach().to(mesh.device)
        dist.broadcast(buf, 0)
        if buf is not tensor:
            tensor.copy_(buf)


def replicate(mesh: Mesh, obj):
    """Rank 0's copy into every rank's, in place: a module's parameters and
    buffers, or an optimiser's state tensors (every rank's optimiser must hold
    the same slots). DDP does this for the networks it wraps; this serves the
    frozen perceptual network and the optimiser state. A no-op in one process;
    returns ``obj``."""
    if not mesh.distributed:
        return obj
    if isinstance(obj, nn.Module):
        tensors = [*obj.parameters(), *obj.buffers()]
    elif isinstance(obj, torch.optim.Optimizer):
        tensors = [t for slot in obj.state.values() for t in slot.values() if torch.is_tensor(t)]
    else:
        raise TypeError(f"replicate takes a module or an optimiser, not {type(obj).__name__}")
    for t in tensors:
        _broadcast_(mesh, t)
    return obj


def _counting_allreduce(process_group, bucket):
    """DDP's own all-reduce (each rank's gradients over the world size, summed),
    counting the bucket's bytes as ``ddp.reduced_bytes`` (`cips_tpu_torch.profiling.COUNTERS`)."""
    from torch.distributed.algorithms.ddp_comm_hooks.default_hooks import allreduce_hook

    buf = bucket.buffer()
    profiling.COUNTERS["ddp.reduced_bytes"] += buf.numel() * buf.element_size()
    return allreduce_hook(process_group, bucket)


def data_parallel(module: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """``module`` under DistributedDataParallel when the mesh spans more than one
    process, else ``module`` itself. DDP broadcasts rank 0's parameters at the
    wrap, and the backward of each forward through the wrapper all-reduces the
    gradients (the mean over ranks); every such forward must be followed by
    one backward that reaches every parameter. The bytes all-reduced are
    counted as ``ddp.reduced_bytes``."""
    if mesh is None or not mesh.distributed:
        return module
    ids = [mesh.device.index] if mesh.device.type == "cuda" else None
    wrapped = nn.parallel.DistributedDataParallel(module, device_ids=ids)
    wrapped.register_comm_hook(None, _counting_allreduce)
    return wrapped


def gather(mesh: Mesh, items: list) -> list:
    """Every rank's ``items`` (picklable), concatenated in rank order."""
    if not mesh.distributed:
        return list(items)
    out: List[list] = [None] * mesh.world_size  # type: ignore[list-item]
    dist.all_gather_object(out, list(items))
    return [x for part in out for x in part]


def _pinned(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).pin_memory()


def device_prefetch(iterator: Iterable[Mapping[str, Any]], mesh: Mesh, depth: int = 2,
                    spatial_axis: Optional[int] = None) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of numpy arrays as tensors on the mesh's device, ``depth`` batches
    in flight ahead of the one handed out (JAX's `device_prefetch`), each cut to
    this rank's depth slab along ``spatial_axis`` first (`shard_space`). On a card
    each batch is copied from pinned host memory by non-blocking copies on a
    side stream; the compute stream waits on the copy's event before it gets
    the batch, and ``record_stream`` keeps the allocator from reusing a
    buffer before that stream is done with it. On the CPU it is a plain
    conversion, in order. Spans ``prefetch.pin`` (the batch as contiguous host
    tensors, page-locked on a card) and ``prefetch.copy`` (the side stream's
    copies and their event) and counter ``prefetch.bytes_copied`` (the bytes
    pinned and copied; `cips_tpu_torch.profiling`), the batch's number in
    ``iterator`` its ``seq``."""
    device = mesh.device
    iterator = (shard_space(mesh, batch, spatial_axis) for batch in iterator)
    if device.type != "cuda":
        for seq, batch in enumerate(iterator):
            with profiling.span("prefetch.pin", seq):
                host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
            yield host
        return
    side = torch.cuda.Stream(device)
    queue: collections.deque = collections.deque()

    def ready(entry) -> Dict[str, torch.Tensor]:
        tensors, event = entry
        compute = torch.cuda.current_stream(device)
        compute.wait_event(event)
        for t in tensors.values():
            t.record_stream(compute)
        return tensors

    for seq, batch in enumerate(iterator):
        with profiling.span("prefetch.pin", seq):
            host = {k: _pinned(v) for k, v in batch.items()}
        with profiling.span("prefetch.copy", seq), torch.cuda.stream(side):
            tensors = {k: t.to(device, non_blocking=True) for k, t in host.items()}
            event = torch.cuda.Event()
            event.record(side)
        profiling.COUNTERS["prefetch.bytes_copied"] += sum(t.nbytes for t in host.values())
        queue.append((tensors, event))
        if len(queue) > depth:
            yield ready(queue.popleft())
    while queue:
        yield ready(queue.popleft())
