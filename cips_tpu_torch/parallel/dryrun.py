"""Multi-rank dry run: one sharded train step at N ranks (port of
cips_tpu/parallel/dryrun.py).

    python -m cips_tpu_torch.parallel.dryrun N [--device cpu] [--steps S]
        [--crop D H W] [--dtype f32|bf16] [--n_space S]

starts N ranks on this host (one process each, the layout torchrun gives one
node; `mesh.backend_for` picks NCCL or gloo; a rank on the CPU takes one torch
thread) as a (data, space) mesh of N / S data groups of S ranks, and runs the
flagship's train step (G then D) from seeded weights (`randomize_`) on a seeded global
batch of N / S samples, one a data group, each of its S ranks a depth slab of
it, at the tiny validation shape (8, 16, 8) in fp32. The default S is JAX's
(`default_n_space`). ``CIPS_DRYRUN_TASK=causal`` runs the causal trio instead (encoder, T1
and PET decoders under one Adam, then D) and ``CIPS_DRYRUN_FULL=1`` the bundled
config at the full (96, 128, 96) volume in bf16, as the JAX dry run does (the
causal trio's full mesh then takes ``CIPS_DRYRUN_DATA`` data groups, as JAX's
does); ``--crop`` and ``--dtype`` override the shape and dtype. Any crop the
unsharded model takes will do: a deeper level's slabs may be uneven, and a
depth that S does not divide reaches the ranks whole and runs unsharded.

Where JAX's `_collective_bytes` counts the collectives in the compiled HLO,
the port counts the bytes that DDP all-reduces in each step (a communication
hook on its buckets) and asserts that they equal the trained parameters'
gradient bytes, and that every rank's parameters are identical after the
steps (the largest difference, all-reduced, is 0); it reports the bytes each
rank exchanged over its space group a step, by kind (`spatial.exchanged`).
In fp32 it also asserts
that rank 0's repeat of the steps in one process on the whole global batch
agrees: the first step's gradients within ``TOL_GRADS`` of each tensor's
max|grad| (`compare_grads`), the parameters after it within ``TOL_ONE_PROCESS``
of each tensor's max|value|, but for the elements that Adam moved on rounding
noise (`compare_params`), and the last step's parameters within 2 lr a step.
An fp32 run goes without TF32 and without cuDNN, whose convolutions round
otherwise at another batch size. Rank 0 prints the payload as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from cips_tpu_torch.parallel import mesh as pm
from cips_tpu_torch.parallel import spatial
from cips_tpu_torch import profiling
from cips_tpu_torch.training.common import mean_over_ranks

N_COVARIATES = 5
TINY_CROP = (8, 16, 8)
FULL_CROP = (96, 128, 96)
# W ranks against one process on the same global batch, fp32: only the order of
# the sums over the batch differs (each rank's mean, then DDP's mean of means).
TOL_ONE_PROCESS = 1e-5
# The first step's gradients, W ranks against one process: each tensor within this
# share of its max|grad|, the limit tests/test_torch_port_train.py holds the port's
# gradients to JAX's with (measured here 3-5e-5 from random weights, in tensors
# whose largest gradient is small beside their network's).
TOL_GRADS = 1e-4
# A gradient tensor whose max|grad| is under this share of its network's largest
# holds rounding noise (a conv bias ahead of a norm: exactly 0 in exact
# arithmetic), as tests/test_torch_port_train.py takes it.
NOISE_TENSOR = 1e-3
# A gradient element under this share of its tensor's max|grad| is within the
# gradients' own agreement (TOL_GRADS): its sign, and so Adam's step of the size of
# lr, may go either way.
NOISE_ELEMENT = TOL_GRADS

TINY_FLAGSHIP = {
    "atten_unet_def": {
        "spatial_dims": 3, "in_channels": 1, "out_channels": 1, "num_channels": [8, 8], "num_res_blocks": 1,
        "attention_levels": [False, True], "norm_num_groups": 8, "resblock_updown": True,
        "num_head_channels": [0, 4],
    },
    "discriminator": {"num_channels": 8, "num_layers_d": 1},
    "perceptual_network": {"spatial_dims": 3},
    "training": {"base_lr": 5e-4, "disc_lr": 1e-4, "perceptual_weight": 0, "adv_weight": 0.1},
}
TINY_CAUSAL = {
    "t1_autoencoder_def": {
        "atten_encoder": {
            "spatial_dims": 3, "in_channels": 1, "out_channels": 6, "num_channels": [8, 8], "num_res_blocks": 1,
            "attention_levels": [False, True], "norm_num_groups": 8, "resblock_updown": True,
            "num_head_channels": [0, 4], "with_conditioning": True, "transformer_num_layers": 1,
        },
        "decoder": {
            "spatial_dims": 3, "in_channels": 3, "out_channels": 1, "num_channels": [8, 8], "num_res_blocks": 1,
            "attention_levels": [False, False], "norm_num_groups": 8,
        },
    },
    "pet_decoder_def": {
        "spatial_dims": 3, "in_channels": 3, "out_channels": 1, "num_channels": [8, 8], "num_res_blocks": 1,
        "attention_levels": [False, False], "norm_num_groups": 8, "num_head_channels": [0, 0],
        "with_conditioning": True,
    },
    "discriminator": {"num_channels": 8, "num_layers_d": 1},
    "perceptual_network": {"spatial_dims": 3},
    "training": {"perceptual_weight": 0.02, "adv_weight": 0.005, "kl_weight": 0.001},
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(local_rank: int, world: int, port: int, device: str, out_dir: str, fn: Callable,
                args: tuple, n_space: int, timeout: Optional[float]) -> None:
    os.environ.update(RANK=str(local_rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local_rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if device == "cpu":  # the node's ranks share its cores
        torch.set_num_threads(1)
    mesh = pm.make_mesh(device, n_space=n_space, timeout=timeout)
    try:
        result = fn(mesh, *args)
        torch.save(result, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    finally:
        mesh.close()


class Ranks:
    """Ranks started by `start`; `join` waits for them and returns each rank's result, in rank order."""

    def __init__(self, context, out_dir: tempfile.TemporaryDirectory, n: int, timeout: Optional[float] = None):
        self._context, self._out_dir, self._n, self._timeout = context, out_dir, n, timeout
        self._started = time.monotonic()

    def join(self) -> List[Any]:
        """Each rank's result; with a timeout, ranks still running that many seconds
        after the start are terminated and a TimeoutError raised."""
        try:
            while not self._context.join(None if self._timeout is None else 1.0):
                if self._timeout is not None and time.monotonic() - self._started > self._timeout:
                    for process in self._context.processes:
                        process.terminate()
                    raise TimeoutError(f"{self._n} ranks still running after {self._timeout} s")
            return [torch.load(os.path.join(self._out_dir.name, f"rank{r}.pt"), weights_only=False)
                    for r in range(self._n)]
        finally:
            self._out_dir.cleanup()


def start(fn: Callable, n: int, *args, device: str = "cuda", n_space: int = 1,
          timeout: Optional[float] = None) -> Ranks:
    """Start ``fn(mesh, *args)`` in ``n`` spawned ranks of one node (rank r on
    card r, in turn where there are fewer cards, or all on the CPU), their mesh
    ``n_space`` ranks deep in space, and return at once. ``fn`` must be
    importable by name (a module-level function); its result must pickle.
    ``timeout`` (seconds) bounds the ranks' collectives and `Ranks.join`."""
    import torch.multiprocessing as mp

    out_dir = tempfile.TemporaryDirectory(prefix="cips_dryrun_")
    context = mp.start_processes(_rank_entry,
                                 args=(n, free_port(), device, out_dir.name, fn, args, n_space, timeout),
                                 nprocs=n, join=False, start_method="spawn")
    return Ranks(context, out_dir, n, timeout)


def global_batch(n: int, crop, seed: int) -> Dict[str, torch.Tensor]:
    """A seeded batch of ``n`` samples {"t1", "pet", "info"} (fp32, on the CPU)."""
    rng = np.random.default_rng(seed)
    t1 = rng.random((n, *crop, 1), dtype=np.float32)
    pet = np.clip(t1 * 0.8 + 0.1 * rng.random((n, *crop, 1), dtype=np.float32), 0, 1)
    return {"t1": torch.from_numpy(t1), "pet": torch.from_numpy(pet),
            "info": torch.from_numpy(rng.random((n, 1, N_COVARIATES), dtype=np.float32))}


def randomize_(models, seed: int) -> None:
    """Redraw every parameter from one seeded generator, non-zero everywhere
    (the trainers' init zeroes the output convs, whose weights then hold
    values of the size of lr): weights of two or more axes N(0, 1 / fan-in),
    norm scales 1 + 0.1 N(0, 1), biases 0.1 N(0, 1)."""
    rng = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for model in models:
            for name, p in model.named_parameters():
                draw = torch.randn(p.shape, generator=rng)
                if p.dim() > 1:
                    draw /= float(np.prod(p.shape[1:])) ** 0.5
                else:
                    draw = draw * 0.1 + (1.0 if name.endswith("weight") else 0.0)
                p.copy_(draw)


def _build(task: str, cfg: dict, dtype: torch.dtype, device: torch.device, mesh: Optional[pm.Mesh], n: int,
           depth: int):
    """(state, step, trained networks) for ``task`` on volumes of depth ``depth``,
    every weight drawn by `randomize_`."""
    from cips_tpu_torch.training import causal_task, unet_synthesis

    train_cfg = cfg["training"]
    if task == "causal":
        models = causal_task.build_models(cfg, N_COVARIATES, dtype=dtype, device=device, seed=0)
        randomize_(models[:4], seed=1)
        state = causal_task.init_state(*models, train_cfg, mesh=mesh)
        step = causal_task.make_train_step(train_cfg, mesh=mesh, batch_size=n, volume_depth=depth)
        rng = torch.Generator(device).manual_seed(1)
        return state, (lambda s, b: step(s, b, rng)), {"generator": state.gen, "discriminator": state.d}
    g, d, p = unet_synthesis.build_models(cfg, N_COVARIATES, dtype=dtype, device=device, seed=0)
    randomize_((g, d), seed=1)
    state = unet_synthesis.init_state(g, d, train_cfg, p, mesh=mesh)
    return (state, unet_synthesis.make_train_step(train_cfg, mesh=mesh, volume_depth=depth),
            {"generator": g, "discriminator": d})


def _copy(t: torch.Tensor) -> torch.Tensor:
    """A copy on the CPU in fp32 (never the tensor itself: the next step updates it in place)."""
    return t.detach().to("cpu", torch.float32, copy=True)


def run_steps(mesh: Optional[pm.Mesh], task: str, cfg: dict, crop, dtype: torch.dtype, steps: int, n: int,
              device: torch.device) -> Dict[str, Any]:
    """``steps`` train steps on seeded global batches of ``n`` samples (this
    rank's rows of them across ranks, its depth slab of those over space): the
    metrics (the global batch's, `mean_over_ranks`), the bytes all-reduced by
    DDP and exchanged over the space group in each step, the trained networks'
    gradients and parameters after each step (on the CPU, fp32), and each
    step's time (CUDA events on a card, else the host clock)."""
    state, step, nets = _build(task, cfg, dtype, device, mesh, n, crop[0])
    out: Dict[str, Any] = {"metrics": [], "reduced_bytes": [], "space_bytes": [], "step_ms": []}
    for i in range(steps):
        batch = global_batch(n, crop, seed=100 + i)
        if mesh is not None:
            batch = pm.shard_batch(mesh, batch, spatial_axis=1)
        batch = {k: v.to(device) for k, v in batch.items()}
        profiling.reset("ddp.reduced_bytes")
        profiling.reset("space.exchanged.")
        t0 = time.perf_counter()
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        metrics = step(state, batch)
        if device.type == "cuda":
            end.record()
            end.synchronize()
            out["step_ms"].append(start.elapsed_time(end))
        else:
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["reduced_bytes"].append(profiling.COUNTERS["ddp.reduced_bytes"])
        out["space_bytes"].append(spatial.exchanged())
        out["metrics"].append(mean_over_ranks(metrics, mesh))
        out.setdefault("grads", []).append({f"{net}.{k}": _copy(p.grad) for net, m in nets.items()
                                            for k, p in m.named_parameters() if p.grad is not None})
        out.setdefault("params", []).append({f"{net}.{k}": _copy(v) for net, m in nets.items()
                                             for k, v in m.state_dict().items()})
    out["grad_bytes"] = sum(p.numel() * p.element_size() for m in nets.values() for p in m.parameters()
                            if p.requires_grad)
    out["lrs"] = {"generator": state.opt_g.param_groups[0]["lr"], "discriminator": state.opt_d.param_groups[0]["lr"]}
    return out


def max_rank_difference(mesh: pm.Mesh, params: Dict[str, torch.Tensor]) -> float:
    """The largest difference of any parameter from rank 0's, over every rank."""
    worst = torch.zeros((), dtype=torch.float64, device=mesh.device)
    for v in params.values():
        mine = v.to(mesh.device)
        ref = mine.clone()
        dist.broadcast(ref, 0)
        worst = torch.maximum(worst, (mine - ref).abs().max().double())
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return float(worst)


def _net_max(grads: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each network's largest gradient element (keys "{network}.{parameter}")."""
    out: Dict[str, float] = {}
    for k, g in grads.items():
        net = k.split(".", 1)[0]
        out[net] = max(out.get(net, 0.0), g.abs().max().item())
    return out


def compare_grads(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> float:
    """The largest difference of a gradient tensor over its max|grad| (``want``'s),
    over the tensors whose max|grad| is at least NOISE_TENSOR of their network's
    largest; a tensor under that holds rounding noise (a conv bias ahead of a
    norm: exactly 0) and must stay under it on both sides, else inf."""
    net_max, worst = _net_max(want), 0.0
    for k, g in want.items():
        floor = NOISE_TENSOR * net_max[k.split(".", 1)[0]]
        scale = g.abs().max().item()
        if scale < floor:
            if got[k].abs().max().item() >= floor:
                return float("inf")
            continue
        worst = max(worst, (got[k] - g).abs().max().item() / scale)
    return worst


def compare_params(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], grads: List[Dict[str, torch.Tensor]],
                   lrs: Dict[str, float]) -> Dict[str, Any]:
    """Parameters after the steps, ``got`` against ``want`` (whose steps' gradients
    are ``grads``): the largest difference over each tensor's max|value|
    (``max_rel``), over every element whose gradient was rounding noise in no
    step: under NOISE_ELEMENT of its tensor's max|grad|, or in a tensor under
    NOISE_TENSOR of its network's largest. Adam's update lr * m / (sqrt(v) + eps)
    has the size of lr whatever the gradient's, so an element whose gradient is
    noise moves by up to lr either way: those are held within 2 lr a step
    (``noise_elements``; ``max_noise_lr``, the largest such difference in units
    of lr)."""
    maxima = [_net_max(g) for g in grads]
    worst, worst_name, n_noise, worst_noise = 0.0, None, 0, 0.0
    for k, v in want.items():
        net = k.split(".", 1)[0]
        diff = (got[k] - v).abs()
        noise = torch.zeros_like(v, dtype=torch.bool)
        for g, m in zip(grads, maxima):
            if k in g:
                scale = g[k].abs().max()
                noise |= (g[k].abs() < NOISE_ELEMENT * scale) | (scale < NOISE_TENSOR * m[net])
        if noise.any():
            n_noise += int(noise.sum())
            worst_noise = max(worst_noise, diff[noise].max().item() / lrs[net])
        if (~noise).any():
            rel = diff[~noise].max().item() / max(v.abs().max().item(), 1e-30)
            if rel > worst:
                worst, worst_name = rel, k
    ok = worst <= TOL_ONE_PROCESS and worst_noise <= 2 * len(grads)
    return {"max_rel": worst, "worst": worst_name, "noise_elements": n_noise, "max_noise_lr": worst_noise,
            "ok": bool(ok)}


def _config(task: str, full: bool) -> dict:
    if not full:
        return TINY_CAUSAL if task == "causal" else TINY_FLAGSHIP
    from cips_tpu_torch.cli.common import load_config

    return load_config(None, "training_causal.json" if task == "causal" else "training.json")


def dryrun_rank(mesh: pm.Mesh, task: str, full: bool, crop, dtype_name: str, steps: int) -> Dict:
    """One rank of the dry run (see the module's docstring); rank 0 returns the payload."""
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    if dtype == torch.float32:
        # fp32 products in fp32 (no TF32), and PyTorch's own convolutions: cuDNN's fp32
        # algorithms differ with the batch size (a rank's rows against the whole batch) and
        # part by up to 3.9e-3 of a gradient tensor's max|grad| on an H100, which would hide
        # the reduction over ranks that the comparison is about (scripts/probe_dp_cudnn.py)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.enabled = False
    cfg = _config(task, full)
    n = mesh.data_count  # one sample a data group
    run = run_steps(mesh, task, cfg, crop, dtype, steps, n, mesh.device)
    for i, m in enumerate(run["metrics"]):
        key = "rec_pet_loss" if task == "causal" else "g_loss"
        assert np.isfinite(m[key]), f"non-finite {key} in step {i} of the dry run: {m}"
    if mesh.distributed:
        assert all(b == run["grad_bytes"] for b in run["reduced_bytes"]), (
            f"DDP all-reduced {run['reduced_bytes']} bytes a step; the trained gradients hold {run['grad_bytes']}")
    payload = {"task": task, "ranks": mesh.world_size, "n_space": mesh.space_count, "device": str(mesh.device),
               "crop": list(crop), "dtype": dtype_name, "global_batch": n, "steps": steps,
               "reduced_bytes_per_step": run["reduced_bytes"], "space_bytes_per_step": run["space_bytes"],
               "grad_bytes": run["grad_bytes"], "step_ms": run["step_ms"], "metrics": run["metrics"]}
    payload["max_rank_diff"] = max_rank_difference(mesh, run["params"][-1]) if mesh.distributed else 0.0
    assert payload["max_rank_diff"] == 0.0, f"replicas differ by {payload['max_rank_diff']}"
    if dtype == torch.float32 and mesh.is_lead:
        one = run_steps(None, task, cfg, crop, dtype, steps, n, mesh.device)
        # the first step from the same weights on both sides: its gradients, and the parameters it
        # gives. A later step starts from weights that Adam's noise already moved (see
        # compare_params), which a full-width network's gradients then carry into every tensor;
        # the last step's parameters are held within Adam's reach, 2 lr a step.
        verdict = compare_params(run["params"][0], one["params"][0], one["grads"][:1], one["lrs"])
        verdict["grads_max_rel"] = compare_grads(run["grads"][0], one["grads"][0])
        verdict["last_max_lr"] = max((run["params"][-1][k] - v).abs().max().item() / one["lrs"][k.split(".", 1)[0]]
                                     for k, v in one["params"][-1].items())
        verdict["last_max_rel"] = compare_params(run["params"][-1], one["params"][-1], one["grads"],
                                                 one["lrs"])["max_rel"]
        verdict["ok"] &= verdict["grads_max_rel"] <= TOL_GRADS and verdict["last_max_lr"] <= 2 * steps
        payload["one_process"] = {**verdict, "metrics": one["metrics"]}
        assert verdict["ok"], f"W ranks vs one process: {payload['one_process']}"
    return payload if mesh.is_lead else {}


def default_n_space(n: int, task: str, full: bool) -> int:
    """JAX's dry-run mesh (cips_tpu/parallel/dryrun.py): at the full volume data
    2 (1 when ``n`` is odd) times space the rest, the causal trio's data count
    ``CIPS_DRYRUN_DATA`` when set (`_run_causal`); else space 2 when ``n`` is even."""
    if not full:
        return 2 if n % 2 == 0 else 1
    data = 2 if n % 2 == 0 else 1
    if task == "causal":
        data = int(os.environ.get("CIPS_DRYRUN_DATA", data))
    if data < 1 or n % data:
        raise ValueError(f"CIPS_DRYRUN_DATA={data} does not divide the {n} ranks")
    return n // data


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n", type=int, help="ranks")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--crop", type=int, nargs=3, default=None)
    p.add_argument("--dtype", default=None, choices=["f32", "bf16"])
    p.add_argument("--n_space", type=int, default=None, help="ranks a volume's depth is sharded over")
    args = p.parse_args(argv)
    task = os.environ.get("CIPS_DRYRUN_TASK", "flagship")
    full = bool(os.environ.get("CIPS_DRYRUN_FULL"))
    n_space = args.n_space if args.n_space is not None else default_n_space(args.n, task, full)
    crop = tuple(args.crop) if args.crop else (FULL_CROP if full else TINY_CROP)
    dtype = args.dtype or ("bf16" if full else "f32")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    payload = start(dryrun_rank, args.n, task, full, crop, dtype, args.steps, device=args.device,
                    n_space=n_space).join()[0]
    print(json.dumps(payload))
    print(f"dryrun ok on {args.n} ranks, space {n_space} ({task}, {'x'.join(map(str, crop))}, {dtype})")
    return payload


if __name__ == "__main__":
    main(sys.argv[1:])
