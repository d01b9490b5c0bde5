"""One run of one cell: set-up, the measured window, the optional profiled
steps, then the check against the plain reference.

Set-up builds the program from the benchmark's weights and store (both drawn
from the seed on the device), and drives the program's own feed and train
step through its first `CHECK_STEPS` steps, recording what the check
compares; those steps also build the kernel library and warm every shape. The
window then runs the same feed and step, as the training CLIs loop them (the
metrics read on the host every `READ_EVERY` steps), for ``seconds`` of host
clock, and ends in a device synchronise. With ``trace``, `PROFILE_STEPS` more
steps run under ``torch.profiler``, recording the device alone. Then the
program is freed and the reference follows the first steps in fp32 from the
same weights and rows.

A cell names its configuration and traffic; the configuration its model
family (`portbench/tasks/<family>.py`), the traffic its feed
(`portbench/feeds/<feed>.py`). Nothing here knows a family or a feed by name.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import math
import os
import sys
import time
from types import SimpleNamespace
from typing import Callable, Mapping, Optional

import torch
from torch.profiler import ProfilerActivity, profile

from portbench import check, data, trace
from portbench.reference import models as ref
from portbench.reference.train import norms

PKG = os.path.dirname(os.path.abspath(__file__))
CHECK_STEPS = 3
READ_EVERY = 10  # the training CLIs log the ranks' mean metrics every 10 steps
PROFILE_STEPS = 5
# idle host time between the profiler's start or stop and the window's markers, so that
# no marker falls near the edge of the profiler's capture window, outside which it drops records
SETTLE_S = 0.05
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# the port's loss functions, each a mean over a batch's rows ("half_loss" takes it over half of them)
BATCH_MEAN_LOSSES = ("l1_loss", "kl_divergence", "patch_adversarial_loss", "lsgan_discriminator_loss")


def load(kind: str, name: str) -> dict:
    with open(os.path.join(PKG, kind, f"{name}.json"), encoding="utf-8") as f:
        return json.load(f)


def names(kind: str, suffix: str) -> list:
    return sorted(f[:-len(suffix)] for f in os.listdir(os.path.join(PKG, kind)) if f.endswith(suffix)
                  and not f.startswith("_"))


def cell_parts(cell_name: str, overrides: Optional[Mapping] = None):
    """(cell, configuration, traffic); ``overrides`` replaces configuration and
    traffic keys (the CPU tests' small volumes)."""
    cell = load("cells", cell_name)
    cfg, traffic = load("configs", cell["config"]), load("traffic", cell["traffic"])
    for key, value in (overrides or {}).items():
        (traffic if key in traffic else cfg)[key] = value
    return cell, dict(cfg, batch=int(traffic["batch"])), traffic


def modules(cfg: Mapping, traffic: Mapping) -> tuple:
    """(the family's task module, the traffic's feed module)."""
    return (importlib.import_module(f"portbench.tasks.{cfg['family']}"),
            importlib.import_module(f"portbench.feeds.{traffic['feed']}"))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reference_inputs(task, feed, cfg: Mapping, traffic: Mapping, store, seed: int, device, steps: int = CHECK_STEPS):
    """The samples of the first ``steps`` batches and the noise of each step (or None)."""
    return (feed.reference_samples(store, traffic, seed, steps, device),
            task.reference_noise(cfg, int(traffic["batch"]), steps, seed, device))


def reference_record(task, cfg, weights, batches, noises, device, precision=ref.PLAIN) -> dict:
    """The reference's record of the first steps (the control's with an fp8 ``precision``), TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        r = task.REFERENCE(cfg, precision)
    return r.load(weights, device).train(batches, noises)


def count_work(task, cfg: Mapping) -> tuple:
    """(model FLOPs of one step, the step's self-attention sites) of ``cfg``'s
    batch, from the reference at the cell's shapes on the meta device: G's forward and backward,
    D's forward and backward to its input in the G step and to its weights in
    the D step, LPIPS's forward and backward to its input; nothing recomputed."""
    from torch.utils.flop_counter import FlopCounterMode

    sites: list = []
    with torch.device("meta"):
        r = task.REFERENCE(cfg, ref.Precision(recompute=False, sites=sites))
        r.opt_g = r.opt_d = SimpleNamespace(zero_grad=lambda **_: None, step=lambda: None)
        b, vol, k = cfg["batch"], cfg["volume"], cfg["covariates"]
        samples = [{"t1": torch.zeros(1, *vol, 1), "pet": torch.zeros(1, *vol, 1), "info": torch.zeros(1, 1, k)}
                   for _ in range(b)]
        noise = task.reference_noise(cfg, b, 1, 0, "meta")
        with FlopCounterMode(display=False) as counter:
            r.step(samples, None if noise is None else noise[0])
    return float(counter.get_total_flops()), sites


@contextlib.contextmanager
def half_loss():
    """The fault "half_loss": the port's batch-mean losses, where its train
    steps call them, take their mean over the first half of the rows: the
    forward runs on the whole batch, the losses and the backward leave half of
    it out."""
    from cips_tpu_torch import losses

    swaps = []
    for name in BATCH_MEAN_LOSSES:
        whole = getattr(losses, name)

        def halved(*args, _whole=whole, **kwargs):
            return _whole(*(a[: len(a) // 2] if isinstance(a, torch.Tensor) and a.dim() else a for a in args),
                          **kwargs)

        for mod in list(sys.modules.values()):
            if (getattr(mod, "__name__", "").startswith("cips_tpu_torch.") and mod is not losses
                    and getattr(mod, name, None) is whole):
                swaps.append((mod, name, whole))
                setattr(mod, name, halved)
    try:
        yield
    finally:
        for mod, name, whole in swaps:
            setattr(mod, name, whole)


def run(cell_name: str, seed: int, seconds: float, trace_on: bool, device: str = "cuda",
        t0: Optional[float] = None, fault: Optional[str] = None, overrides: Optional[Mapping] = None,
        log: Callable[[str], None] = print, keep: Optional[dict] = None) -> dict:
    """The result of one run (the dict printed as the last line). ``fault`` plants
    a defect in the timed path for the tests: "frozen" (the optimisers never
    step), "half_batch" (each step sees the first half of its rows),
    "half_loss" (the whole batch forward, the losses over half of it),
    "no_exchange" (across ranks, DDP's gradient all-reduce left out). ``keep``
    receives the program's and the reference's records ("prog", "want").

    Across ranks (torchrun's environment, `cips_tpu_torch.parallel.mesh`) every
    rank runs this: its rows of each node batch, DDP's all-reduce, the window
    ended where the ranks read their metrics; rank 0 gathers every rank's
    record and numbers, runs the reference on the whole batch and returns the
    result, the other ranks an empty dict."""
    t0 = time.time() if t0 is None else t0
    from cips_tpu_torch.parallel.mesh import gather, make_mesh
    from cips_tpu_torch.training.common import mean_over_ranks

    cell, cfg, traffic = cell_parts(cell_name, overrides)
    task, feeder = modules(cfg, traffic)
    mesh = make_mesh(device)
    dev = mesh.device
    with torch.device("meta"):
        spec = task.REFERENCE(cfg).nets
    weights = data.make_weights(spec, seed, dev)
    store = feeder.make_store(traffic, cfg, seed, dev)
    program = task.build(cfg, weights, mesh, seed, DTYPES[cfg["dtype"]])
    planted = contextlib.ExitStack()
    if fault == "frozen":
        for opt in program.opts.values():
            opt.step = lambda *a, **k: None
    elif fault == "half_loss":
        planted.enter_context(half_loss())
    feed = feeder.program_batches(store, traffic, cfg, mesh, seed)
    done, bad, spans = [0], [0], []

    def step() -> tuple:
        t = time.perf_counter()
        batch = next(feed)
        t_fed = time.perf_counter()
        if fault == "half_batch":
            batch = {k: v[: len(v) // 2] for k, v in batch.items()}
        with contextlib.ExitStack() as unsynced:
            if fault == "no_exchange":
                for net in program.wrapped():
                    unsynced.enter_context(net.no_sync())
            metrics = program.step(batch)
        t_stepped = time.perf_counter()
        spans.extend([("portbench.loader_next", t, t_fed), ("portbench.step", t_fed, t_stepped)])
        done[0] += 1
        if done[0] % READ_EVERY == 0:
            bad[0] += not math.isfinite(mean_over_ranks(metrics, mesh)["g_loss"])
            spans.append(("portbench.metric_read", t_stepped, time.perf_counter()))
        return metrics, t_fed - t

    hooks = program.capture()
    losses = []
    for s in range(CHECK_STEPS):
        metrics, _ = step()
        losses.append(mean_over_ranks(metrics, mesh))
        bad[0] += not math.isfinite(losses[-1]["g_loss"])
        if s == 0:
            for h in hooks:
                h.remove()
            first_grads = program.first_grads()  # on the host, out of the window's memory
    changes = norms({k: v.detach() - weights[k] for k, v in program.leaves().items()})

    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - t0
    start, waits = time.perf_counter(), []
    while True:
        waits.append(step()[1])
        if not mesh.distributed:
            if time.perf_counter() - start >= seconds:
                break
        elif done[0] % READ_EVERY == 0 and agreed(time.perf_counter() - start >= seconds, mesh):
            break  # ranks stop together, where they read the metrics anyway
    sync(dev)
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    steps = len(waits)
    log(f"window: {steps} steps of {traffic['batch']} samples in {window_s!r} s; set-up {setup_s!r} s; "
        f"peak {peak} bytes")

    profile_of = None
    if trace_on:
        # the device's records alone: recording every host operation would slow the host-paced step
        activities = [ProfilerActivity.CUDA] if dev.type == "cuda" else [ProfilerActivity.CPU]
        with profile(activities=activities) as prof:
            sync(dev)
            time.sleep(SETTLE_S)
            spans.clear()
            host = [time.perf_counter()]
            trace.mark(dev)
            for _ in range(PROFILE_STEPS):
                step()
            sync(dev)
            trace.mark(dev)
            sync(dev)
            host.append(time.perf_counter())
            time.sleep(SETTLE_S)
        profile_of = trace.from_profiler(prof, PROFILE_STEPS, spans, tuple(host))
        log(f"profiled: {1e3 * (host[1] - host[0]) / PROFILE_STEPS!r} ms a step on the host clock, "
            f"the window's {1e3 * window_s / steps!r}; "
            + ("no device records" if profile_of is None else
               f"{len(profile_of.kernels)} kernels, {profile_of.markers} of 2 edges placed by a marker, "
               f"busy {profile_of.busy_s()!r} s of {profile_of.window_s!r} s"))
    planted.close()

    # every rank's own record and numbers, in rank order
    ranks = gather(mesh, [(norms(first_grads), changes, dict(program.captured), int(peak),
                           None if profile_of is None else (profile_of.busy_s(), profile_of.window_s))])
    del program, feed, metrics
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not mesh.is_lead:
        mesh.close()
        return {}
    t = time.perf_counter()
    batches, noises = reference_inputs(task, feeder, cfg, traffic, store, seed, dev)
    want = reference_record(task, cfg, weights, batches, noises, dev)
    log(f"reference: {CHECK_STEPS} steps in {time.perf_counter() - t!r} s")
    outputs = {k: torch.cat([r[2][k] for r in ranks]) for k in ranks[0][2]}
    progs = [{"losses": losses, "grads": r[0], "changes": r[1], "outputs": outputs} for r in ranks]
    progs[0]["grad_tensors"] = first_grads  # rank 0's own, whole
    per_rank = [check.readings(prog, want) for prog in progs]
    values = {k: max(v[k] for v in per_rank if k in v) for k in per_rank[0]}
    values["replicas"] = check.replicas(progs)
    if keep is not None:
        keep.update(prog=progs[0], want=want, ranks=progs)
    limits = cell.get("limits", {})
    correct = check.verdict(values, limits) and bad[0] == 0
    for k in sorted(set(values) - set(limits)):
        log(f"reading {k} {values[k]!r} (not compared)")

    peak = max(r[3] for r in ranks)
    if trace_on:
        rows = mesh.rows(int(traffic["batch"]))  # each rank's share: the work its own card does
        flops, sites = count_work(task, dict(cfg, batch=rows.stop - rows.start))
        ctx = SimpleNamespace(steps=steps, window_s=window_s, waits=waits, flops_per_step=flops, sites=sites,
                              element_bytes=torch.finfo(DTYPES[cfg["dtype"]]).bits // 8,
                              profiles=[] if profile_of is None else [profile_of])
        metrics_out = {}
        for name in names("metrics", ".py"):
            reader = importlib.import_module(f"portbench.metrics.{name}")
            value = reader.read(ctx)
            if value is not None:
                metrics_out[name] = {"value": value, "unit": reader.UNIT}
    else:
        metrics_out = {"train_samples_per_s": {"value": steps * int(traffic["batch"]) / window_s,
                                               "unit": "samples/s"},
                       "peak_mem_gib": {"value": peak / 2**30, "unit": "GiB"},
                       "setup_s": {"value": setup_s, "unit": "s"}}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "count": mesh.world_size, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": steps, "failed": int(bad[0]), "metrics": metrics_out,
              "device": dev_info}
    if profile_of is not None:
        busy = [r[4] for r in ranks if r[4] is not None]
        dev_info["busy_s"] = sum(b for b, _ in busy) / len(busy)
        dev_info["window_s"] = sum(w for _, w in busy) / len(busy)
        result["breakdown"] = trace.breakdown([profile_of])
    for line in check.lines(values, limits):
        log(line)
    result["check"] = check.summary(values, limits)
    mesh.close()
    return result


def agreed(flag: bool, mesh) -> bool:
    """True on every rank when ``flag`` is True on any."""
    import torch.distributed as dist

    t = torch.tensor([float(flag)], device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
