"""The comparison that decides ``correct``: a record of the program's first
steps against the plain reference's record of the same steps.

A record (`portbench.reference.train.Reference.train` makes the reference's,
the harness the program's) holds each step's loss terms, each trained leaf's
first-gradient norm (the program's worked out from Adam's first moment after
one step), each leaf's change norm after the steps, and the first step's
generator outputs. The readings:

  loss    the worst relative gap of the first step's loss terms;
  grad    the median leaf's gap of first-gradient norms, each leaf's gap over
          the larger of its reference norm and the median leaf's;
  change  the same for the change of the leaves over the steps;
  grad_sign.<net>  the first gradient as whole tensors (rank 0's), each
          network ("g", "d") apart: the share of the reference gradient's mass,
          sum |g_ref| over the network's leaves, on elements where the
          program's gradient has the other sign. Adam's first step is about
          each element's sign, so this is the share of it taken the wrong way;
          it sees what a norm cannot, such as a loss whose mean leaves rows out;
  leaf_sign.<net>  the same share taken leaf by leaf, the network's median leaf's;
  replicas  across ranks, the worst gap between a rank's leaf norms and rank 0's
          (DDP keeps the replicas identical: an exact comparison).

Both leaf numbers leave out the leaves whose reference gradient is under a
thousandth of the median leaf's: a conv bias that a norm removes whole has a
gradient of nought in the reference and of rounding in bf16, and Adam, which
divides by the gradient's own scale, then moves it by round-off alone.

Why the first step's loss and the median leaf, and not every step's loss and
the worst leaf (PERF.md gives both readings): in bf16 the worst leaf is a bias
whose true gradient is the small remainder of large per-channel terms that a
one-channel-a-group norm cancels (the flagship's 16-channel first level), its
gap 0.24-0.87 from seed to seed; and Adam's first steps, a sign step an
element, carry that rounding into the later steps' losses, 0.04-1.2 apart.

A cell compares the numbers it gives a limit (``limits`` in its file); a
number for which neither the control nor a fault of the program gives an
upper reading, the first step's loss in both one-card cells, is printed and not
compared (PERF.md gives its readings).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Mapping

QUIET_GRADIENT = 1e-3  # of the median leaf's reference gradient norm


def _median_leaf(got: Mapping[str, float], want: Mapping[str, float], keep) -> float:
    names = [k for k in want if k in keep]
    if not names:
        return math.inf
    floor = statistics.median(want[k] for k in names)
    gaps = [abs(got.get(k, 0.0) - want[k]) / max(want[k], floor, 1e-30) for k in names]
    return statistics.median(g if math.isfinite(g) else math.inf for g in gaps)


def sign_shares(got: Mapping, want: Mapping, keep) -> Dict[str, float]:
    """Each network's (a leaf's name up to its first dot) share of sum |want|
    over its kept leaves that lies on elements where ``got``'s sign differs
    from ``want``'s."""
    import torch

    turned: Dict[str, float] = {}
    mass: Dict[str, float] = {}
    for k, w in want.items():
        if k not in keep:
            continue
        net, g, w = k.split(".")[0], got.get(k), w.float()
        if g is None or g.shape != w.shape:
            turned[net], mass[net] = math.inf, 1.0
            continue
        weight = w.abs()
        flipped = torch.sign(g.to(w.device).float()) != torch.sign(w)
        turned[net] = turned.get(net, 0.0) + float((weight * flipped).sum())
        mass[net] = mass.get(net, 0.0) + float(weight.sum())
    return {n: turned[n] / mass[n] if mass[n] > 0 else math.inf for n in mass}


def leaf_sign_shares(got: Mapping, want: Mapping, keep) -> Dict[str, float]:
    """Each kept leaf's share of sum |want| on elements where ``got``'s sign differs."""
    out = {}
    for k, w in want.items():
        if k in keep:
            out[k] = sign_shares({"leaf": got.get(k)}, {"leaf": w}, {"leaf"})["leaf"]
    return out


def readings(prog: Mapping, want: Mapping) -> Dict[str, float]:
    loss = math.inf if not prog["losses"] else 0.0
    for k, w in want["losses"][0].items():
        g = prog["losses"][0].get(k, math.nan) if prog["losses"] else math.nan
        gap = abs(g - w) / abs(w) if w != 0 else (0.0 if g == 0 else math.inf)
        loss = max(loss, gap if math.isfinite(gap) else math.inf)
    grads = want["grads"]
    floor = statistics.median(grads.values())
    moving = {k for k, v in grads.items() if v >= QUIET_GRADIENT * floor}
    output = 0.0
    for k, w in want["outputs"].items():
        g = prog["outputs"].get(k)
        gap = math.inf if g is None or g.shape != w.shape else float((g - w).norm() / w.norm().clamp_min(1e-30))
        output = max(output, gap if math.isfinite(gap) else math.inf)
    out = {"loss": loss, "grad": _median_leaf(prog["grads"], grads, moving),
           "change": _median_leaf(prog["changes"], want["changes"], moving), "output": output}
    if "grad_tensors" in prog and "grad_tensors" in want:
        got, ref = prog["grad_tensors"], want["grad_tensors"]
        for net, share in sign_shares(got, ref, moving).items():
            out[f"grad_sign.{net}"] = share
        leaves = leaf_sign_shares(got, ref, moving)
        for net in sorted({k.split(".")[0] for k in leaves}):
            out[f"leaf_sign.{net}"] = statistics.median(v for k, v in leaves.items() if k.split(".")[0] == net)
    return out


def replicas(progs) -> float:
    """The worst gap between a rank's leaf norms (first gradients and changes) and
    rank 0's, over the larger of rank 0's norm and its median leaf's: nought where
    DDP keeps the replicas identical, as its all-reduce does; 0 on one rank."""
    worst = 0.0
    for key in ("grads", "changes"):
        base = progs[0][key]
        floor = statistics.median(base.values()) if base else 0.0
        for prog in progs[1:]:
            for k, v in base.items():
                gap = abs(prog[key].get(k, math.nan) - v) / max(v, floor, 1e-30)
                worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def verdict(values: Mapping[str, float], limits: Mapping[str, float]) -> bool:
    """Every number the cell compares (those it gives a limit) within its limit."""
    return bool(limits) and all(values[k] <= limits[k] for k in limits)


def lines(values: Mapping[str, float], limits: Mapping[str, float]) -> list:
    return [f"check {k} {values[k]!r} limit {limits[k]!r}" for k in sorted(limits)]


def summary(values: Mapping[str, float], limits: Mapping[str, float]) -> dict:
    """{name: {"value", "limit"}} of the compared numbers, a non-finite value
    written as 1e300 (JSON has no infinity)."""
    return {k: {"value": values[k] if math.isfinite(values[k]) else 1e300, "limit": limits[k]}
            for k in sorted(limits)}

