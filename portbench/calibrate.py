"""The readings a cell's limits are set from, in one process on the chip:

  python3 portbench/calibrate.py --workload <cell> --seeds <a> <b> ... \
      [--control <n>] [--fault <half_batch|half_loss|no_exchange> <n>] [--out <file.jsonl>]

For each seed, a run of the cell with no measured window (the program's first
steps through its own feed and step against the reference): the program's
readings, the lower ends of the limits. ``--control n``: on the first n seeds,
the reference computed with every product's operands in fp8 (e4m3) put in the
program's place, against the fp32 reference. ``--fault kind n``: on the first
n seeds, the program's step fed half its rows, or its losses taken over half
of them, or across ranks its gradients not exchanged (`harness.run`'s faults). A state left unchanged reads 1 on
``grad`` and ``change`` and needs no run. A cell on several chips runs one
process a chip (`run.launch`), every seed's run in one process group. One JSON line a reading
goes to standard output and to ``--out``. The benchmark's own runs never run
this.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def survey(prog: dict, want: dict) -> dict:
    """Candidate numbers beside the check's, and what sets each: the worst loss
    term by step, the worst leaves by gradient and by change, the median leaf's
    gaps, for finding why a reading is what it is."""
    import statistics

    from portbench import check

    out = dict(check.readings(prog, want))
    terms = []
    for s, (g, w) in enumerate(zip(prog["losses"], want["losses"])):
        for k in w:
            if w[k]:
                terms.append((abs(g.get(k, float("nan")) - w[k]) / abs(w[k]), f"step{s + 1}.{k}", g.get(k), w[k]))
    terms.sort(key=lambda t: -t[0])
    out["loss.steps"] = terms[0][0] if terms else 0.0
    out["loss.worst_terms"] = terms[:4]
    floor = statistics.median(want["grads"].values())
    moving = [k for k, v in want["grads"].items() if v >= check.QUIET_GRADIENT * floor]
    for name in ("grads", "changes"):
        w, g = want[name], prog[name]
        med = statistics.median(w[k] for k in moving)
        gaps = sorted(((abs(g.get(k, 0.0) - w[k]) / max(w[k], med), k, g.get(k), w[k]) for k in moving),
                      key=lambda t: -t[0])
        out[f"{name}.worst_leaf"] = gaps[0][0]
        out[f"{name}.p90_leaf"] = gaps[len(gaps) // 10][0]
        out[f"{name}.worst_leaves"] = gaps[:4]
        out[f"{name}.over_tenth"] = sum(t[0] > 0.1 for t in gaps)
    out["leaves"] = len(moving)
    return out


def control_readings(cell: str, seed: int) -> dict:
    import torch

    from portbench import data, harness
    from portbench.reference import models as ref

    _, cfg, traffic = harness.cell_parts(cell)
    task, feeder = harness.modules(cfg, traffic)
    dev = torch.device("cuda")
    with torch.device("meta"):
        spec = task.REFERENCE(cfg).nets
    weights = data.make_weights(spec, seed, dev)
    store = feeder.make_store(traffic, cfg, seed, dev)
    batches, noises = harness.reference_inputs(task, feeder, cfg, traffic, store, seed, dev)
    control = harness.reference_record(task, cfg, weights, batches, noises, dev, ref.Precision(fp8=True))
    want = harness.reference_record(task, cfg, weights, batches, noises, dev)
    return survey(control, want)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--fault", nargs=2, metavar=("KIND", "N"), default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)  # set on the ranks a launch starts
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from portbench import check, harness

    chips = int(harness.load("cells", args.workload)["chips"])
    if chips > 1 and args.t0 is None:  # one process a chip, each running every seed
        from portbench import run

        last = run.launch(sys.argv[1:], chips, timeout=3300.0, script=__file__)
        return 0 if last is not None else 1
    lead = int(os.environ.get("RANK", "0")) == 0
    if chips > 1:
        from cips_tpu_torch.parallel.mesh import initialize_distributed

        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        initialize_distributed("cuda")  # one group for every seed's run

    out = open(args.out, "a", encoding="utf-8") if args.out and lead else None
    quiet = lambda line: None  # noqa: E731

    def emit(kind, seed, values, seconds):
        if not lead:
            return
        line = json.dumps({"cell": args.workload, "kind": kind, "seed": seed, "readings": values, "s": seconds},
                          default=str)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def clear():
        gc.collect()
        torch.cuda.empty_cache()

    runs = [("program", s, None) for s in args.seeds]
    runs += [("control", s, None) for s in args.seeds[:args.control]]
    if args.fault:
        runs += [(args.fault[0], s, args.fault[0]) for s in args.seeds[:int(args.fault[1])]]
    for kind, seed, fault in runs:
        t = time.perf_counter()
        if kind == "control":
            if not lead:
                continue
            values = control_readings(args.workload, seed)
        else:
            records: dict = {}
            result = harness.run(args.workload, seed, 0.0, False, "cuda", fault=fault, log=quiet, keep=records)
            values = survey(records["prog"], records["want"]) if lead else None
            if lead:
                values["replicas"] = check.replicas(records["ranks"])
                values["compared"] = {k: v["value"] for k, v in result["check"].items()}
        emit(kind, seed, values, time.perf_counter() - t)
        clear()
    if out:
        out.close()
    print(json.dumps({"done": len(runs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
