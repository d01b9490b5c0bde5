"""The port's benchmark: one run of one cell.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``check``, each compared number beside its limit; the
same numbers end standard error. Exits non-zero, printing no result, without
a CUDA card for each chip the cell takes, when the program is absent, or when
JAX or the JAX package got loaded. Cells, configurations, traffic, model
families and per-layer metrics are found by name under this folder
(`portbench/harness.py`).
"""

import time

T0 = time.time()  # the process's start, from which set-up is counted

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cips_tpu")
CACHE = os.path.join(ROOT, "build", "portbench")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX's or the JAX package's (whole names)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch(argv: list, chips: int, timeout: float = 330.0, script: str = __file__):
    """One process of ``script`` a chip, torchrun's environment set by hand
    (rendezvous on a free localhost port), after the kernel library is built
    here once; rank 0's last line of output as JSON, or None when a rank failed."""
    import subprocess

    from cips_tpu_torch.ops import cuda_library

    cuda_library.build()
    port = free_port()
    procs = []
    for rank in range(chips):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(chips), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(chips))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(script), *argv, "--t0", repr(T0)], env=env,
                                      stdout=subprocess.PIPE if rank == 0 else subprocess.DEVNULL, text=True))
    try:
        out, _ = procs[0].communicate(timeout=timeout)
        codes = [procs[0].returncode] + [p.wait(timeout=timeout) for p in procs[1:]]
    except subprocess.TimeoutExpired:
        print("portbench: a rank did not finish in time", file=sys.stderr)
        codes, out = [None], ""
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(code != 0 for code in codes) or not out.strip():
        print(f"portbench: the ranks exited with {codes}", file=sys.stderr)
        return None
    return json.loads(out.strip().splitlines()[-1])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)  # a rank's launcher's start
    args = p.parse_args(argv)
    # kernel caches at fixed places inside the checkout, so that only a checkout's first run builds
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)

    import torch

    from portbench import harness

    chips = int(harness.load("cells", args.workload)["chips"])
    err = lambda line: print(line, file=sys.stderr, flush=True)  # noqa: E731
    rank = int(os.environ.get("RANK", "0"))
    if args.t0 is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            err(f"portbench: {args.workload} needs {chips} CUDA card(s); "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
            return 2
        if chips > 1:
            result = launch(argv, chips)
        else:
            result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t0=T0, log=err)
        if result is None:
            return 1
    else:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t0=args.t0,
                             log=err if rank == 0 else (lambda line: None))
    leaked = loaded_forbidden()
    if leaked:
        err(f"portbench: the run loaded {', '.join(leaked)}")
        return 3
    if args.t0 is not None and rank != 0:
        return 0
    if args.t0 is None and chips > 1:
        for k, v in result["check"].items():
            err(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
