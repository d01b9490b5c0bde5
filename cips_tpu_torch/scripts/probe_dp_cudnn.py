"""Why the data-parallel dry run turns cuDNN off for its fp32 comparison.

    python -m cips_tpu_torch.scripts.probe_dp_cudnn [N]

One fp32 flagship step (the bundled config, full width, at the reduced crop
(32, 64, 32), weights from `dryrun.randomize_`, TF32 off) at N ranks (2 by
default, sharing the cards in turn) against one process on the same global
batch, and one process against itself, with cuDNN as it is, with cuDNN
deterministic, and with cuDNN off (PyTorch's own convolutions). For each it
prints the largest gradient differences, each over its tensor's max|grad|,
among the tensors whose max|grad| is at least 1e-3 of their network's largest.
Card only.
"""

from __future__ import annotations

import sys
import time

import torch

from cips_tpu_torch.parallel import dryrun

CROP = (32, 64, 32)
MODES = {"cudnn": {}, "cudnn deterministic": {"deterministic": True}, "no cudnn": {"enabled": False}}


def _setup(mode: str) -> None:
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled = False, True
    for key, value in MODES[mode].items():
        setattr(torch.backends.cudnn, key, value)


def _step(mesh, mode: str):
    _setup(mode)
    return dryrun.run_steps(mesh, "flagship", dryrun._config("flagship", True), CROP, torch.float32, 1,
                            mesh.world_size, mesh.device)["grads"][0]


def _worst(got: dict, want: dict, n: int = 4) -> list:
    net_max = dryrun._net_max(want)
    rows = []
    for k, g in want.items():
        scale = g.abs().max().item()
        if scale >= dryrun.NOISE_TENSOR * net_max[k.split(".", 1)[0]]:
            rows.append(((got[k] - g).abs().max().item() / scale, k))
    return [f"{rel:.3e} {name}" for rel, name in sorted(rows, reverse=True)[:n]]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 2
    if not torch.cuda.is_available():
        print("probe_dp_cudnn: needs a CUDA card", file=sys.stderr)
        return 1
    print(f"{torch.cuda.get_device_name(0)}; {n} ranks on {torch.cuda.device_count()} card(s); fp32 flagship at {CROP}")
    for mode in MODES:
        t0 = time.perf_counter()
        ranks = dryrun.start(_step, n, mode).join()
        _setup(mode)
        one = dryrun.run_steps(None, "flagship", dryrun._config("flagship", True), CROP, torch.float32, 1, n,
                               torch.device("cuda"))["grads"][0]
        again = dryrun.run_steps(None, "flagship", dryrun._config("flagship", True), CROP, torch.float32, 1, n,
                                 torch.device("cuda"))["grads"][0]
        print(f"{mode}: {n} ranks vs one process, worst first-step gradients: {_worst(ranks[0], one)}")
        print(f"{mode}: one process vs itself: {_worst(again, one)} ({time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
