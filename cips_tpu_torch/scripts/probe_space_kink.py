"""The depth-sharded fp32 step at full width against one process, part by
part, and the kink that keeps the whole step from agreeing at 1e-4.

    python -m cips_tpu_torch.scripts.probe_space_kink [--task flagship|causal] [--device cpu]
        [--crop D H W] [--check]

From `parallel.dryrun`'s seeded weights (`randomize_`) and first batch, fp32, no
TF32 and no cuDNN, at the bundled config of the task (the flagship's, or the
causal trio's) and (32, 64, 32) by default, 2 spawned ranks at data 1 x space 2:

  1. the first train step against one process: each network's gradients (the
     worst tensor over its max|grad|, tensors under 1e-3 of the network's
     largest left out as `dryrun.compare_grads` does; and the whole network's
     relative 2-norm), the losses, the replicas' largest difference and the bytes
     exchanged over the space group by kind;
  2. the parts alone, sharded against whole: G with a seeded linear loss on its
     outputs (the causal trio's T1 reconstruction and PET synthesis, from fixed
     noise), D with its logits' mean square on a fixed input, and G's
     adversarial term (G, then the frozen D on the synthesis);
  3. in one process, how far G's adversarial gradient moves when G's synthesis
     is multiplied by 1 + eps N(0, 1), eps 1e-7, 1e-6 and 1e-5.

A LeakyReLU of D whose input lies within rounding of 0 takes the other slope in
another summation order, and the gradients through D jump: at the default crop
and seeds G's adversarial gradient moves by about 1e-2 of a tensor's max|grad|
between eps 1e-6 and 1e-5 (PERF.md). So the whole step is held to one
process in its losses and replicas, and each network's own sharded arithmetic
(part 2, G and D alone) to 1e-4 of each tensor's max|grad| (`dryrun.TOL_GRADS`);
``--check`` asserts those, and rank 0 prints the results as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from cips_tpu_torch.losses import patch_adversarial_loss
from cips_tpu_torch.parallel import dryrun, spatial
from cips_tpu_torch.training import causal_task, unet_synthesis
from cips_tpu_torch.training.common import frozen

TOL_METRICS = 1e-5  # the step's losses: forward values, summed in other orders


def _fp32_exact() -> None:
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.enabled = False


def _models(device, task: str):
    """(G, D) with the dry run's weights: the flagship's AttenUNet, or the causal trio as one module."""
    cfg = dryrun._config(task, True)
    if task == "causal":
        *trio, d, _ = causal_task.build_models(cfg, dryrun.N_COVARIATES, dtype=torch.float32, device=device, seed=0)
        dryrun.randomize_((*trio, d), seed=1)
        return causal_task.CausalGenerator(dict(zip(causal_task.GENERATOR_PARTS, trio))), d
    g, d, _ = unet_synthesis.build_models(cfg, dryrun.N_COVARIATES, dtype=torch.float32, device=device, seed=0)
    dryrun.randomize_((g, d), seed=1)
    return g, d


def _noise(g, crop, device):
    """The causal trio's fixed (eps_t1, eps_pet) for its global latent; None for the flagship."""
    if not isinstance(g, causal_task.CausalGenerator):
        return None
    latent = [g["encoder"].output_depth(c) for c in crop]
    draw = torch.Generator().manual_seed(6)
    return [torch.randn((1, *latent, g["encoder"].conv_out.conv.out_channels // 2), generator=draw).to(device)
            for _ in range(2)]


def distance(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> Dict[str, Tuple[float, str, float]]:
    """{network: (worst tensor's largest difference over its max|grad|, that tensor,
    the network's relative 2-norm)} for keys "{network}.{parameter}"."""
    out = {}
    for net in sorted({k.split(".", 1)[0] for k in want}):
        keys = [k for k in want if k.startswith(net)]
        largest = max(want[k].abs().max().item() for k in keys)
        worst = max(((got[k] - want[k]).abs().max().item() / want[k].abs().max().item(), k) for k in keys
                    if want[k].abs().max().item() >= dryrun.NOISE_TENSOR * largest)
        norm = (sum(((got[k] - want[k]).double() ** 2).sum().item() for k in keys)
                / sum((want[k].double() ** 2).sum().item() for k in keys)) ** 0.5
        out[net] = (worst[0], worst[1], norm)
    return out


def _part_grads(module, x, loss_fn, space):
    """``module``'s parameter gradients of ``loss_fn(module(x), space)``, on depth
    slabs over ``space`` (the ranks' gradients summed, over the group's size:
    each rank's loss is the whole volume's) or whole."""
    module.zero_grad(set_to_none=True)
    if space is not None:
        x = x[:, slice(*spatial.slab(x.shape[1], space.index, space.size))].contiguous()
    with spatial.sharded([module], space):
        loss_fn(module(x), space).backward()
    grads = {f"net.{k}": p.grad.clone() for k, p in module.named_parameters() if p.grad is not None}
    if space is not None:
        for v in grads.values():
            dist.all_reduce(v, group=space.group)
            v /= space.size
    return grads


class _Generator(torch.nn.Module):
    """G's outputs from t1: the flagship's synthesis, or the causal trio's T1
    reconstruction and PET synthesis from the fixed noise ``eps``, this rank's slab
    of it over a space group."""

    def __init__(self, g, info, eps=None):
        super().__init__()
        self.g, self.info, self.eps = g, info, eps

    def forward(self, t1):
        if self.eps is None:
            return (self.g(t1, self.info),)
        draws = iter(self.eps)

        def noise(z, depth):
            eps, space = next(draws), self.g.space
            return eps if space is None else eps[:, slice(*spatial.slab(depth, space.index, space.size))]

        _, _, t1_rec, rec_pet, _ = self.g(t1, self.info, noise)
        return t1_rec, rec_pet


class _Adversarial(_Generator):
    """G, then the frozen D on its synthesis: the train step's adversarial term."""

    def __init__(self, g, d, info, eps=None):
        super().__init__(g, info, eps)
        self.d = d

    def forward(self, t1):
        with frozen(self.d):
            return self.d(super().forward(t1)[-1])


def _rank(mesh, crop, task: str) -> Dict:
    _fp32_exact()
    cfg = dryrun._config(task, True)
    run = dryrun.run_steps(mesh, task, cfg, crop, torch.float32, 1, mesh.data_count, mesh.device)
    payload = {"task": task, "crop": list(crop), "device": str(mesh.device), "space_bytes": run["space_bytes"][0],
               "max_rank_diff": dryrun.max_rank_difference(mesh, run["params"][0])}
    if mesh.is_lead:
        one = dryrun.run_steps(None, task, cfg, crop, torch.float32, 1, mesh.data_count, mesh.device)
        payload["step"] = distance(run["grads"][0], one["grads"][0])
        payload["metrics_rel"] = max(abs(v - one["metrics"][0][k]) / max(abs(one["metrics"][0][k]), 1e-30)
                                     for k, v in run["metrics"][0].items())
    g, d = _models(mesh.device, task)
    eps = _noise(g, crop, mesh.device)
    batch = {k: v.to(mesh.device) for k, v in dryrun.global_batch(1, crop, seed=100).items()}
    draw = torch.Generator().manual_seed(7)
    gouts = [torch.randn((1, *crop, 1), generator=draw).to(mesh.device) for _ in range(2)]

    def g_loss(outs, space):
        if space is None:
            return sum((out * gout).sum() for out, gout in zip(outs, gouts))
        planes = slice(*spatial.slab(crop[0], space.index, space.size))
        part = sum((out * gout[:, planes]).sum() for out, gout in zip(outs, gouts))
        return spatial.space_sum(part.reshape(1), space, "mean")[0]

    def d_loss(logits, space):
        return patch_adversarial_loss(logits[-1], target_is_real=True, for_discriminator=False, space=space)

    parts = (("G alone", _Generator(g, batch["info"], eps), batch["t1"], g_loss),
             ("D alone", d, torch.cat([batch["t1"], batch["pet"]]), d_loss),
             ("G's adversarial term", _Adversarial(g, d, batch["info"], eps), batch["t1"], d_loss))
    payload["parts"] = {}
    for label, module, x, loss_fn in parts:
        want = _part_grads(module, x, loss_fn, None)
        payload["parts"][label] = distance(_part_grads(module, x, loss_fn, mesh.space), want)["net"]
    return payload if mesh.is_lead else {}


def jumps(device: torch.device, crop, task: str) -> Dict[str, Dict]:
    """G's adversarial gradient in one process with G's synthesis moved by a relative eps N(0, 1)."""
    _fp32_exact()
    g, d = _models(device, task)
    batch = {k: v.to(device) for k, v in dryrun.global_batch(1, crop, seed=100).items()}
    generator = _Generator(g, batch["info"], _noise(g, crop, device))

    def grads(eps: float) -> Dict[str, torch.Tensor]:
        g.zero_grad(set_to_none=True)
        with frozen(d):
            fake = generator(batch["t1"])[-1]
            if eps:
                fake = fake * (1 + eps * torch.randn(fake.shape, generator=torch.Generator().manual_seed(5)).to(device))
            patch_adversarial_loss(d(fake)[-1], target_is_real=True, for_discriminator=False).backward()
        return {f"generator.{k}": p.grad.clone() for k, p in g.named_parameters() if p.grad is not None}

    ref = grads(0.0)
    return {f"{eps:g}": distance(grads(eps), ref)["generator"] for eps in (1e-7, 1e-6, 1e-5)}


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--task", default="flagship", choices=["flagship", "causal"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--crop", type=int, nargs=3, default=[32, 64, 32])
    p.add_argument("--check", action="store_true", help="assert the parts, the losses and the replicas")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    crop = tuple(args.crop)
    payload = dryrun.start(_rank, 2, crop, args.task, device=args.device, n_space=2).join()[0]
    payload["jumps"] = jumps(torch.device(args.device), crop, args.task)
    if args.device == "cuda":
        payload["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(payload))
    if args.check:
        parts = {k: payload["parts"][k] for k in ("G alone", "D alone")}
        assert all(v[0] <= dryrun.TOL_GRADS for v in parts.values()), f"sharded G or D apart from whole: {parts}"
        assert payload["metrics_rel"] <= TOL_METRICS, f"the step's losses part by {payload['metrics_rel']}"
        assert payload["max_rank_diff"] == 0.0, f"replicas differ by {payload['max_rank_diff']}"
    return payload


if __name__ == "__main__":
    main(sys.argv[1:])
