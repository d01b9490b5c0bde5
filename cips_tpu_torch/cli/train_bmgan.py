"""Train the BMGAN baseline (port of cips_tpu/cli/train_bmgan.py).

The JAX CLI's flags and layout ({exp_dir}/{log,ckpt,visual}); no covariates.
The batches come from the packed float16 store unless --streaming
(`common.make_loaders`); an eval of the L1 of a generation every --eval_every
epochs ranks the checkpoints saved every --save_every epochs; --resume
restores G, E, D, the perceptual net, the three optimisers and the step, and
begins at the epoch after the last one saved. --perceptual_weights loads
converted LPIPS (alex) weights, the JAX package's .npz. The latents come from
one generator on the device, seeded with --seed + 1. Runs on the card unless
``--device cpu``.

Data-parallel across cards under torchrun, as train_unet: ``--batch_size`` is a
node's batch, split over its ranks; G, E and D train under DDP and each step's
latent is drawn for the global batch and cut to the rank's rows. The eval runs
on every rank (its latents come from the same generator); only rank 0 logs
and writes checkpoints.

  python -m cips_tpu_torch.cli.train_bmgan --exp_dir /tmp/bmgan \\
      --training_info_csv train.csv --eval_info_csv test.csv --PET_dir ... --T1_dir ...
  python -m torch.distributed.run --nproc_per_node 8 -m cips_tpu_torch.cli.train_bmgan ...
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from cips_tpu_torch.cli import common
from cips_tpu_torch.models.perceptual import params_from_npz
from cips_tpu_torch.parallel.mesh import device_prefetch, make_mesh, replicate
from cips_tpu_torch.training import bmgan_task
from cips_tpu_torch.training.common import CheckpointManager, MetricWriter, mean_over_ranks

MODELS = {"generator": "g", "encoder": "e", "discriminator": "d", "perceptual": "perceptual"}


def _to_device(batch, device: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _checkpoint(state: bmgan_task.BMGANState, epoch: int) -> dict:
    payload = {name: getattr(state, attr).state_dict() for name, attr in MODELS.items()
               if getattr(state, attr) is not None}
    return {**payload, **{f"optimizer_{k}": getattr(state, f"opt_{k}").state_dict() for k in "ged"},
            "step": state.step, "epoch": epoch}


def main(argv=None) -> bmgan_task.BMGANState:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_data_args(p)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--save_every", type=int, default=10)
    p.add_argument("--eval_every", type=int, default=1)
    p.add_argument("--lamda_l1", type=float, default=20.0)
    p.add_argument("--lamda_perceptual", type=float, default=8.0)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    p.add_argument("--max_steps", type=int, default=0, help="debug: stop after N steps")
    p.add_argument("--exact_d_fake", action="store_true",
                   help="E and D train on the POST-update generator's fake (the reference's semantics; "
                        "+1 G forward per step)")
    p.add_argument("--perceptual_weights", default=None, help=".npz of converted pretrained LPIPS (alex) weights")
    args = p.parse_args(argv)

    mesh = make_mesh(args.device)
    device = mesh.device
    for d in ("log", "ckpt", "visual"):
        os.makedirs(os.path.join(args.exp_dir, d), exist_ok=True)
    models = bmgan_task.build_models(dtype=common.dtype_arg(args.dtype), input_shape=args.crop_size, device=device,
                                     seed=args.seed)
    state = bmgan_task.init_state(*models, lr=args.lr, perceptual_weight=args.lamda_perceptual, mesh=mesh)
    if args.perceptual_weights and state.perceptual is not None:
        state.perceptual.load_state_dict(params_from_npz(args.perceptual_weights))
    ckpt = CheckpointManager(os.path.join(args.exp_dir, "ckpt"))
    begin_epoch = 0
    if args.resume and ckpt.latest_epoch() is not None:
        payload = ckpt.restore()
        for name, attr in MODELS.items():
            if getattr(state, attr) is not None:
                getattr(state, attr).load_state_dict(payload[name])
        for k in "ged":
            getattr(state, f"opt_{k}").load_state_dict(payload[f"optimizer_{k}"])
        state.step = payload["step"]
        begin_epoch = ckpt.latest_epoch() + 1
        for k in "ged":
            replicate(mesh, getattr(state, f"opt_{k}"))
    if state.perceptual is not None:
        replicate(mesh, state.perceptual)

    train_loader, eval_loader = common.make_loaders(args, need_values=[], mesh=mesh, split_eval=False)
    writer = MetricWriter(os.path.join(args.exp_dir, "log"), enabled=mesh.is_lead)
    step_fn = bmgan_task.make_train_step(args.lamda_l1, args.lamda_perceptual, exact_d_fake=args.exact_d_fake,
                                         mesh=mesh, batch_size=args.batch_size)
    eval_fn = bmgan_task.make_eval_step()
    rng = torch.Generator(device).manual_seed(args.seed + 1)

    global_step = 0
    try:
        for epoch in range(begin_epoch, args.epochs):
            eval_l1 = None  # only a metric computed this epoch may rank the best checkpoint
            for batch in device_prefetch(train_loader.epoch(epoch), mesh):
                metrics = step_fn(state, batch, rng)
                global_step += 1
                if global_step % 20 == 0:
                    m = mean_over_ranks(metrics, mesh)
                    writer.scalars("training", m, global_step)
                    if mesh.is_lead:
                        print(f"epoch {epoch} step {global_step} l1 {m['l1_loss']:.5f} g {m['g_loss']:.5f} "
                              f"e {m['e_loss']:.5f} d {m['d_loss']:.5f}")
                if args.max_steps and global_step >= args.max_steps:
                    break
            if epoch % args.eval_every == 0:
                l1s = [float(eval_fn(state, _to_device(batch, device), rng)["l1_loss"])
                       for batch in eval_loader.epoch(0)]
                eval_l1 = float(np.mean(l1s)) if l1s else float("nan")
                writer.scalars("eval", {"l1_loss": eval_l1}, global_step)
                if mesh.is_lead:
                    print(f"epoch {epoch} eval l1 {eval_l1:.5f}")
            if epoch % args.save_every == 0 and mesh.is_lead:
                ckpt.save(_checkpoint(state, epoch), epoch, eval_metric=eval_l1)
            if args.max_steps and global_step >= args.max_steps:
                break
    finally:
        writer.close()
        mesh.close()
    return state


if __name__ == "__main__":
    main()
