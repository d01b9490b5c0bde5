"""Train the conditional AttenUNet T1->PET synthesizer (port of cips_tpu/cli/train_unet.py).

The JAX CLI's experiment semantics: the covariate set by --pet_kind, the
{exp_dir}/(un)conditional/{pet_kind} layout, a per-epoch eval with sample
NIfTI dumps (visual/epoch{e}_{rec,ori,t1}.nii.gz), checkpoints every
--save_every epochs ranked by the eval loss, and --resume, which restores G,
D, both optimisers, the step count and the perceptual network (when its weight
is above 0; --perceptual_weights loads the JAX package's LPIPS .npz) and
begins at the epoch after the last one saved. The batches come from the packed float16 store unless
``--streaming`` (`common.make_loaders`). Runs on the card unless ``--device cpu``.

Data-parallel across cards: one process a card under torchrun, which trains
what the JAX CLI trains with that many local devices (`parallel.mesh`).
``--batch_size`` is the batch of one node, split over its ranks; G and D train
under DDP; the eval subjects are dealt out over the ranks and their mean taken
over all; only rank 0 logs, dumps and writes checkpoints, which hold the plain
networks' names, so that a run resumes at any number of ranks.

``--n_space S`` shards each volume's depth over S ranks as well (the mesh's
``space`` axis, `parallel.spatial`): the world is a (data, space) grid of
WORLD_SIZE / S data groups of S ranks, a data group takes the rows a rank took,
and each of its ranks a depth slab of them; every rank's gradient is the
one-process gradient of the global batch. Any depth the unsharded model takes
will do, as in JAX: the slabs of a deeper level may be uneven, and a crop depth
that S does not divide reaches the ranks whole and trains unsharded on each of
them. Eval takes whole volumes, its subjects dealt out over
all ranks as without it. A world whose rank count S does not divide is a
ValueError.

  python -m cips_tpu_torch.cli.train_unet --exp_dir /tmp/exp \\
      --training_info_csv train.csv --eval_info_csv test.csv \\
      --PET_dir ... --T1_dir ... --pet_kind AV45 --use_condition
  python -m torch.distributed.run --nproc_per_node 8 -m cips_tpu_torch.cli.train_unet ...
  python -m torch.distributed.run --nproc_per_node 4 -m cips_tpu_torch.cli.train_unet ... --n_space 2
"""

from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch

from cips_tpu_torch.cli import common
from cips_tpu_torch.data import nifti
from cips_tpu_torch.models.perceptual import params_from_npz
from cips_tpu_torch.parallel.mesh import device_prefetch, make_mesh, replicate
from cips_tpu_torch.training import profiling, unet_synthesis
from cips_tpu_torch.training.common import CheckpointManager, MetricWriter, StepTimer, global_mean, mean_over_ranks


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_data_args(p)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--config", help="model/training config JSON (default: bundled training.json)")
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--save_every", type=int, default=10)
    p.add_argument("--eval_every", type=int, default=1)
    p.add_argument("--use_condition", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    p.add_argument("--n_space", type=int, default=1,
                   help="ranks that shard each volume's depth (the mesh's space axis); divides the rank count")
    p.add_argument("--max_steps", type=int, default=0, help="debug: stop after N steps")
    p.add_argument("--profile_dir", default=None, help="write a torch.profiler trace of steps 10-15 there")
    p.add_argument("--perceptual_weights", default=None,
                   help=".npz of converted pretrained LPIPS weights (used when perceptual_weight > 0)")
    p.add_argument("--nan_guard", action="store_true",
                   help="skip both optimiser steps on a non-finite G loss (failure detection)")
    p.add_argument("--exact_d_fake", action="store_true",
                   help="D trains on the POST-update generator's fake (the reference's semantics; "
                        "+1 G forward per step)")
    return p


def _to_device(batch, device: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _checkpoint(state: unet_synthesis.GANState, epoch: int) -> dict:
    payload = {"unet": state.g.state_dict(), "discriminator": state.d.state_dict(),
               "optimizer_g": state.opt_g.state_dict(), "optimizer_d": state.opt_d.state_dict(),
               "step": state.step, "epoch": epoch}
    if state.perceptual is not None:
        payload["perceptual"] = state.perceptual.state_dict()
    return payload


def main(argv=None) -> unet_synthesis.GANState:
    args = build_argparser().parse_args(argv)
    cfg = common.load_config(args.config, "training.json")
    # the volumes' depth: one that n_space does not divide reaches the ranks whole (JAX's rule for a leaf
    # its axis does not split), and the train step runs it unsharded
    depth = (args.random_crop_size or args.crop_size)[0]
    mesh = make_mesh(args.device, n_space=args.n_space)
    device = mesh.device
    train_cfg = cfg["training"]
    need_values = common.covariates_for(args.pet_kind, args.use_condition)
    dirs = common.experiment_dirs(args.exp_dir, args.use_condition, args.pet_kind)

    generator, discriminator, perceptual = unet_synthesis.build_models(
        cfg, n_covariates=len(need_values), dtype=common.dtype_arg(args.dtype), device=device, seed=args.seed
    )
    state = unet_synthesis.init_state(generator, discriminator, train_cfg, perceptual, mesh=mesh)
    if args.perceptual_weights and state.perceptual is not None:
        state.perceptual.load_state_dict(params_from_npz(args.perceptual_weights))
    ckpt = CheckpointManager(dirs["ckpt"])
    begin_epoch = 0
    if args.resume and ckpt.latest_epoch() is not None:
        payload = ckpt.restore()
        state.g.load_state_dict(payload["unet"])
        state.d.load_state_dict(payload["discriminator"])
        state.opt_g.load_state_dict(payload["optimizer_g"])
        state.opt_d.load_state_dict(payload["optimizer_d"])
        if state.perceptual is not None:
            state.perceptual.load_state_dict(payload["perceptual"])
        state.step = payload["step"]
        begin_epoch = ckpt.latest_epoch() + 1
        for opt in (state.opt_g, state.opt_d):
            replicate(mesh, opt)
    if state.perceptual is not None:
        replicate(mesh, state.perceptual)

    train_loader, eval_loader = common.make_loaders(args, need_values, mesh)
    writer = MetricWriter(dirs["log"], enabled=mesh.is_lead)
    timer = StepTimer()
    step_fn = unet_synthesis.make_train_step(
        train_cfg, use_condition=args.use_condition, exact_d_fake=(True if args.exact_d_fake else None),
        nan_guard=args.nan_guard, mesh=mesh, volume_depth=depth,
    )
    eval_fn = unet_synthesis.make_eval_step(train_cfg, use_condition=args.use_condition)

    global_step = 0
    tracing = contextlib.ExitStack()
    try:
        for epoch in range(begin_epoch, args.epochs):
            for batch in device_prefetch(train_loader.epoch(epoch), mesh, spatial_axis=1):
                if args.profile_dir and mesh.is_lead and global_step == 10:
                    tracing.enter_context(profiling.trace(args.profile_dir))
                metrics = step_fn(state, batch)
                if global_step == 15:
                    tracing.close()
                global_step += 1
                if global_step % 10 == 0:
                    m = mean_over_ranks(metrics, mesh)
                    writer.scalars("training", m, global_step)
                    if mesh.is_lead:
                        print(
                            f"epoch {epoch}/{args.epochs} step {global_step} "
                            f"rec {m['rec_loss']:.5f} adv {m['adv_loss']:.5f} "
                            f"g {m['g_loss']:.5f} d {m['d_loss']:.5f} "
                            f"({timer.lap():.3f}s/10steps)"
                        )
                if args.max_steps and global_step >= args.max_steps:
                    break

            eval_loss = None  # only a metric computed this epoch may rank the best checkpoint
            if epoch % args.eval_every == 0:
                eval_losses = []  # this rank's share of the eval subjects (rank 0's first is subject 0)
                for i, batch in enumerate(eval_loader.epoch(0)):
                    out = eval_fn(state, _to_device(batch, device))
                    eval_losses.append(float(out["g_loss"]))
                    if i == 0 and mesh.is_lead:  # sample NIfTI dump for visual inspection
                        for name, vol in (("rec", out["fake"][0, ..., 0].float().cpu().numpy()),
                                          ("ori", batch["pet"][0, ..., 0]), ("t1", batch["t1"][0, ..., 0])):
                            nifti.write(os.path.join(dirs["visual"], f"epoch{epoch}_{name}.nii.gz"),
                                        np.asarray(vol, np.float32))
                eval_loss = global_mean(eval_losses, mesh)
                writer.scalars("eval", {"g_loss": eval_loss}, global_step)
                if mesh.is_lead:
                    print(f"epoch {epoch} eval g_loss {eval_loss:.5f}")

            if epoch % args.save_every == 0 and mesh.is_lead:
                ckpt.save(_checkpoint(state, epoch), epoch, eval_metric=eval_loss)
            if args.max_steps and global_step >= args.max_steps:
                break
    finally:
        tracing.close()
        writer.close()
        mesh.close()
    return state


if __name__ == "__main__":
    main()
