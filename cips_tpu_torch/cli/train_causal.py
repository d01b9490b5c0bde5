"""Train the causal unified generator (port of cips_tpu/cli/train_causal.py).

The JAX CLI's flags and experiment layout ({exp_dir}/conditional/{pet_kind},
the covariates of --pet_kind): the batches come from the packed float16 store
unless --streaming (`common.make_loaders`); an eval of the PET L1 every
--eval_every epochs ranks the checkpoints saved every --save_every epochs;
--resume restores the trio, D, the perceptual net, both optimisers and the
step, and begins at the epoch after the last one saved. --perceptual_weights
loads converted LPIPS weights (the JAX package's .npz). The noise comes from
one generator on the device, seeded with --seed + 1. Runs on the card unless
``--device cpu``.

Data-parallel across cards under torchrun, as train_unet: ``--batch_size`` is a
node's batch, split over its ranks; the trio and D train under DDP, and each
step's noise is drawn for the global batch and cut to the rank's rows, so that
every rank's generator stays where one process's would be. The eval runs on
every rank (its noise comes from the same generator); only rank 0 logs and
writes checkpoints.

  python -m cips_tpu_torch.cli.train_causal --exp_dir /tmp/causal \\
      --training_info_csv train.csv --eval_info_csv test.csv \\
      --PET_dir ... --T1_dir ... --min_and_max stats.json
  python -m torch.distributed.run --nproc_per_node 8 -m cips_tpu_torch.cli.train_causal ...
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cips_tpu_torch.cli import common
from cips_tpu_torch.models.perceptual import params_from_npz
from cips_tpu_torch.parallel.mesh import device_prefetch, make_mesh, replicate
from cips_tpu_torch.training import causal_task
from cips_tpu_torch.training.common import CheckpointManager, MetricWriter, mean_over_ranks


def _to_device(batch, device: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _models(state: causal_task.CausalState) -> dict:
    return {**dict(state.gen.items()), "discriminator": state.d, "perceptual": state.perceptual}


def _checkpoint(state: causal_task.CausalState, epoch: int) -> dict:
    return {**{k: m.state_dict() for k, m in _models(state).items() if m is not None},
            "optimizer_g": state.opt_g.state_dict(), "optimizer_d": state.opt_d.state_dict(),
            "step": state.step, "epoch": epoch}


def main(argv=None) -> causal_task.CausalState:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_data_args(p)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--config", default=None, help="model/training config JSON (default: bundled "
                                                  "training_causal.json)")
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--save_every", type=int, default=10)
    p.add_argument("--eval_every", type=int, default=1)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    p.add_argument("--max_steps", type=int, default=0, help="debug: stop after N steps")
    p.add_argument("--exact_d_fake", action="store_true",
                   help="D trains on a fresh fake from the POST-update generator (the reference's semantics; "
                        "+1 encoder and PET decoder forward per step)")
    p.add_argument("--perceptual_weights", default=None, help=".npz of converted pretrained LPIPS weights")
    args = p.parse_args(argv)

    mesh = make_mesh(args.device)
    device = mesh.device
    cfg = common.load_config(args.config, "training_causal.json")
    train_cfg = cfg["training"]
    need_values = common.covariates_for(args.pet_kind, use_condition=True)
    dirs = common.experiment_dirs(args.exp_dir, True, args.pet_kind)

    models = causal_task.build_models(cfg, n_covariates=len(need_values), dtype=common.dtype_arg(args.dtype),
                                      device=device, seed=args.seed)
    state = causal_task.init_state(*models, train_cfg, mesh=mesh)
    if args.perceptual_weights and state.perceptual is not None:
        state.perceptual.load_state_dict(params_from_npz(args.perceptual_weights))
    ckpt = CheckpointManager(dirs["ckpt"])
    begin_epoch = 0
    if args.resume and ckpt.latest_epoch() is not None:
        payload = ckpt.restore()
        for name, model in _models(state).items():
            if model is not None:
                model.load_state_dict(payload[name])
        state.opt_g.load_state_dict(payload["optimizer_g"])
        state.opt_d.load_state_dict(payload["optimizer_d"])
        state.step = payload["step"]
        begin_epoch = ckpt.latest_epoch() + 1
        for opt in (state.opt_g, state.opt_d):
            replicate(mesh, opt)
    if state.perceptual is not None:
        replicate(mesh, state.perceptual)

    train_loader, eval_loader = common.make_loaders(args, need_values, mesh, split_eval=False)
    writer = MetricWriter(dirs["log"], enabled=mesh.is_lead)
    step_fn = causal_task.make_train_step(train_cfg, exact_d_fake=(True if args.exact_d_fake else None), mesh=mesh,
                                          batch_size=args.batch_size)
    eval_fn = causal_task.make_eval_step()
    rng = torch.Generator(device).manual_seed(args.seed + 1)

    global_step = 0
    try:
        for epoch in range(begin_epoch, args.epochs):
            eval_loss = None  # only a metric computed this epoch may rank the best checkpoint
            for batch in device_prefetch(train_loader.epoch(epoch), mesh):
                metrics = step_fn(state, batch, rng)
                global_step += 1
                if global_step % 10 == 0:
                    m = mean_over_ranks(metrics, mesh)
                    writer.scalars("training", m, global_step)
                    if mesh.is_lead:
                        print(f"epoch {epoch} step {global_step} pet {m['rec_pet_loss']:.5f} "
                              f"t1 {m['rec_t1_loss']:.5f} kl {m['kl_loss']:.3f} d {m['d_loss']:.5f}")
                if args.max_steps and global_step >= args.max_steps:
                    break
            if epoch % args.eval_every == 0:
                losses = [float(eval_fn(state, _to_device(batch, device), rng)["rec_pet_loss"])
                          for batch in eval_loader.epoch(0)]
                eval_loss = float(np.mean(losses)) if losses else float("nan")
                writer.scalars("eval", {"rec_pet_loss": eval_loss}, global_step)
                if mesh.is_lead:
                    print(f"epoch {epoch} eval rec_pet {eval_loss:.5f}")
            if epoch % args.save_every == 0 and mesh.is_lead:
                ckpt.save(_checkpoint(state, epoch), epoch, eval_metric=eval_loss)
            if args.max_steps and global_step >= args.max_steps:
                break
    finally:
        writer.close()
        mesh.close()
    return state


if __name__ == "__main__":
    main()
