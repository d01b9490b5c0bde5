"""Generate synthetic PET with the trained causal generator (port of
cips_tpu/cli/gen_test_causal.py).

Restores the trio from the experiment's checkpoint, encodes each subject's T1,
samples the latent (the noise from a generator seeded with --seed, drawn anew
for every batch, as the JAX CLI reuses one key) and decodes PET conditioned on
the covariates. Each output is min-max renormalised and masked with its own
brain mask, scored against the real PET and written as
``{output_dir}/{Subject}/{PET_date}/rec.nii.gz``. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import torch

from cips_tpu_torch import default_device
from cips_tpu_torch.cli import common
from cips_tpu_torch.data.dataset import PairedVolumeDataset
from cips_tpu_torch.inference.predict import VolumeMetrics, predict_dataset
from cips_tpu_torch.training import causal_task
from cips_tpu_torch.training.common import CheckpointManager


def add_checkpoint_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--exp_dir", required=True, help="trained causal experiment dir")
    p.add_argument("--config", default=None)
    p.add_argument("--epoch", type=int, default=None, help="checkpoint epoch (default: latest)")
    p.add_argument("--best", action="store_true", help="use the best-eval checkpoint")
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])


def restore_generator(args, device: torch.device, n_covariates: int) -> causal_task.CausalState:
    """The causal state with the trio restored from the experiment's checkpoint
    (--epoch, --best or the latest), in --dtype on ``device``."""
    cfg = common.load_config(args.config, "training_causal.json")
    dirs = common.experiment_dirs(args.exp_dir, True, args.pet_kind)
    models = causal_task.build_models(cfg, n_covariates, dtype=common.dtype_arg(args.dtype), device=device)
    state = causal_task.init_state(*models, cfg["training"])
    payload = CheckpointManager(dirs["ckpt"]).restore(epoch=args.epoch, best=args.best)
    for name, model in state.gen.items():
        model.load_state_dict(payload[name])
    return state


def main(argv=None) -> VolumeMetrics:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_common_data_args(p)
    add_checkpoint_args(p)
    p.add_argument("--output_dir", default=None, help="default: {exp_dir}/conditional/{pet_kind}/generated")
    args = p.parse_args(argv)

    device = default_device(args.device)
    need_values = common.covariates_for(args.pet_kind, use_condition=True)
    state = restore_generator(args, device, len(need_values))
    dataset = PairedVolumeDataset(
        args.eval_info_csv, pet_dir=args.PET_dir, t1_dir=args.T1_dir, crop_size=tuple(args.crop_size),
        need_values=need_values, min_and_max=common.load_stats(args.min_and_max),
    )
    generate = causal_task.make_generate_fn(state.gen["encoder"], state.gen["pet_decoder"])
    out_dir = args.output_dir or os.path.join(common.experiment_dirs(args.exp_dir, True, args.pet_kind)["base"],
                                              "generated")
    results = predict_dataset(
        lambda batch: generate(batch, torch.Generator(device).manual_seed(args.seed)),
        dataset, device, output_dir=out_dir, mask_mode="self", batch_size=max(args.batch_size, 1),
        write_ori=False,
    )
    print(results)
    return results


if __name__ == "__main__":
    main()
