"""Synthesize PET for a test manifest + report MAE/MS-SSIM/PSNR (port of
cips_tpu/cli/output_predict.py).

Restores the generator checkpoint, runs inference per batch on the card (or
on the CPU with ``--device cpu``), masks each synthesized volume with the real
PET's brain mask, computes the metrics, writes ori/rec NIfTIs and prints
mean ± std. Run as ``python -m cips_tpu_torch.cli.output_predict``.
"""

from __future__ import annotations

import argparse
import os

from cips_tpu_torch import default_device
from cips_tpu_torch.cli import common
from cips_tpu_torch.data.dataset import PairedVolumeDataset
from cips_tpu_torch.inference.predict import predict_dataset
from cips_tpu_torch.training import unet_synthesis
from cips_tpu_torch.training.common import CheckpointManager


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    common.add_common_data_args(p)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--use_condition", action="store_true")
    p.add_argument("--epoch", type=int, default=None, help="checkpoint epoch (default: latest)")
    p.add_argument("--best", action="store_true", help="use best-eval checkpoint")
    p.add_argument("--output_dir", default=None)
    p.add_argument("--no_write", action="store_true")
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    args = p.parse_args(argv)

    device = default_device(args.device)
    cfg = common.load_config(args.config, "training.json")
    need_values = common.covariates_for(args.pet_kind, args.use_condition)
    dirs = common.experiment_dirs(args.exp_dir, args.use_condition, args.pet_kind)

    generator, _, _ = unet_synthesis.build_models(
        cfg, n_covariates=len(need_values), dtype=common.dtype_arg(args.dtype), device=device
    )
    payload = CheckpointManager(dirs["ckpt"]).restore(epoch=args.epoch, best=args.best)
    generator.load_state_dict(payload["unet"])

    dataset = PairedVolumeDataset(
        args.eval_info_csv,
        pet_dir=args.PET_dir,
        t1_dir=args.T1_dir,
        crop_size=tuple(args.crop_size),
        need_values=need_values,
        min_and_max=common.load_stats(args.min_and_max),
    )
    predict = unet_synthesis.make_predict_fn(generator, use_condition=args.use_condition)
    out_dir = None if args.no_write else (args.output_dir or os.path.join(dirs["base"], "predict"))
    results = predict_dataset(
        predict, dataset, device, output_dir=out_dir, batch_size=max(args.batch_size, 1)
    )
    print(results)
    return results


if __name__ == "__main__":
    main()
