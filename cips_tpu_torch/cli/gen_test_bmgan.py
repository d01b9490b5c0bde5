"""Generate synthetic PET with the trained BMGAN generator (port of
cips_tpu/cli/gen_test_bmgan.py).

Restores G from ``{exp_dir}/ckpt`` (--epoch, --best or the latest), draws a
latent z ~ N(0, 1) for each batch from a generator seeded with --seed (anew
for every batch, as the JAX CLI reuses one key), and writes each subject's
synthesized volume, unmasked, as ``{output_dir}/{Subject}/{PET_date}/rec.nii.gz``
(default ``{exp_dir}/generated``), scored against the real PET. Runs on the
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import torch

from cips_tpu_torch import default_device
from cips_tpu_torch.cli import common
from cips_tpu_torch.data.dataset import PairedVolumeDataset
from cips_tpu_torch.inference.predict import VolumeMetrics, predict_dataset
from cips_tpu_torch.training import bmgan_task
from cips_tpu_torch.training.common import CheckpointManager


def main(argv=None) -> VolumeMetrics:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_common_data_args(p)
    p.add_argument("--exp_dir", required=True, help="trained BMGAN experiment dir")
    p.add_argument("--epoch", type=int, default=None, help="checkpoint epoch (default: latest)")
    p.add_argument("--best", action="store_true", help="use the best-eval checkpoint")
    p.add_argument("--output_dir", default=None)
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    args = p.parse_args(argv)

    device = default_device(args.device)
    generator = bmgan_task.build_models(dtype=common.dtype_arg(args.dtype), input_shape=args.crop_size,
                                        device=device)[0]
    payload = CheckpointManager(os.path.join(args.exp_dir, "ckpt")).restore(epoch=args.epoch, best=args.best)
    generator.load_state_dict(payload["generator"])
    dataset = PairedVolumeDataset(args.eval_info_csv, pet_dir=args.PET_dir, t1_dir=args.T1_dir,
                                  crop_size=tuple(args.crop_size))
    generate = bmgan_task.make_generate_fn(generator)
    results = predict_dataset(
        lambda batch: generate(batch, torch.Generator(device).manual_seed(args.seed)), dataset, device,
        output_dir=args.output_dir or os.path.join(args.exp_dir, "generated"), mask_mode="none",
        batch_size=max(args.batch_size, 1), write_ori=False,
    )
    print(results)
    return results


if __name__ == "__main__":
    main()
