"""Precompute PET latents with a trained causal encoder (port of
cips_tpu/cli/gen_latents.py).

Encodes every PET volume of a manifest (--eval_info_csv, else
--training_info_csv) with the checkpoint's encoder and writes the whole
2z-channel latent map, channels-last float32, to
``{out_dir}/{Subject}/{PET_date}/latent.npy``: the input of the reference's
latent-paired dataset. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from cips_tpu_torch import default_device
from cips_tpu_torch.cli import common
from cips_tpu_torch.cli.gen_test_causal import add_checkpoint_args, restore_generator
from cips_tpu_torch.data.dataset import PairedVolumeDataset


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_common_data_args(p)
    add_checkpoint_args(p)
    p.add_argument("--out_dir", required=True)
    args = p.parse_args(argv)

    device = default_device(args.device)
    encoder = restore_generator(args, device, len(common.covariates_for(args.pet_kind, True))).gen["encoder"]
    ds = PairedVolumeDataset(
        args.eval_info_csv or args.training_info_csv, pet_dir=args.PET_dir, t1_dir=args.T1_dir,
        crop_size=tuple(args.crop_size), need_values=[],
    )
    for i in range(len(ds)):
        s = ds[i]
        with torch.inference_mode():
            latent = encoder(torch.from_numpy(s.pet[None, ..., None]).to(device))
        out = os.path.join(args.out_dir, s.subject, s.pet_date)
        os.makedirs(out, exist_ok=True)
        np.save(os.path.join(out, "latent.npy"), latent[0].float().cpu().numpy())
    print(f"wrote {len(ds)} latents -> {args.out_dir}")
    return len(ds)


if __name__ == "__main__":
    main()
