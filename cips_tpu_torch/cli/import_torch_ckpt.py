"""Convert a reference torch checkpoint into a checkpoint of the port (port of
cips_tpu/cli/import_torch_ckpt.py).

The reference trains with torch and saves ``{"unet": ddp_state_dict,
"discriminator": ..., "epoch": N, ...}`` (unet/scripts/train_unet.py:295-302).
This CLI loads those weights into the config's AttenUNet and PatchDiscriminator
(`data.torch_import`: DDP's ``module.`` stripped, every name and shape
checked; a discriminator that does not fit is skipped) and writes them, with
the file's epoch and ``eval_loss`` and fresh Adam states as `train_unet`
starts them, where ``cli.output_predict --epoch N`` and ``cli.train_unet
--resume`` look. Runs on the CPU: it moves no tensor to a card.

  python -m cips_tpu_torch.cli.import_torch_ckpt --torch_ckpt ref_epoch500.ckpt \\
      --exp_dir /tmp/exp --pet_kind AV45 --use_condition
"""

from __future__ import annotations

import argparse

import torch

from cips_tpu_torch.cli import common
from cips_tpu_torch.data import torch_import
from cips_tpu_torch.training import unet_synthesis
from cips_tpu_torch.training.common import CheckpointManager


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--torch_ckpt", required=True)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--pet_kind", default="AV45", choices=["AV45", "AV1451"])
    p.add_argument("--use_condition", action="store_true")
    p.add_argument("--crop_size", type=int, nargs=3, default=[96, 128, 96],
                   help="the volume the model is built for (the JAX CLI's flag; the port's models take any)")
    args = p.parse_args(argv)

    cfg = common.load_config(args.config, "training.json")
    need_values = common.covariates_for(args.pet_kind, args.use_condition)
    dirs = common.experiment_dirs(args.exp_dir, args.use_condition, args.pet_kind)
    generator, discriminator, perceptual = unet_synthesis.build_models(
        cfg, n_covariates=len(need_values), dtype=torch.float32, device="cpu")
    generator.check_shape(args.crop_size)
    try:
        imported = torch_import.import_checkpoint(args.torch_ckpt, generator, discriminator)
    except ValueError as err:
        raise SystemExit(f"{err}\nunet: imported parameter shapes do not match the config's model — wrong "
                         f"--config / --pet_kind / --use_condition?") from err
    if imported["discriminator"] is None:
        print("imported discriminator")
    else:
        print(f"skipping discriminator: {imported['discriminator']}")
    state = unet_synthesis.init_state(generator, discriminator, cfg["training"], perceptual)
    payload = {"unet": state.g.state_dict(), "discriminator": state.d.state_dict(),
               "optimizer_g": state.opt_g.state_dict(), "optimizer_d": state.opt_d.state_dict(),
               "step": state.step, "epoch": imported["epoch"]}
    if state.perceptual is not None:
        payload["perceptual"] = state.perceptual.state_dict()
    CheckpointManager(dirs["ckpt"]).save(payload, imported["epoch"], eval_metric=imported["eval_loss"])
    print(f"wrote epoch {imported['epoch']} checkpoint to {dirs['ckpt']}")
    return dirs["ckpt"]


if __name__ == "__main__":
    main()
