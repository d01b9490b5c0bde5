"""Folder-pair metric tool CLI (port of cips_tpu/cli/metrics.py, the reference's
unet/scripts/metrics.py). Runs on the card unless ``--device cpu``.

One-tree mode (the tree `cli.output_predict` writes):
  python -m cips_tpu_torch.cli.metrics --root /path/to/predict
Two-tree mode (the reference's signature: separate synthesized and real trees,
the first file of each session dir, metrics.py:11,24-46):
  python -m cips_tpu_torch.cli.metrics --root SYS_TREE --real_root REAL_TREE

Mean-intensity matching (``sys / mean(sys) * mean(real)``, metrics.py:51-52) is
on by default, as the reference's ``set_mean=True``; --no_intensity_match turns it off.
"""

from __future__ import annotations

import argparse
import json

from cips_tpu_torch.cli.common import add_device_arg
from cips_tpu_torch.eval.pair_metrics import METRIC_SHAPE, folder_pair_metrics


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True,
                   help="tree of {subject}/{date}/ with both volumes, or the synthesized tree with --real_root")
    p.add_argument("--real_root", default=None, help="separate real-volume tree (the reference's two-folder mode)")
    p.add_argument("--real_name", default="ori.nii.gz")
    p.add_argument("--rec_name", default="rec.nii.gz")
    p.add_argument("--no_intensity_match", action="store_true", help="no sys->real mean matching (set_mean=False)")
    p.add_argument("--metric_shape", type=int, nargs=3, default=list(METRIC_SHAPE))
    add_device_arg(p)
    args = p.parse_args(argv)
    out = folder_pair_metrics(
        args.root,
        real_name=args.real_name,
        rec_name=args.rec_name,
        real_root=args.real_root,
        metric_shape=tuple(args.metric_shape),
        intensity_match=not args.no_intensity_match,
        device=args.device,
    )
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
