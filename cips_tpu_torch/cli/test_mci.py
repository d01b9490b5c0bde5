"""Test the MCI-converter classifier (port of cips_tpu/cli/test_mci.py).

Restores a trained classifier from ``{exp_dir}/ckpt`` (the run directory that
train_classifier wrote: --epoch, --best or the latest) and classifies the
eval manifest's sessions one at a time, on real PET or, with --test_fake_pet
and --fake_pet_dir, on synthesized PET (``rec.nii.gz``): the end-to-end
synthesize-then-classify evaluation. Prints the metrics and the compact row
and writes ``{exp_dir}/confusion_test.jpg`` (when matplotlib is there). Runs
on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

from cips_tpu_torch import default_device
from cips_tpu_torch.cli import common
from cips_tpu_torch.cli.train_classifier import (
    add_model_args,
    build_dataset,
    build_model,
    evaluate_logits,
    iter_batches,
    load_model_config,
)
from cips_tpu_torch.eval.classification import classification_metrics, metrics_row, save_confusion_matrix_figure
from cips_tpu_torch.training import classifier_task
from cips_tpu_torch.training.common import CheckpointManager


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_common_data_args(p)
    add_model_args(p)
    p.add_argument("--exp_dir", required=True, help="trained classifier run dir (holds ckpt/)")
    p.add_argument("--epoch", type=int, default=None, help="checkpoint epoch (default: latest)")
    p.add_argument("--best", action="store_true", help="use the best-eval checkpoint")
    args = p.parse_args(argv)

    device = default_device(args.device)
    need_values = common.covariates_for(args.pet_kind, args.use_tabular_info)
    model = build_model(args, load_model_config(args), len(need_values), device)
    payload = CheckpointManager(os.path.join(args.exp_dir, "ckpt")).restore(epoch=args.epoch, best=args.best)
    model.load_state_dict(payload["model"])
    predict = classifier_task.make_predict_fn(model, args.use_tabular_info)

    ds = build_dataset(args, need_values, train=False, fake_pet=args.test_fake_pet)
    print(f"{len(ds)} test sessions ({'synthesized' if args.test_fake_pet else 'real'} PET)")
    labels, logits = evaluate_logits(predict, iter_batches(ds, 1, False, 0, 0), device)
    m = classification_metrics(labels, logits)
    print({k: round(v, 4) for k, v in m.items()})
    print("f1 & auc & acc & prec & rec:", metrics_row(m))
    save_confusion_matrix_figure(labels, logits.argmax(-1), os.path.join(args.exp_dir, "confusion_test.jpg"))
    return m


if __name__ == "__main__":
    main()
