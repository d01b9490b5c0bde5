"""Preprocessing CLI: pairing, covariates, stats, registration, masking, packing
(port of cips_tpu/cli/preprocess.py; the reference's preprocess/ scripts):

  pair        create_pair_csv.py (nearest-T1 pairing and subject split)
  audit       pair_PET_and_T1.py (PET sessions lacking a T1 within 180 days)
  merge-csf   merge_csf.py (covariate join by nearest exam date)
  stats       compute_max_and_min.py (min/max over the training manifest)
  reg         reg_to_T1.py reg_to_t1 (rigid PET->T1; on the card unless --device cpu)
  downsample  reg_to_T1.py create_T1_downsample (N4, mm resample, crop; on the card
              unless --device cpu)
  mask        masked_PET_by_T1.py (PET * (baseline T1 > 0))
  simple-csv  create_csv.py (Subject/date manifests and a subject split)
  pack        decode and preprocess the pairs once into the float16 packed store

All but reg and downsample run on the host.
"""

from __future__ import annotations

import argparse
import csv
import os
from collections import defaultdict

from cips_tpu_torch.cli.common import add_device_arg
from cips_tpu_torch.data import covariates as cov
from cips_tpu_torch.data import manifest as man
from cips_tpu_torch.data import preprocess as prep


def cmd_pair(args):
    rows = man.pair_sessions(man.scan_session_dirs(args.PET_dir), man.scan_session_dirs(args.T1_dir),
                             max_days=args.max_days)
    train, test = man.subject_split(rows, train_frac=args.train_frac, seed=args.split_seed)
    man.write_manifest(os.path.join(args.out_dir, "pair_all.csv"), rows)
    man.write_manifest(os.path.join(args.out_dir, "pair_training.csv"), train)
    man.write_manifest(os.path.join(args.out_dir, "pair_test.csv"), test)
    print(f"{len(rows)} pairs -> {len(train)} train / {len(test)} test")


def cmd_audit(args):
    missing = man.unpaired_pet_sessions(man.scan_session_dirs(args.PET_dir), man.scan_session_dirs(args.T1_dir),
                                        max_days=args.max_days)
    for subject, date in missing:
        print(f"missing T1 within {args.max_days}d: {subject} {date}")
    print(f"{len(missing)} unpaired PET sessions")


def _read_exam_records(path):
    records = defaultdict(list)
    with open(path, newline="", encoding="utf-8") as f:
        for rec in csv.DictReader(f):
            subject = rec.get("PTID") or rec.get("Subject") or rec.get("RID")
            if subject:
                records[subject].append(rec)
    return records


def cmd_merge_csf(args):
    rows = man.read_manifest(args.manifest)
    merged = cov.merge_covariates(rows, _read_exam_records(args.adnimerge_csv), cov.COVARIATES_BY_TRACER[args.pet_kind])
    man.write_manifest(args.out_csv, merged)
    print(f"{len(merged)}/{len(rows)} rows with complete covariates -> {args.out_csv}")


def cmd_stats(args):
    stats = cov.compute_min_and_max(man.read_manifest(args.manifest))
    cov.save_min_and_max(args.out_json, stats)
    print(stats)


def cmd_reg(args):
    n = prep.register_pet_to_t1(args.PET_dir, args.T1_dir, args.out_dir, metric=args.metric, device=args.device)
    print(f"registered {n} PET sessions")


def cmd_downsample(args):
    n = prep.create_t1_downsample(args.T1_dir, args.out_dir, new_spacing=tuple(args.spacing),
                                  crop_size=tuple(args.crop), template_path=args.template, device=args.device)
    print(f"downsampled {n} T1 sessions")


def cmd_mask(args):
    print(f"masked {prep.mask_pet_by_t1(args.PET_dir, args.T1_dir, args.out_dir)} PET sessions")


def cmd_simple_csv(args):
    """Subject/date manifests with a subject split (create_csv.py, without its
    bug of test rows that hold training rows, :35-48)."""
    rows = [man.PairRow(subject=s, t1_date=d, pet_date=d)
            for s, dates in man.scan_session_dirs(args.image_dir).items() for d in dates]
    train, test = man.subject_split(rows, train_frac=args.train_frac, seed=args.split_seed)
    cols = ["Subject", "T1_date", "PET_date"]
    man.write_manifest(os.path.join(args.out_dir, "sessions_all.csv"), rows, cols)
    man.write_manifest(os.path.join(args.out_dir, "sessions_training.csv"), train, cols)
    man.write_manifest(os.path.join(args.out_dir, "sessions_test.csv"), test, cols)
    print(f"{len(rows)} sessions -> {len(train)} train / {len(test)} test")


def cmd_pack(args):
    from cips_tpu_torch.data.dataset import PairedVolumeDataset, pack_pairs

    stats = cov.load_min_and_max(args.min_and_max) if args.min_and_max else {}
    keys = cov.COVARIATES_BY_TRACER[args.pet_kind] if args.with_covariates else []
    ds = PairedVolumeDataset(args.manifest, pet_dir=args.PET_dir, t1_dir=args.T1_dir, need_values=keys,
                             min_and_max=stats)
    pack_pairs(ds, args.out_dir)
    print(f"packed {len(ds)} pairs -> {args.out_dir}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def trees(sp, out=True):
        sp.add_argument("--PET_dir", required=True)
        sp.add_argument("--T1_dir", required=True)
        if out:
            sp.add_argument("--out_dir", required=True)

    def split(sp):
        sp.add_argument("--train_frac", type=float, default=0.8)
        sp.add_argument("--split_seed", type=int, default=100)

    sp = sub.add_parser("pair")
    trees(sp)
    sp.add_argument("--max_days", type=int, default=180)
    split(sp)
    sp.set_defaults(fn=cmd_pair)

    sp = sub.add_parser("audit")
    trees(sp, out=False)
    sp.add_argument("--max_days", type=int, default=180)
    sp.set_defaults(fn=cmd_audit)

    sp = sub.add_parser("merge-csf")
    sp.add_argument("--manifest", required=True)
    sp.add_argument("--adnimerge_csv", required=True)
    sp.add_argument("--pet_kind", default="AV45", choices=["AV45", "AV1451"])
    sp.add_argument("--out_csv", required=True)
    sp.set_defaults(fn=cmd_merge_csf)

    sp = sub.add_parser("stats")
    sp.add_argument("--manifest", required=True)
    sp.add_argument("--out_json", required=True)
    sp.set_defaults(fn=cmd_stats)

    sp = sub.add_parser("reg")
    trees(sp)
    sp.add_argument("--metric", default="ncc", choices=["ncc", "mi"])
    add_device_arg(sp)
    sp.set_defaults(fn=cmd_reg)

    sp = sub.add_parser("downsample")
    sp.add_argument("--T1_dir", required=True)
    sp.add_argument("--out_dir", required=True)
    sp.add_argument("--spacing", type=float, nargs=3, default=[1.5, 1.5, 1.5])
    sp.add_argument("--crop", type=int, nargs=3, default=[96, 128, 96])
    sp.add_argument("--template", default=None,
                    help="MNI/ICBM-152 template NIfTI: rigid-register each T1 to it first (reg_to_mni_first)")
    add_device_arg(sp)
    sp.set_defaults(fn=cmd_downsample)

    sp = sub.add_parser("mask")
    trees(sp)
    sp.set_defaults(fn=cmd_mask)

    sp = sub.add_parser("simple-csv")
    sp.add_argument("--image_dir", required=True)
    sp.add_argument("--out_dir", required=True)
    split(sp)
    sp.set_defaults(fn=cmd_simple_csv)

    sp = sub.add_parser("pack")
    sp.add_argument("--manifest", required=True)
    trees(sp)
    sp.add_argument("--pet_kind", default="AV45", choices=["AV45", "AV1451"])
    sp.add_argument("--with_covariates", action="store_true")
    sp.add_argument("--min_and_max", default=None)
    sp.set_defaults(fn=cmd_pack)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
