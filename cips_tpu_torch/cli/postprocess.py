"""Postprocess CLI: SUVR, SUVR error, cohort analysis (port of
cips_tpu/cli/postprocess.py; the reference's proprocess/ chain, whose
FastSurfer/iBEAT containers are not reimplemented: their outputs are read):

  suvr        apply_surfurseg_to_PET.py / appy_iBEAT.py: per-session SUVR from a
              PET tree and a segmentation tree -> CSV (on the card unless --device cpu)
  suvr-error  compute_suvr_error.py: gt-vs-synth SUVR MAE (host)
  analyse     analyse_suvr.py: longitudinal grouping and scatter figure (host)
  summary     unet/scripts/summary.py: cohort demographics (host)
"""

from __future__ import annotations

import argparse
import csv
import os
from collections import defaultdict

import numpy as np
import torch

from cips_tpu_torch import default_device
from cips_tpu_torch.cli.common import add_device_arg
from cips_tpu_torch.data import nifti
from cips_tpu_torch.data.manifest import days_between, read_manifest
from cips_tpu_torch.eval import cohort
from cips_tpu_torch.ops import suvr as suvr_ops


def _load_suvr_csv(path):
    with open(path, newline="", encoding="utf-8") as f:
        return {(rec["Subject"], rec["date"]): float(rec["suvr"]) for rec in csv.DictReader(f)}


def cmd_suvr(args):
    device = default_device(args.device)
    fastsurfer = args.seg_kind == "fastsurfer"
    roi = suvr_ops.FASTSURFER_ROI if fastsurfer else suvr_ops.IBEAT_ROI
    ref = suvr_ops.FASTSURFER_REF if fastsurfer else suvr_ops.IBEAT_REF
    rows = []
    for subject in sorted(os.listdir(args.pet_dir)):
        subj_dir = os.path.join(args.pet_dir, subject)
        if not os.path.isdir(subj_dir):
            continue
        for date in sorted(os.listdir(subj_dir)):
            pet_path = os.path.join(subj_dir, date, args.pet_name)
            seg_dir = os.path.join(args.seg_dir, subject)
            if not os.path.isfile(pet_path) or not os.path.isdir(seg_dir):
                continue
            seg_dates = sorted(os.listdir(seg_dir))
            if not seg_dates:
                continue
            # nearest-date segmentation (appy_iBEAT.py:126-132)
            seg_date = min(seg_dates, key=lambda d: days_between(d, date))
            seg_files = [f for f in os.listdir(os.path.join(seg_dir, seg_date)) if "seg" in f or f.endswith(".nii.gz")]
            if not seg_files:
                continue
            seg = nifti.read_array(os.path.join(seg_dir, seg_date, seg_files[0]))
            pet = torch.from_numpy(nifti.read_array(pet_path).astype(np.float32)).to(device)
            if args.conform:
                pet = suvr_ops.resize_and_pad_pet_to_seg(pet, seg.shape)
            if tuple(pet.shape) != seg.shape:
                print(f"skip {subject}/{date}: shape {tuple(pet.shape)} vs seg {seg.shape}")
                continue
            seg_t = torch.from_numpy(seg.astype(np.int32)).to(device)
            val = float(suvr_ops.compute_suvr(pet, seg_t, roi, ref))
            rows.append({"Subject": subject, "date": date, "suvr": val})
            print(f"{subject} {date} SUVR {val:.4f}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out_csv)), exist_ok=True)
    with open(args.out_csv, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=["Subject", "date", "suvr"])
        w.writeheader()
        w.writerows(rows)
    print(f"{len(rows)} sessions -> {args.out_csv}")


def cmd_suvr_error(args):
    print(cohort.suvr_error_table(_load_suvr_csv(args.gt_csv), _load_suvr_csv(args.synth_csv)))


def cmd_analyse(args):
    records = [(s, d, v) for (s, d), v in _load_suvr_csv(args.suvr_csv).items()]
    records = cohort.filter_suvr_outliers(records, max_suvr=args.max_suvr)
    trajectories = defaultdict(list)
    with open(args.dx_csv, newline="", encoding="utf-8") as f:
        for rec in csv.DictReader(f):
            subject = rec.get("PTID") or rec.get("Subject")
            if subject and rec.get("DX"):
                trajectories[subject].append((rec.get("EXAMDATE", ""), rec["DX"]))
    groups = {}
    for subject, entries in trajectories.items():
        entries.sort()
        g = cohort.longitudinal_group([dx for _, dx in entries])
        if g:
            groups[subject] = g
    path = cohort.group_scatter_figure(records, groups, args.out_fig)
    counts = defaultdict(int)
    for s, _, _ in records:
        if s in groups:
            counts[groups[s]] += 1
    print(dict(counts), "->", path)


def cmd_summary(args):
    sessions = [(r.subject, r.pet_date) for r in read_manifest(args.manifest)]
    exams = defaultdict(list)
    demo = {}
    with open(args.adnimerge_csv, newline="", encoding="utf-8") as f:
        for rec in csv.DictReader(f):
            subject = rec.get("PTID") or rec.get("Subject")
            if not subject:
                continue
            exams[subject].append(rec)
            demo.setdefault(subject, {"Sex": rec.get("PTGENDER", rec.get("Sex", "")),
                                      "Age": rec.get("AGE", rec.get("Age", ""))})
    for dx, stats in sorted(cohort.cohort_summary(sessions, exams, demo).items()):
        print(dx, {k: round(v, 3) for k, v in stats.items()})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("suvr")
    sp.add_argument("--pet_dir", required=True)
    sp.add_argument("--seg_dir", required=True)
    sp.add_argument("--pet_name", default="rec.nii.gz")
    sp.add_argument("--seg_kind", default="fastsurfer", choices=["fastsurfer", "ibeat"])
    sp.add_argument("--conform", action="store_true", help="1.5x upsample + pad + reorient PET into seg space")
    sp.add_argument("--out_csv", required=True)
    add_device_arg(sp)
    sp.set_defaults(fn=cmd_suvr)

    sp = sub.add_parser("suvr-error")
    sp.add_argument("--gt_csv", required=True)
    sp.add_argument("--synth_csv", required=True)
    sp.set_defaults(fn=cmd_suvr_error)

    sp = sub.add_parser("analyse")
    sp.add_argument("--suvr_csv", required=True)
    sp.add_argument("--dx_csv", required=True)
    sp.add_argument("--max_suvr", type=float, default=2.0)
    sp.add_argument("--out_fig", default="suvr_groups.jpg")
    sp.set_defaults(fn=cmd_analyse)

    sp = sub.add_parser("summary")
    sp.add_argument("--manifest", required=True)
    sp.add_argument("--adnimerge_csv", required=True)
    sp.set_defaults(fn=cmd_summary)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
