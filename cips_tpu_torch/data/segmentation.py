"""Segmentation drivers: FastSurfer orchestration (the port's copy of
cips_tpu/data/segmentation.py).

The reference runs FastSurfer per subject and date in a singularity container
(proprocess/fastsurfer_t1.py:25-31, `run_fastsurfer.sh --seg_only`). The
container is an external clinical tool and is not reimplemented; this module
keeps its orchestration (walk the {root}/{Subject}/{date}/ tree, skip finished
sessions, run the container on each T1) with the runner injectable. The
outputs (aseg.mgz, iBEAT NIfTIs) are read by `data.mgz.read_segmentation` and
scored by `ops.suvr`.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Callable, List, Optional, Sequence, Tuple

from cips_tpu_torch.data.manifest import days_between, scan_session_dirs


def default_fastsurfer_command(
    t1_path: str, out_dir: str, subject_id: str, sif_path: str = "fastsurfer.sif"
) -> List[str]:
    """The singularity call of fastsurfer_t1.py:25-31 (--seg_only)."""
    return [
        "singularity", "exec", "--nv",
        "-B", f"{os.path.dirname(t1_path)}:/data",
        "-B", f"{out_dir}:/output",
        sif_path,
        "/fastsurfer/run_fastsurfer.sh",
        "--t1", f"/data/{os.path.basename(t1_path)}",
        "--sid", subject_id,
        "--sd", "/output",
        "--seg_only",
    ]


def segment_tree(
    t1_root: str,
    out_root: str,
    runner: Optional[Callable[[Sequence[str]], int]] = None,
    command_builder: Callable = default_fastsurfer_command,
    done_marker: str = "aparc.DKTatlas+aseg.deep.mgz",
) -> Tuple[int, int]:
    """Segment every T1 session that lacks a finished output; returns (n_run, n_skipped).

    ``runner`` (default: `subprocess.run`) returns the process's exit code;
    sessions that already hold ``done_marker`` are skipped, as the reference does.
    """
    if runner is None:
        if shutil.which("singularity") is None:
            raise RuntimeError("singularity not available; pass a custom runner or use precomputed segmentations")
        runner = lambda cmd: subprocess.run(cmd).returncode  # noqa: E731

    n_run = n_skip = 0
    for subject, dates in scan_session_dirs(t1_root).items():
        for date in dates:
            session_out = os.path.join(out_root, subject, date)
            sid = f"{subject}_{date}"
            if _session_done(session_out, sid, done_marker):
                n_skip += 1
                continue
            t1_dir = os.path.join(t1_root, subject, date)
            files = [f for f in sorted(os.listdir(t1_dir)) if f.endswith((".nii", ".nii.gz"))]
            if not files:
                continue
            os.makedirs(session_out, exist_ok=True)
            if runner(command_builder(os.path.join(t1_dir, files[0]), session_out, sid)) == 0:
                n_run += 1
    return n_run, n_skip


def _session_done(session_out: str, sid: str, marker: str) -> bool:
    return any(os.path.isfile(os.path.join(root, marker)) for root in (os.path.join(session_out, sid, "mri"), session_out))


def find_segmentation(seg_root: str, subject: str, near_date: str) -> Optional[str]:
    """The subject's segmentation file nearest ``near_date`` (appy_iBEAT.py:126-132):
    a file named *seg* first, else the first volume of that session."""
    subj_dir = os.path.join(seg_root, subject)
    if not os.path.isdir(subj_dir):
        return None
    dates = [d for d in sorted(os.listdir(subj_dir)) if os.path.isdir(os.path.join(subj_dir, d))]
    if not dates:
        return None
    d = os.path.join(subj_dir, min(dates, key=lambda x: days_between(x, near_date)))
    volumes = [f for f in sorted(os.listdir(d)) if f.endswith((".mgz", ".nii", ".nii.gz"))]
    named = [f for f in volumes if "seg" in f]
    return os.path.join(d, (named or volumes)[0]) if volumes else None
