"""The port's offline tool-chain against the JAX package's, on the CPU: the host
modules (manifest, covariates, mgz, segmentation, cohort) and every subcommand
of `cli.preprocess`, `cli.postprocess` and `cli.metrics`, both packages run on
the same tiny seeded trees (the port with ``--device cpu``).

Limits: host outputs (CSV, JSON, stdout, packed arrays, masked NIfTIs) are
equal byte for byte; values computed on the device (SUVR, metrics, N4 and
resampled volumes) are within 1e-5 relative to max |JAX value| (a metric's std
relative to its mean). Volumes that
a registration resampled (`reg`, `downsample --template`) are within 1e-3: the
two optimisers end up to a fraction of an Adam step apart (the reasoning and
the params' limit are in tests/test_torch_port_registration.py; here they part
by up to 3e-4 rad or voxel), which moves a voxel of these ~10-voxel-radius
phantoms by about 3e-3 voxel, and their intensity changes by at most ~0.3 of
its max a voxel. Measured on the CPU: 4.6e-5 and 7.5e-6.
"""

import contextlib
import csv
import gzip
import io
import json
import os
import shutil
import struct
import sys

import numpy as np
import pytest
import torch

from cips_tpu.cli import metrics as jax_metrics_cli
from cips_tpu.cli import postprocess as jax_post
from cips_tpu.cli import preprocess as jax_pre
from cips_tpu.data import covariates as jax_cov
from cips_tpu.data import dataset as jax_dataset
from cips_tpu.data import manifest as jax_man
from cips_tpu.data import mgz as jax_mgz
from cips_tpu.data import nifti
from cips_tpu.data import preprocess as jax_prep
from cips_tpu.data import segmentation as jax_seg
from cips_tpu.eval import cohort as jax_cohort
from cips_tpu_torch.cli import metrics as port_metrics_cli
from cips_tpu_torch.cli import postprocess as port_post
from cips_tpu_torch.cli import preprocess as port_pre
from cips_tpu_torch.data import covariates as port_cov
from cips_tpu_torch.data import manifest as port_man
from cips_tpu_torch.data import mgz as port_mgz
from cips_tpu_torch.data import preprocess as port_prep
from cips_tpu_torch.data import segmentation as port_seg
from cips_tpu_torch.eval import cohort as port_cohort

TOL_F32 = 1e-5
TOL_REGISTERED = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread: small tensors, and a full intra-op pool in each of
    the suite's parallel workers oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def run(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _blob(shape, center, sigma, scale=1.0):
    g = np.stack(np.meshgrid(*[np.arange(n) for n in shape], indexing="ij"), -1).astype(np.float64)
    return (scale * np.exp(-((g - center) ** 2).sum(-1) / (2 * sigma * sigma))).astype(np.float32)


def _oblique(spacing_xyz, deg):
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    a = np.eye(4)
    a[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ np.diag(spacing_xyz)
    a[:3, 3] = (-5.0, 3.0, -8.0)
    return a


T1_SHAPE = (14, 16, 14)
T1_DATES = {"s0": ["2015-01-01", "2016-01-01"], "s1": ["2015-03-01"], "s2": ["2014-01-01"], "s3": ["2015-05-05"]}
PET_DATES = {"s0": ["2015-02-01"], "s1": ["2015-03-20", "2015-09-01"], "s2": ["2015-06-01"]}
ADNIMERGE = [
    "PTID,EXAMDATE,ABETA,Age,Sex,APOE4,PTEDUCAT,DX,PTGENDER,AGE",
    "s0,2014-12-01,650.5,71.2,Female,1,16,CN,Female,71.2",
    "s0,2016-02-01,<200,72.4,Female,1,16,MCI,Female,72.4",
    "s1,2015-04-01,>1700,68.0,Male,0,12,MCI,Male,68.0",
    "s1,2016-04-01,900,69.0,Male,0,12,AD,Male,69.0",
    "s2,2015-05-01,,75.0,Male,2,18,CN,Male,75.0",
]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """T1 and PET session trees (s0 with oblique scanner headers and a shifted
    PET, the rest on identity headers), an ADNIMERGE-style CSV, a FastSurfer-style
    segmentation tree and a predict tree of ori/rec pairs."""
    root = tmp_path_factory.mktemp("toolchain")
    rng = np.random.default_rng(0)
    for i, (subject, dates) in enumerate(sorted(T1_DATES.items())):
        for date in dates:
            t1 = _blob(T1_SHAPE, (7, 8, 7), 3.5) + 0.5 * _blob(T1_SHAPE, (4 + i % 2, 10, 8), 1.8)
            t1 = t1 * np.exp(0.2 * np.linspace(-1, 1, T1_SHAPE[2]))[None, None] + 0.01 * rng.random(T1_SHAPE)
            t1[t1 < 0.05] = 0.0
            affine = _oblique((1.0, 1.0, 1.2), 5.0) if subject == "s0" else np.eye(4)
            nifti.write(str(root / "t1" / subject / date / "t1.nii.gz"),
                        nifti.NiftiImage(data=t1.astype(np.float32), affine=affine, spacing=(1.0, 1.0, 1.2)))
    for subject, dates in PET_DATES.items():
        for date in dates:
            pet = (_blob(T1_SHAPE, (7.4, 7.6, 7.3), 3.5) + 0.5 * _blob(T1_SHAPE, (4.5, 9.6, 8.3), 1.8)
                   + 0.01 * rng.random(T1_SHAPE))
            affine = _oblique((1.0, 1.0, 1.2), 7.0) if subject == "s0" else np.eye(4)
            nifti.write(str(root / "pet" / subject / date / "pet.nii.gz"),
                        nifti.NiftiImage(data=pet.astype(np.float32), affine=affine, spacing=(1.0, 1.0, 1.2)))
    (root / "adnimerge.csv").write_text("\n".join(ADNIMERGE) + "\n")

    seg = np.zeros((20, 20, 20), np.int32)
    seg[2:9] = 3
    seg[9:12] = 42
    seg[12:16, :10] = 8
    seg[12:16, 10:] = 47
    for noise, (subject, date) in zip((0.03, 0.05, 0.08), (("s0", "2015-02-01"), ("s1", "2015-03-20"),
                                                          ("s1", "2015-09-01"))):
        nifti.write(str(root / "seg" / subject / date / "aseg.nii.gz"), seg)
        for name, gain in (("rec.nii.gz", 1.0), ("ori.nii.gz", 1.1)):
            pet = (rng.random((20, 20, 20)) * gain + (seg == 3)).astype(np.float32)
            nifti.write(str(root / "suvr_pet" / subject / date / name), pet)
            small = (rng.random((12, 13, 12)) * gain).astype(np.float32)  # --conform: 1.5x up, padded to 20^3
            nifti.write(str(root / "conform_pet" / subject / date / name), small)
        real = _blob((16, 44, 40), (8, 22, 20), 8.0) + 0.05 * rng.random((16, 44, 40))
        rec = real + noise * rng.standard_normal(real.shape)
        nifti.write(str(root / "pred" / subject / date / "ori.nii.gz"), real.astype(np.float32))
        nifti.write(str(root / "pred" / subject / date / "rec.nii.gz"), rec.astype(np.float32))
        nifti.write(str(root / "real_tree" / subject / date / "img.nii.gz"), real.astype(np.float32))
        nifti.write(str(root / "sys_tree" / subject / date / "rec.nii.gz"), rec.astype(np.float32))
    return root


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def _same_files(got_root, want_root, nifti_tol=None):
    names = _files(want_root)
    assert names and _files(got_root) == names
    for name in names:
        got, want = os.path.join(got_root, name), os.path.join(want_root, name)
        if name.endswith(".nii.gz"):
            a, b = nifti.read(got), nifti.read(want)
            assert np.array_equal(a.affine, b.affine) and a.spacing == b.spacing and a.data.shape == b.data.shape
            if nifti_tol is None:
                assert np.array_equal(a.data, b.data), name
            else:
                assert rel_err(a.data, b.data) <= nifti_tol, (name, rel_err(a.data, b.data))
        else:
            with open(got, "rb") as fa, open(want, "rb") as fb:
                assert fa.read() == fb.read(), name


def test_manifest_functions_match_jax(tree):
    for s in ("2015-01-02", "2015/01/02", "01/02/2015"):
        assert port_man.parse_date(s) == jax_man.parse_date(s)
    assert port_man.days_between("2015-01-02", "2016-03-01") == jax_man.days_between("2015-01-02", "2016-03-01")
    pet, t1 = port_man.scan_session_dirs(str(tree / "pet")), port_man.scan_session_dirs(str(tree / "t1"))
    assert pet == jax_man.scan_session_dirs(str(tree / "pet")) and t1 == jax_man.scan_session_dirs(str(tree / "t1"))
    for max_days in (30, 180):
        got = port_man.pair_sessions(pet, t1, max_days)
        assert [r.to_dict() for r in got] == [r.to_dict() for r in jax_man.pair_sessions(pet, t1, max_days)]
        assert port_man.unpaired_pet_sessions(pet, t1, max_days) == jax_man.unpaired_pet_sessions(pet, t1, max_days)
    rows = [port_man.PairRow(f"sub{i}", "2015-01-01", "2015-02-01", {"k": str(i)}) for i in range(23)]
    jrows = [jax_man.PairRow(f"sub{i}", "2015-01-01", "2015-02-01", {"k": str(i)}) for i in range(23)]
    for frac, seed in ((0.8, 100), (0.5, 3)):
        got, want = port_man.subject_split(rows, frac, seed), jax_man.subject_split(jrows, frac, seed)
        assert [[r.to_dict() for r in side] for side in got] == [[r.to_dict() for r in side] for side in want]
    port_man.write_manifest(str(tree / "m_port.csv"), rows)
    jax_man.write_manifest(str(tree / "m_jax.csv"), jrows)
    assert (tree / "m_port.csv").read_bytes() == (tree / "m_jax.csv").read_bytes()


def test_covariate_functions_match_jax(tree):
    exams = {}
    with open(tree / "adnimerge.csv", newline="") as f:
        for rec in csv.DictReader(f):
            exams.setdefault(rec["PTID"], []).append(rec)
    pairs = [("s0", "2015-01-01", "2015-02-01"), ("s1", "2015-03-01", "2015-03-20"), ("s2", "2014-01-01", "2015-06-01"),
             ("s4", "2015-01-01", "2015-01-01")]
    for keys in (port_cov.COVARIATES_BY_TRACER["AV45"], ["Age", "Sex"]):
        for max_days in (None, 40):
            got = port_cov.merge_covariates([port_man.PairRow(*p) for p in pairs], exams, keys, max_days=max_days)
            want = jax_cov.merge_covariates([jax_man.PairRow(*p) for p in pairs], exams, keys, max_days=max_days)
            assert [r.to_dict() for r in got] == [r.to_dict() for r in want]
    assert port_cov.CONTINUOUS_COVARIATES == jax_cov.CONTINUOUS_COVARIATES
    got_stats = port_cov.compute_min_and_max(got)
    assert got_stats == jax_cov.compute_min_and_max(want)
    port_cov.save_min_and_max(str(tree / "stats_port.json"), got_stats)
    jax_cov.save_min_and_max(str(tree / "stats_jax.json"), got_stats)
    assert (tree / "stats_port.json").read_bytes() == (tree / "stats_jax.json").read_bytes()


def _write_mgz(path, vol, spacing=(1.0, 1.0, 1.0), good_ras=1):
    depth, height, width = vol.shape
    code = {np.dtype(np.uint8): 0, np.dtype(np.int32): 1, np.dtype(np.float32): 3, np.dtype(np.int16): 4}[vol.dtype]
    hdr = bytearray(284)
    struct.pack_into(">7i", hdr, 0, 1, width, height, depth, 1, code, 0)
    struct.pack_into(">h", hdr, 28, good_ras)
    struct.pack_into(">3f", hdr, 30, *spacing)
    with gzip.open(path, "wb") as f:
        f.write(bytes(hdr) + vol.astype(vol.dtype.newbyteorder(">")).tobytes())


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.float32, np.int16])
def test_mgz_reader_matches_jax(tmp_path, dtype):
    vol = (np.arange(3 * 4 * 5) % 120).reshape(3, 4, 5).astype(dtype)
    for good_ras in (0, 1):
        path = str(tmp_path / f"aseg{good_ras}.mgz")
        _write_mgz(path, vol, spacing=(1.5, 1.0, 2.0), good_ras=good_ras)
        got, want = port_mgz.read_mgz(path), jax_mgz.read_mgz(path)
        assert np.array_equal(got[0], vol) and got[0].dtype == want[0].dtype and got[1] == want[1]
        assert np.array_equal(port_mgz.read_segmentation(path), jax_mgz.read_segmentation(path))
    nifti.write(str(tmp_path / "aseg.nii.gz"), vol.astype(np.int32))
    seg = port_mgz.read_segmentation(str(tmp_path / "aseg.nii.gz"))
    assert seg.dtype == np.int32 and np.array_equal(seg, jax_mgz.read_segmentation(str(tmp_path / "aseg.nii.gz")))


def test_segmentation_driver_matches_jax(tree, tmp_path):
    assert port_seg.default_fastsurfer_command("/a/t1.nii.gz", "/o", "s_d") == \
        jax_seg.default_fastsurfer_command("/a/t1.nii.gz", "/o", "s_d")
    calls = {}
    for name, mod in (("port", port_seg), ("jax", jax_seg)):
        out_root = tmp_path / name
        (out_root / "s1" / "2015-03-01").mkdir(parents=True)
        (out_root / "s1" / "2015-03-01" / "aparc.DKTatlas+aseg.deep.mgz").write_bytes(b"")
        calls[name] = []
        result = mod.segment_tree(str(tree / "t1"), str(out_root),
                                  runner=lambda cmd, c=calls[name]: c.append(cmd) or (len(c) % 2))
        calls[name] = [[part.replace(str(out_root), "OUT") for part in cmd] for cmd in calls[name]]
        calls[name + "_result"] = result
    assert calls["port"] == calls["jax"] and calls["port_result"] == calls["jax_result"] == (2, 1)
    for subject, date in (("s0", "2015-06-01"), ("s1", "2015-04-01"), ("s9", "2015-01-01")):
        assert port_seg.find_segmentation(str(tree / "seg"), subject, date) == \
            jax_seg.find_segmentation(str(tree / "seg"), subject, date)


def test_cohort_functions_match_jax(tree, tmp_path, monkeypatch):
    exams = {"s0": [{"EXAMDATE": "2015-01-01", "DX": "CN"}, {"EXAMDATE": "2016-01-01", "DX": "EMCI"}],
             "s1": [{"EXAMDATE": "2015-01-01", "DX": "Dementia"}], "s2": [{"EXAMDATE": "2015-01-01", "DX": ""}]}
    demo = {"s0": {"Sex": "Female", "Age": "71.5"}, "s1": {"Sex": "M", "Age": ""}}
    sessions = [("s0", "2015-02-01"), ("s0", "2015-12-01"), ("s1", "2015-03-01"), ("s2", "2015-01-01")]
    for dx in ("CN", "SMC", "LMCI", "AD", "Dementia", "", "x"):
        assert port_cohort._norm_dx(dx) == jax_cohort._norm_dx(dx)
        assert port_cohort.longitudinal_group([dx, "MCI", "AD"]) == jax_cohort.longitudinal_group([dx, "MCI", "AD"])
    assert port_cohort.nearest_diagnosis(exams["s0"], "2015-11-01") == jax_cohort.nearest_diagnosis(exams["s0"], "2015-11-01")
    got, want = port_cohort.cohort_summary(sessions, exams, demo), jax_cohort.cohort_summary(sessions, exams, demo)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    records = [("s0", "d1", 1.2), ("s1", "d2", 2.5), ("s2", "d3", 0.9)]
    assert port_cohort.filter_suvr_outliers(records) == jax_cohort.filter_suvr_outliers(records)
    gt, synth = {("s0", "a"): 1.0, ("s1", "b"): 1.3}, {("s0", "a"): 1.1, ("s2", "c"): 0.7}
    assert port_cohort.suvr_error_table(gt, synth) == jax_cohort.suvr_error_table(gt, synth)
    groups = {"s0": "pCN", "s1": "AD"}
    written = {name: mod.group_scatter_figure(records, groups, str(tmp_path / f"{name}.jpg"))
               for name, mod in (("port", port_cohort), ("jax", jax_cohort))}
    assert (written["port"] is None) == (written["jax"] is None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # absent: both return None
    assert port_cohort.group_scatter_figure(records, groups, str(tmp_path / "x.jpg")) is None
    assert jax_cohort.group_scatter_figure(records, groups, str(tmp_path / "y.jpg")) is None


def test_preprocess_host_subcommands_match_jax(tree, tmp_path, monkeypatch):
    # the JAX package's numpy decode, which the port's native runtime equals bit for bit (JAX's
    # C++ decode max-normalises by a reciprocal: the float16 store then differs by an ulp)
    monkeypatch.setattr(jax_dataset, "_native", lambda: None)
    outs = {}
    for name, main in (("port", port_pre.main), ("jax", jax_pre.main)):
        out = tmp_path / name
        text = run(main, ["pair", "--PET_dir", str(tree / "pet"), "--T1_dir", str(tree / "t1"), "--out_dir", str(out),
                          "--train_frac", "0.5"])
        text += run(main, ["audit", "--PET_dir", str(tree / "pet"), "--T1_dir", str(tree / "t1")])
        text += run(main, ["merge-csf", "--manifest", str(out / "pair_all.csv"), "--adnimerge_csv",
                           str(tree / "adnimerge.csv"), "--out_csv", str(out / "pair_all_csf.csv")])
        text += run(main, ["stats", "--manifest", str(out / "pair_all_csf.csv"), "--out_json", str(out / "stats.json")])
        text += run(main, ["simple-csv", "--image_dir", str(tree / "t1"), "--out_dir", str(out / "simple"),
                           "--train_frac", "0.5", "--split_seed", "7"])
        text += run(main, ["mask", "--PET_dir", str(tree / "pet"), "--T1_dir", str(tree / "t1"),
                           "--out_dir", str(out / "masked")])
        text += run(main, ["pack", "--manifest", str(out / "pair_all_csf.csv"), "--PET_dir", str(tree / "pet"),
                           "--T1_dir", str(tree / "t1"), "--out_dir", str(out / "packed"), "--with_covariates",
                           "--min_and_max", str(out / "stats.json")])
        outs[name] = text.replace(str(out), "OUT")
    assert outs["port"] == outs["jax"]
    assert "2 unpaired PET sessions" in outs["port"] and "masked 4 PET sessions" in outs["port"]
    _same_files(tmp_path / "port", tmp_path / "jax")


def _subtree(src, dst, sessions):
    for subject, date in sessions:
        shutil.copytree(src / subject / date, dst / subject / date)
    return dst


def test_preprocess_device_subcommands_match_jax(tree, tmp_path):
    pet = _subtree(tree / "pet", tmp_path / "pet", [("s0", "2015-02-01"), ("s1", "2015-03-20")])
    t1_one = _subtree(tree / "t1", tmp_path / "t1_one", [("s1", "2015-03-01")])
    template = _blob(T1_SHAPE, (7, 8, 7), 3.5) + 0.5 * _blob(T1_SHAPE, (4, 10, 8), 1.8)
    nifti.write(str(tmp_path / "mni.nii.gz"), nifti.NiftiImage(data=template, spacing=(1.1, 1.1, 1.1)))
    for name, main, device in (("port", port_pre.main, ["--device", "cpu"]), ("jax", jax_pre.main, [])):
        out = tmp_path / name
        run(main, ["reg", "--PET_dir", str(pet), "--T1_dir", str(tree / "t1"), "--out_dir", str(out / "reg")] + device)
        run(main, ["downsample", "--T1_dir", str(tree / "t1"), "--out_dir", str(out / "ds"), "--spacing", "1.5", "1.4",
                   "1.3", "--crop", "10", "12", "9"] + device)
        run(main, ["downsample", "--T1_dir", str(t1_one), "--out_dir", str(out / "ds_mni"), "--crop", "9", "9", "9",
                   "--template", str(tmp_path / "mni.nii.gz")] + device)
    assert len(_files(tmp_path / "jax" / "reg")) == 2 and len(_files(tmp_path / "jax" / "ds")) == 5
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    _same_files(tmp_path / "port" / "ds", tmp_path / "jax" / "ds", nifti_tol=TOL_F32)
    for sub in ("reg", "ds_mni"):
        _same_files(tmp_path / "port" / sub, tmp_path / "jax" / sub, nifti_tol=TOL_REGISTERED)


def test_joint_register_matches_jax():
    rng = np.random.default_rng(3)
    target = _blob(T1_SHAPE, (7, 8, 7), 3.5) + 0.5 * _blob(T1_SHAPE, (4, 10, 8), 1.8)
    brain = _blob(T1_SHAPE, (7.5, 7.6, 7.2), 3.5) + 0.5 * _blob(T1_SHAPE, (4.5, 9.6, 8.2), 1.8)
    mask = rng.integers(0, 4, T1_SHAPE).astype(np.int16)
    got = port_prep.joint_register(brain, mask, target, device="cpu")
    want = jax_prep.joint_register(brain, mask, target)
    assert got[1].dtype == want[1].dtype == np.int16
    assert rel_err(got[0], want[0]) <= TOL_F32 and np.array_equal(got[1], want[1])


def test_postprocess_subcommands_match_jax(tree, tmp_path):
    outs = {}
    for name, main, device in (("port", port_post.main, ["--device", "cpu"]), ("jax", jax_post.main, [])):
        out = tmp_path / name
        text = ""
        for pet_dir, conform in (("suvr_pet", []), ("conform_pet", ["--conform"])):
            for pet_name in ("rec.nii.gz", "ori.nii.gz"):
                csv_path = str(out / f"{pet_dir}_{pet_name[:3]}.csv")
                run(main, ["suvr", "--pet_dir", str(tree / pet_dir), "--seg_dir", str(tree / "seg"), "--pet_name",
                           pet_name, "--out_csv", csv_path] + conform + device)
        outs[name] = {p: list(csv.DictReader(open(p))) for p in sorted(map(str, out.glob("*.csv")))}
    for (pg, rows_p), (pj, rows_j) in zip(outs["port"].items(), outs["jax"].items()):
        assert os.path.basename(pg) == os.path.basename(pj) and len(rows_p) == len(rows_j) == 3
        for rp, rj in zip(rows_p, rows_j):
            assert (rp["Subject"], rp["date"]) == (rj["Subject"], rj["date"])
            assert rel_err(float(rp["suvr"]), float(rj["suvr"])) <= TOL_F32

    # the host subcommands, on the same (JAX-written) SUVR CSVs
    jax_out = tmp_path / "jax"
    dx = str(tree / "adnimerge.csv")
    manifest = tmp_path / "pairs.csv"
    manifest.write_text("Subject,T1_date,PET_date\ns0,2015-01-01,2015-02-01\ns1,2015-03-01,2015-03-20\n")
    texts = {}
    for name, main in (("port", port_post.main), ("jax", jax_post.main)):
        texts[name] = run(main, ["suvr-error", "--gt_csv", str(jax_out / "suvr_pet_ori.csv"), "--synth_csv",
                                 str(jax_out / "suvr_pet_rec.csv")])
        texts[name] += run(main, ["analyse", "--suvr_csv", str(jax_out / "suvr_pet_rec.csv"), "--dx_csv", dx,
                                  "--max_suvr", "9", "--out_fig", str(tmp_path / f"{name}.jpg")])
        texts[name] += run(main, ["summary", "--manifest", str(manifest), "--adnimerge_csv", dx])
        texts[name] = texts[name].replace(str(tmp_path / f"{name}.jpg"), "FIG")
    assert texts["port"] == texts["jax"]
    assert os.path.exists(tmp_path / "port.jpg") == os.path.exists(tmp_path / "jax.jpg")


@pytest.mark.parametrize("mode", ["one-tree", "two-tree", "no-match"])
def test_metrics_cli_matches_jax(tree, mode):
    args = {"one-tree": ["--root", str(tree / "pred")],
            "two-tree": ["--root", str(tree / "sys_tree"), "--real_root", str(tree / "real_tree")],
            "no-match": ["--root", str(tree / "pred"), "--no_intensity_match"]}[mode]
    args += ["--metric_shape", "14", "48", "40"]
    got_text = run(port_metrics_cli.main, args + ["--device", "cpu"])
    want_text = run(jax_metrics_cli.main, args)
    got, want = json.loads(got_text), json.loads(want_text)
    assert list(got) == list(want) and got["count"] == want["count"] == 3
    for key in want:
        # a std's error is its values' error, whose scale is their mean: it is
        # held to 1e-5 of the mean (3 pairs here; a std of 3 near-equal values
        # would otherwise put the noise of its sums over a value near 0)
        scale = abs(want[key.replace("_std", "_mean")])
        assert abs(got[key] - want[key]) <= TOL_F32 * scale, (key, got[key], want[key])
