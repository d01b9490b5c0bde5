"""The port's native decode runtime and its prefetch pool on the CPU.

`runtime.native.decode` against the port's numpy reader (`data.nifti` +
`pad_crop_np` + `max_normalize_np`, bit for bit, its normalisation being the
numpy path's division) and against the JAX package's `runtime.native.decode`
(rtol 1e-6, as tests/test_native_runtime.py holds JAX's to numpy: JAX's
multiplies by the reciprocal of the maximum), over int16, uint8, float32 and
float64 voxels, .nii and .nii.gz, scl_slope/inter and a big-endian file; the
header query; the pool under stress and a sample that fails; a
`StreamingLoader` epoch through the pool against the synchronous path's
batches, rows, order, crop corners and rank shards; a build that fails raises.
"""

import gzip
import os
import struct
import warnings

import numpy as np
import pytest

from cips_tpu.data import dataset as jax_dataset
from cips_tpu.runtime import native as jax_native
from cips_tpu_torch.data import nifti
from cips_tpu_torch.data.dataset import PairedVolumeDataset, StreamingLoader, max_normalize_np, pad_crop_np
from cips_tpu_torch.parallel.mesh import shard_rows
from cips_tpu_torch.runtime import native

CROP = (10, 12, 8)
_CODES = {np.dtype(np.uint8): 2, np.dtype(np.int16): 4, np.dtype(np.float32): 16, np.dtype(np.float64): 64}


def write_raw(path, zyx: np.ndarray, endian: str = "<", slope: float = 0.0, inter: float = 0.0) -> str:
    """A NIfTI-1 file of ``zyx`` (x fastest on disk) in ``endian`` byte order, written by hand."""
    dt = zyx.dtype.newbyteorder(endian)
    hdr = bytearray(352)
    struct.pack_into(endian + "i", hdr, 0, 348)
    struct.pack_into(endian + "8h", hdr, 40, 3, zyx.shape[2], zyx.shape[1], zyx.shape[0], 1, 1, 1, 1)
    struct.pack_into(endian + "hh", hdr, 70, _CODES[zyx.dtype], zyx.dtype.itemsize * 8)
    struct.pack_into(endian + "8f", hdr, 76, 1, 1, 1, 1, 0, 0, 0, 0)
    struct.pack_into(endian + "fff", hdr, 108, 352.0, slope, inter)
    hdr[344:348] = b"n+1\0"
    raw = bytes(hdr) + zyx.astype(dt).tobytes()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with (gzip.open if path.endswith(".gz") else open)(path, "wb") as f:
        f.write(raw)
    return path


def _numpy_decode(path, shape, normalize):
    vol = pad_crop_np(nifti.read_array(path).astype(np.float32), shape)
    return max_normalize_np(vol) if normalize else vol


@pytest.mark.parametrize("dtype,suffix,endian,slope,inter", [
    (np.int16, ".nii.gz", "<", 0.0, 0.0),
    (np.uint8, ".nii", "<", 0.0, 0.0),
    (np.float32, ".nii.gz", ">", 0.0, 0.0),
    (np.float64, ".nii", "<", 0.0, 0.0),
    (np.int16, ".nii", ">", 1.5, -3.25),
    (np.float32, ".nii.gz", "<", 0.0, 2.0),
], ids=["int16-gz", "uint8", "float32-gz-bigendian", "float64", "int16-scaled-bigendian", "float32-inter"])
def test_decode_matches_the_numpy_reader_and_jax(tmp_path, dtype, suffix, endian, slope, inter):
    rng = np.random.default_rng([ord(c) for c in np.dtype(dtype).str + suffix + endian])
    vol = rng.random((9, 14, 7)) * 200 - (50 if np.dtype(dtype).kind in "if" else 0)
    path = write_raw(str(tmp_path / f"img{suffix}"), vol.astype(dtype), endian, slope, inter)
    assert native.nifti_shape(path) == (9, 14, 7) == jax_native.nifti_shape(path)
    for shape in (CROP, (9, 14, 7), (6, 16, 5)):  # pad and crop on different axes, neither, both
        for normalize in (True, False):
            got = native.decode(path, shape, normalize=normalize)
            assert got.dtype == np.float32 and got.shape == shape
            np.testing.assert_array_equal(got, _numpy_decode(path, shape, normalize))
            # JAX's copy skips scl_inter under a slope of 0, which the numpy reader applies
            if slope or not inter:
                np.testing.assert_allclose(got, jax_native.decode(path, shape, normalize=normalize), rtol=1e-6,
                                           atol=1e-6 * np.abs(got).max())


def test_unreadable_files_raise(tmp_path):
    bad = tmp_path / "bad.nii"
    bad.write_bytes(b"\0" * 400)
    for fn in (lambda: native.decode(str(bad), CROP), lambda: native.nifti_shape(str(bad)),
               lambda: native.decode(str(tmp_path / "missing.nii.gz"), CROP)):
        with pytest.raises(IOError):
            fn()


def test_pool_drains_every_submission_under_stress(tmp_path):
    rng = np.random.default_rng(1)
    t1s, pets = [], []
    for i in range(12):
        t1s.append(write_raw(str(tmp_path / f"t1_{i}.nii.gz"), (rng.random((5 + i % 3, 6, 4)) * 9).astype(np.float32)))
        pets.append(write_raw(str(tmp_path / f"pet_{i}.nii"), (rng.random((6, 6, 6)) * 5).astype(np.int16)))
    want = {i: np.stack([native.decode(t1s[i], (6, 6, 6)), native.decode(pets[i], (6, 6, 6))]) for i in range(12)}
    for threads, capacity in ((1, 1), (4, 2), (3, 16)):
        pool = native.NativePrefetcher(t1s, pets, (6, 6, 6), n_threads=threads, capacity=capacity)
        order = rng.integers(0, 12, 90)
        pool.submit(order[:40])
        seen = [pool.next() for _ in range(20)]
        pool.submit(order[40:])
        seen += [pool.next() for _ in range(70)]
        assert pool.next() == (-1, None) and pool.errors == 0  # drained, nothing dropped
        assert sorted(i for i, _ in seen) == sorted(order.tolist())
        for i, sample in seen:
            np.testing.assert_array_equal(sample, want[i])
        pool.close()
    for _ in range(200):  # pools closed while their workers wait or decode
        pool = native.NativePrefetcher(t1s, pets, (6, 6, 6), n_threads=2, capacity=2)
        pool.submit(range(12))
        pool.close()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Nine subjects of (12, 14, 10) int16 T1 and float32 PET, and a manifest with one covariate."""
    root = tmp_path_factory.mktemp("runtime_tree")
    rng = np.random.default_rng(2)
    rows = []
    for i in range(9):
        subj = f"s{i:02d}"
        t1, pet = (rng.random((12, 14, 10)) * 900).astype(np.int16), (rng.random((12, 14, 10)) * 3).astype(np.float32)
        write_raw(str(root / "t1" / subj / "2015-01-01" / "t1.nii.gz"), t1)
        write_raw(str(root / "pet" / subj / "2015-02-01" / "pet.nii.gz"), pet)
        rows.append(f"{subj},2015-01-01,2015-02-01,{60 + i}")
    (root / "m.csv").write_text("Subject,T1_date,PET_date,Age\n" + "\n".join(rows) + "\n")
    return root


def _dataset(root, **kw):
    return PairedVolumeDataset(str(root / "m.csv"), pet_dir=str(root / "pet"), t1_dir=str(root / "t1"),
                               crop_size=CROP, need_values=["Age"], min_and_max={"Age": (50, 90)}, **kw)


def _synchronous(ds, epoch, node_batch, rank, ranks, seed=4):
    """The synchronous path's batches, worked out here: the shuffled order, the
    node batch's corners drawn in order (from the dataset's generator, which
    runs on across epochs), this rank's rows, each sample read alone."""
    order = np.arange(len(ds))
    np.random.default_rng(seed + epoch).shuffle(order)
    batches = []
    for b in range(0, len(order) - node_batch + 1, node_batch):
        idx = order[b:b + node_batch]
        corners = [ds.draw_corner() for _ in idx]
        rows = shard_rows(node_batch, rank, ranks)
        samples = [ds.load(int(i), c) for i, c in zip(idx[rows], corners[rows])]
        batches.append(({"t1": np.stack([s.t1 for s in samples])[..., None],
                         "pet": np.stack([s.pet for s in samples])[..., None],
                         "info": np.stack([s.info for s in samples])[:, None, :]},
                        [int(i) for i in idx[rows]], corners[rows]))
    return batches


@pytest.mark.parametrize("crop", [None, (6, 8, 4)], ids=["center", "random_crop"])
def test_streaming_epochs_through_the_pool_equal_the_synchronous_path(tree, crop):
    for rank in range(2):  # 2 ranks sharing a node batch of 4
        loader = StreamingLoader(_dataset(tree, random_crop_size=crop, seed=4), 4, seed=4, shard_index=rank,
                                 shard_count=2)
        reference = _dataset(tree, random_crop_size=crop, seed=4)
        for epoch in (0, 1):
            want = _synchronous(reference, epoch, 4, rank, 2)
            planned = list(StreamingLoader(_dataset(tree, random_crop_size=crop, seed=4), 4, seed=4,
                                           shard_index=rank, shard_count=2).plan(epoch)) if epoch == 0 else None
            got = list(loader.epoch(epoch))
            assert len(got) == len(want) == 2
            for g, (w, rows, corners) in zip(got, want):
                assert g.keys() == w.keys()
                for key in g:
                    assert g[key].dtype == np.float32
                    np.testing.assert_array_equal(g[key], w[key], err_msg=f"rank {rank} epoch {epoch} {key}")
            if planned is not None:
                assert [(r, c) for _, r, c in want] == planned  # the rows, their order and the corners
    assert len(loader.waits) == 4 and loader.decoded == 8
    # whole volumes match the numpy reader and the JAX package's dataset
    jax_ds = jax_dataset.PairedVolumeDataset(str(tree / "m.csv"), pet_dir=str(tree / "pet"), t1_dir=str(tree / "t1"),
                                             crop_size=CROP, need_values=["Age"], min_and_max={"Age": (50, 90)})
    if crop is None:
        batch = next(iter(StreamingLoader(_dataset(tree), 1, shuffle=False, drop_last=False).epoch(0)))
        np.testing.assert_array_equal(batch["t1"][0, ..., 0], _numpy_decode(_dataset(tree).paths[0][0], CROP, True))
        np.testing.assert_allclose(batch["pet"][0, ..., 0], jax_ds[0].pet, rtol=1e-6)
        np.testing.assert_allclose(batch["info"][0, 0], jax_ds[0].info, rtol=1e-6)


def test_a_sample_that_fails_is_skipped_with_a_warning(tree, tmp_path):
    ds = _dataset(tree)
    ds.paths[3] = (str(tmp_path / "gone.nii.gz"), ds.paths[3][1])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        batches = list(StreamingLoader(ds, 3, shuffle=False).epoch(0))
    assert [len(b["t1"]) for b in batches] == [3, 2, 3]  # sample 3 left out of the second batch
    assert any("skipping unreadable sample" in str(w.message) and "gone.nii.gz" in str(w.message) for w in caught)


def test_eval_loader_keeps_every_subject_in_order(tree):
    ds = _dataset(tree)
    got = [b["t1"][0, ..., 0] for b in StreamingLoader(ds, 1, shuffle=False, drop_last=False).epoch(0)]
    assert len(got) == 9
    for i, vol in enumerate(got):
        np.testing.assert_array_equal(vol, ds[i].t1)


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "LIBRARY", str(tmp_path / "libcips_runtime.so"))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.build()
    monkeypatch.setattr(native, "CXX", "g++")
    good = native.SOURCE
    broken = tmp_path / "broken.cpp"
    broken.write_text("int cips_nifti_decode( {\n")
    monkeypatch.setattr(native, "SOURCE", str(broken))
    with pytest.raises(RuntimeError, match="failed"):
        native.build()
    assert os.listdir(tmp_path) == ["broken.cpp", "libcips_runtime.so.lock"]  # nothing half-written left behind
    monkeypatch.setattr(native, "SOURCE", good)
    assert native.build() == native.LIBRARY and os.path.exists(native.LIBRARY)  # a good build goes into place
