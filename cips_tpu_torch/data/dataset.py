"""Paired T1/PET volume dataset, the packed-array store and the two batch
loaders, the latent dataset, and the MCI classifier's dataset, store and
loader (port of the NIfTI-backed datasets, `pack_pairs`, `PackedDataset`,
`BatchLoader`, `StreamingLoader`, `PairedLatentDataset`,
`MCIClassificationDataset`, `pack_mci`, `PackedMCIDataset` and
`MCIBatchLoader` in cips_tpu/data/dataset.py).

The trainers' default path decodes every pair once: `pack_pairs` writes a
memory-mapped float16 store (N, 2, D, H, W) and `BatchLoader` serves shuffled
batches from it, so training sees the fp16-rounded volumes, as the JAX
package's does. The store's files are the JAX package's, so a store packed by
either package loads in the other (the classifier's `pack_mci` store too).
`StreamingLoader` (``--streaming``) decodes the NIfTIs as it goes, through the
native prefetch pool (`runtime.native.NativePrefetcher`), in the synchronous
path's order, random crop included.

Every volume is decoded by the native runtime (`runtime.native.decode`: one
pass of decode, pad/crop and max-normalise); the numpy reader (`data.nifti`,
`pad_crop_np`, `max_normalize_np`) is the plain version the tests hold it to.
A runtime that does not build is an error: nothing falls back.

Across ranks (`cips_tpu_torch.parallel.mesh`) each loader takes JAX's
``process_index`` and ``process_count``, the node's place, and serves only this
rank's share of each node batch (``shard_index`` of ``shard_count``,
`parallel.mesh.shard_rows`), while it makes the random draws of the whole node
batch: every rank's rows are those of JAX's one-process loader.
"""

from __future__ import annotations

import collections
import csv
import json
import os
import time
import warnings
from dataclasses import dataclass
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from cips_tpu_torch.data.covariates import covariate_vector
from cips_tpu_torch.data.manifest import PairRow, read_manifest
from cips_tpu_torch.ops.resample import resize_trilinear
from cips_tpu_torch.parallel.mesh import shard_rows
from cips_tpu_torch.runtime import native

CROP_SIZE = (96, 128, 96)  # the working volume (reference train_unet.py:111)


def pad_crop_np(img: np.ndarray, target: Sequence[int]) -> np.ndarray:
    """Symmetric pad then center crop (MONAI SpatialPad + CenterSpatialCrop)."""
    pads = []
    for cur, tgt in zip(img.shape, target):
        total = max(tgt - cur, 0)
        pads.append((total // 2, total - total // 2))
    img = np.pad(img, pads)
    slices = []
    for cur, tgt in zip(img.shape, target):
        start = (cur - tgt) // 2
        slices.append(slice(start, start + tgt))
    return img[tuple(slices)]


def max_normalize_np(img: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    return img / max(float(img.max()), eps)


def _first_file(folder: str) -> Optional[str]:
    if not os.path.isdir(folder):
        return None
    for e in sorted(os.listdir(folder)):
        p = os.path.join(folder, e)
        if os.path.isfile(p):
            return p
    return None


def _load(
    path: str, crop_size: Sequence[int], normalize: bool = True, resize_size: Optional[Sequence[int]] = None
) -> np.ndarray:
    """Decode and pad/center-crop to ``crop_size`` (the native runtime), linearly
    resize to ``resize_size`` (the reference's optional MONAI Resize,
    dataset.py:88-90; on the host, as `ops.resample.resize_trilinear` computes
    it) and (``normalize``) max-normalise."""
    if resize_size is None:
        return native.decode(path, crop_size, normalize=normalize)
    vol = native.decode(path, crop_size, normalize=False)
    vol = resize_trilinear(torch.from_numpy(vol), resize_size).numpy()
    return max_normalize_np(vol) if normalize else vol


@dataclass
class Sample:
    t1: np.ndarray  # (D, H, W) float32, max-normalised
    pet: np.ndarray  # (D, H, W) float32, max-normalised
    info: np.ndarray  # (K,) float32 covariates (possibly empty)
    subject: str
    t1_date: str
    pet_date: str


class PairedVolumeDataset:
    """CSV-driven paired T1/PET dataset (the reference's pair_PET_T1dataset contract).

    Scans {dir}/{Subject}/{date}/ and takes the first file of each; skips
    rows whose directories are missing. Volumes are padded/center-cropped to
    ``crop_size``, resized to ``resize_size`` when given, and max-normalised. With ``random_crop_size``, the training
    augmentation (RandSpatialCrop, random centre): T1 and PET are cut at one
    corner drawn per axis from ``np.random.default_rng(seed)``, in the order
    the samples are read, then each is max-normalised.
    """

    def __init__(
        self,
        info_csv: str,
        pet_dir: str,
        t1_dir: str,
        crop_size: Sequence[int] = CROP_SIZE,
        need_values: Sequence[str] = (),
        min_and_max: Optional[Mapping[str, Tuple[float, float]]] = None,
        resize_size: Optional[Sequence[int]] = None,
        random_crop_size: Optional[Sequence[int]] = None,
        seed: int = 0,
    ):
        self.crop_size = tuple(crop_size)
        self.resize_size = tuple(resize_size) if resize_size else None
        self.random_crop_size = tuple(random_crop_size) if random_crop_size else None
        self._crop_rng = np.random.default_rng(seed)
        self.need_values = list(need_values)
        self.min_and_max = dict(min_and_max or {})
        self.rows: List[PairRow] = []
        self.paths: List[Tuple[str, str]] = []
        for row in read_manifest(info_csv):
            t1_path = _first_file(os.path.join(t1_dir, row.subject, row.t1_date))
            pet_path = _first_file(os.path.join(pet_dir, row.subject, row.pet_date))
            if t1_path is None or pet_path is None:
                continue
            self.rows.append(row)
            self.paths.append((t1_path, pet_path))

    def __len__(self) -> int:
        return len(self.rows)

    def draw_corner(self) -> Optional[List[int]]:
        """The next random crop's corner from the dataset's generator (None
        without ``random_crop_size``): the draw that reading a sample makes."""
        if self.random_crop_size is None:
            return None
        shape = self.resize_size or self.crop_size
        return [int(self._crop_rng.integers(0, c - r + 1)) for c, r in zip(shape, self.random_crop_size)]

    def __getitem__(self, index: int) -> Sample:
        return self.load(index, self.draw_corner())

    def load(self, index: int, corner: Optional[Sequence[int]] = None) -> Sample:
        """Sample ``index``, cut at ``corner`` when the dataset crops at random
        (a corner from `draw_corner`)."""
        t1, pet = (self.finish(native.decode(path, self.crop_size, normalize=self.decode_normalizes), corner)
                   for path in self.paths[index])
        row = self.rows[index]
        return Sample(t1, pet, self.info(index), row.subject, row.t1_date, row.pet_date)

    @property
    def decode_normalizes(self) -> bool:
        """Whether a volume is max-normalised as it is decoded: without a resize
        or a random crop, which normalise after them (`finish`)."""
        return self.resize_size is None and self.random_crop_size is None

    def finish(self, vol: np.ndarray, corner: Optional[Sequence[int]] = None) -> np.ndarray:
        """A volume decoded at ``crop_size`` (normalised when `decode_normalizes`)
        as the sample holds it: resized, cut at ``corner`` and max-normalised."""
        if self.resize_size is not None:
            vol = resize_trilinear(torch.from_numpy(vol), self.resize_size).numpy()
        if self.random_crop_size is not None:
            window = tuple(slice(o, o + r) for o, r in zip(corner, self.random_crop_size))
            vol = np.ascontiguousarray(vol[window])
        return vol if self.decode_normalizes else max_normalize_np(vol)

    def info(self, index: int) -> np.ndarray:
        """Sample ``index``'s covariate row (K,), empty without ``need_values``."""
        if self.need_values:
            return covariate_vector(self.rows[index], self.need_values, self.min_and_max)
        return np.zeros((0,), np.float32)


class StreamingLoader:
    """Epoch iterator that decodes the dataset's NIfTIs as it goes, through the
    native prefetch pool.

    The order is the JAX package's synchronous one: ``np.random.default_rng(seed
    + epoch)`` shuffles the indices (when ``shuffle``), node ``process_index`` of
    ``process_count`` takes every ``process_count``-th of them, ``drop_last``
    drops a short last batch. A random-cropping dataset draws the corners of the
    whole node batch in order; this rank decodes only its share of the rows
    (``shard_index`` of ``shard_count``). Yields numpy batches {"t1": (B, D, H,
    W, 1), "pet": (B, D, H, W, 1), "info": (B, 1, K)}.

    Each epoch starts a `runtime.native.NativePrefetcher` of ``n_threads``
    threads (closed when the epoch ends or is left) and keeps up to
    max(2 batch, 8) of this rank's samples submitted ahead, whole batches at a
    time, so the next batches decode while a step runs. The pool hands samples
    back as they finish; the loader holds early ones until their
    turn, so every batch holds the rows, order and crop corners of the
    synchronous path (`PairedVolumeDataset.load`) whatever the threads' timing.
    A sample whose decode fails is left out of its batch with a warning (a batch
    left empty is skipped). A batch's corners are drawn when it is submitted, so
    an epoch left before its end has drawn those of the batches already given
    to the pool. ``waits`` holds, for each batch served, the seconds the loader
    waited for the pool; ``decoded`` counts the samples it handed back.
    """

    def __init__(
        self,
        dataset: PairedVolumeDataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        shard_index: int = 0,
        shard_count: int = 1,
        n_threads: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.n_threads = n_threads
        self.capacity = max(2 * batch_size, 8)
        self.waits: List[float] = []
        self.decoded = 0

    def plan(self, epoch: int) -> Iterator[Tuple[List[int], List[Optional[List[int]]]]]:
        """Each batch's (this rank's indices, their crop corners), drawing the
        corners of the node batch as the batch is planned."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        order = order[self.process_index :: self.process_count]
        for b in range(0, len(order), self.batch_size):
            idx = order[b : b + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            corners = [self.dataset.draw_corner() for _ in idx]
            rows = shard_rows(len(idx), self.shard_index, self.shard_count)
            yield [int(i) for i in idx[rows]], corners[rows]

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        ds = self.dataset
        plan = self.plan(epoch)
        pool = native.NativePrefetcher([p[0] for p in ds.paths], [p[1] for p in ds.paths], ds.crop_size,
                                       normalize=ds.decode_normalizes, n_threads=self.n_threads,
                                       capacity=self.capacity)
        try:
            submitted: collections.deque = collections.deque()
            ahead = 0  # samples submitted and not yet taken
            held: Dict[int, Optional[np.ndarray]] = {}

            def top_up() -> None:
                nonlocal ahead
                while ahead < self.capacity:
                    planned = next(plan, None)
                    if planned is None:
                        return
                    submitted.append(planned)
                    pool.submit(planned[0])
                    ahead += len(planned[0])

            top_up()
            while submitted:
                idx, corners = submitted.popleft()
                t0 = time.perf_counter()
                for i in idx:
                    while i not in held:
                        j, sample = pool.next()
                        if j < 0:
                            raise RuntimeError(f"the prefetch pool drained before sample {i} came back")
                        held[j] = sample
                self.waits.append(time.perf_counter() - t0)
                ahead -= len(idx)
                samples = [(i, held.pop(i), c) for i, c in zip(idx, corners)]
                top_up()
                kept = []
                for i, vols, corner in samples:
                    if vols is None:
                        warnings.warn(f"skipping unreadable sample {ds.paths[i]}")
                        continue
                    self.decoded += 1
                    kept.append((i, ds.finish(vols[0], corner), ds.finish(vols[1], corner)))
                if not kept:
                    continue
                yield {"t1": np.stack([t1 for _, t1, _ in kept])[..., None],
                       "pet": np.stack([pet for _, _, pet in kept])[..., None],
                       "info": np.stack([ds.info(i) for i, _, _ in kept])[:, None, :]}
        finally:
            pool.close()


class PairedLatentDataset:
    """T1 volumes paired with precomputed PET latents stored as .npy (the
    reference's pair_PETlatent_T1_dataset; what `cli.gen_latents` writes:
    ``{latent_dir}/{Subject}/{pet_date}/{latent_name}``). Rows without a T1
    folder or a latent file are skipped. Each sample is (t1 (D, H, W) float32,
    padded/center-cropped to ``crop_size`` and max-normalised; the latent as
    saved; info (K,); subject; t1_date; pet_date)."""

    def __init__(
        self,
        info_csv: str,
        latent_dir: str,
        t1_dir: str,
        crop_size: Sequence[int] = CROP_SIZE,
        need_values: Sequence[str] = (),
        min_and_max: Optional[Mapping[str, Tuple[float, float]]] = None,
        latent_name: str = "latent.npy",
    ):
        self.crop_size = tuple(crop_size)
        self.need_values = list(need_values)
        self.min_and_max = dict(min_and_max or {})
        self.rows: List[PairRow] = []
        self.paths: List[Tuple[str, str]] = []
        for row in read_manifest(info_csv):
            t1_path = _first_file(os.path.join(t1_dir, row.subject, row.t1_date))
            latent_path = os.path.join(latent_dir, row.subject, row.pet_date, latent_name)
            if t1_path is None or not os.path.isfile(latent_path):
                continue
            self.rows.append(row)
            self.paths.append((t1_path, latent_path))

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, index: int):
        row = self.rows[index]
        t1_path, latent_path = self.paths[index]
        if self.need_values:
            info = covariate_vector(row, self.need_values, self.min_and_max)
        else:
            info = np.zeros((0,), np.float32)
        return _load(t1_path, self.crop_size), np.load(latent_path), info, row.subject, row.t1_date, row.pet_date


def pack_pairs(dataset: PairedVolumeDataset, out_dir: str, dtype=np.float16) -> str:
    """Decode and preprocess every pair once into memory-mapped arrays.

    Writes volumes.npy (N, 2, D, H, W) in ``dtype`` (T1 then PET), covariates.npy
    (N, K) float32 and index.json (the covariate names and each row's subject
    and dates). Returns ``out_dir``.
    """
    os.makedirs(out_dir, exist_ok=True)
    n = len(dataset)
    d, h, w = dataset.crop_size
    k = len(dataset.need_values)
    vols = np.lib.format.open_memmap(
        os.path.join(out_dir, "volumes.npy"), mode="w+", dtype=dtype, shape=(n, 2, d, h, w)
    )
    covs = np.zeros((n, k), np.float32)
    index = []
    for i in range(n):
        s = dataset[i]
        vols[i, 0] = s.t1.astype(dtype)
        vols[i, 1] = s.pet.astype(dtype)
        if k:
            covs[i] = s.info
        index.append({"subject": s.subject, "t1_date": s.t1_date, "pet_date": s.pet_date})
    vols.flush()
    np.save(os.path.join(out_dir, "covariates.npy"), covs)
    with open(os.path.join(out_dir, "index.json"), "w", encoding="utf-8") as f:
        json.dump({"need_values": dataset.need_values, "rows": index}, f)
    return out_dir


class PackedDataset:
    """The memory-mapped pairs that `pack_pairs` wrote."""

    def __init__(self, path: str):
        self.volumes = np.load(os.path.join(path, "volumes.npy"), mmap_mode="r")
        self.covariates = np.load(os.path.join(path, "covariates.npy"))
        with open(os.path.join(path, "index.json"), encoding="utf-8") as f:
            meta = json.load(f)
        self.need_values = meta["need_values"]
        self.index = meta["rows"]

    def __len__(self) -> int:
        return self.volumes.shape[0]


class BatchLoader:
    """Shuffled epoch iterator over a `PackedDataset`, sliced per node.

    The JAX package's order and values: ``np.random.default_rng(seed + epoch)``
    shuffles the indices (when ``shuffle``), node ``process_index`` of
    ``process_count`` takes every ``process_count``-th of them, ``drop_last``
    drops a short last batch, and each batch is read from the store in sorted
    index order (covariates sorted the same way) and widened to float32. With
    ``random_crop_size``, each sample is cut at a random offset drawn from the
    same generator, T1 and PET jointly, and each modality is re-max-normalised;
    the offsets of the whole node batch are drawn. This rank reads only its
    share of each batch's rows (``shard_index`` of ``shard_count``). Yields
    numpy batches {"t1": (B, D, H, W, 1), "pet": (B, D, H, W, 1),
    "info": (B, 1, K)}.
    """

    def __init__(
        self,
        packed: PackedDataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        random_crop_size: Optional[Sequence[int]] = None,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        self.packed = packed
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.random_crop_size = tuple(random_crop_size) if random_crop_size else None
        self.shard_index = shard_index
        self.shard_count = shard_count

    def _offsets(self, n: int, rng: np.random.Generator) -> List[List[int]]:
        """The crop offsets of ``n`` samples, drawn sample by sample, axis by axis."""
        return [[int(rng.integers(0, c - r + 1)) for c, r in zip(self.packed.volumes.shape[2:], self.random_crop_size)]
                for _ in range(n)]

    def _crop(self, vols: np.ndarray, offsets: Sequence[Sequence[int]]) -> np.ndarray:
        rcs = self.random_crop_size
        out = np.empty((vols.shape[0], 2, *rcs), np.float32)
        for i in range(vols.shape[0]):
            crop = vols[(i, slice(None)) + tuple(slice(o, o + r) for o, r in zip(offsets[i], rcs))]
            for m in range(2):
                peak = crop[m].max()
                out[i, m] = crop[m] / peak if peak > 0 else crop[m]
        return out

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.packed))
        rng = np.random.default_rng(self.seed + epoch)
        if self.shuffle:
            rng.shuffle(order)
        order = order[self.process_index :: self.process_count]
        num_batches = len(order) // self.batch_size
        if not self.drop_last and len(order) % self.batch_size:
            num_batches += 1
        for b in range(num_batches):
            idx = np.sort(order[b * self.batch_size : (b + 1) * self.batch_size])
            rows = shard_rows(len(idx), self.shard_index, self.shard_count)
            offsets = self._offsets(len(idx), rng) if self.random_crop_size is not None else None
            idx = idx[rows]
            vols = self.packed.volumes[idx].astype(np.float32)
            if offsets is not None:
                vols = self._crop(vols, offsets[rows])
            yield {"t1": vols[:, 0][..., None], "pet": vols[:, 1][..., None],
                   "info": self.packed.covariates[idx][:, None, :]}

    def steps_per_epoch(self) -> int:
        n = len(self.packed) // self.process_count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)


class MCIClassificationDataset:
    """PET and/or T1 channels, covariates and the binary MCI_converter label of
    each session (the reference's pair_MRI_dataset_only_mci contract).

    Sessions of subjects missing from ``converter_csv`` are dropped, and so are
    a converter's scans on or after its conversion date. ``pet_name``
    ("rec.nii.gz") reads synthesized PET instead of the first file of each PET
    folder. ABETA is inverted after its min-max normalisation. Each sample is
    (imgs (D, H, W, C) channels-last float32, PET first; info (K,); label;
    subject; pet_date; t1_date).
    """

    def __init__(
        self,
        info_csv: str,
        converter_csv: str,
        pet_dir: str,
        t1_dir: str,
        crop_size: Sequence[int] = CROP_SIZE,
        need_values: Sequence[str] = (),
        min_and_max: Optional[Mapping[str, Tuple[float, float]]] = None,
        use_pet: bool = True,
        use_t1: bool = True,
        pet_name: Optional[str] = None,
    ):
        self.crop_size = tuple(crop_size)
        self.need_values = list(need_values)
        self.min_and_max = dict(min_and_max or {})
        self.use_pet = use_pet
        self.use_t1 = use_t1
        self.pet_name = pet_name
        with open(converter_csv, newline="", encoding="utf-8") as f:
            reader = csv.DictReader(f)
            key = reader.fieldnames[0]
            converters = {rec[key]: rec for rec in reader}
        self.rows: List[PairRow] = []
        self.paths: List[Tuple[Optional[str], Optional[str]]] = []
        self.labels: List[int] = []
        for row in read_manifest(info_csv):
            conv = converters.get(row.subject)
            if conv is None:
                continue
            label = int(float(conv.get("MCI_converter", 0) or 0))
            if label == 1 and row.pet_date >= conv.get("Converter_date", "9999"):
                continue  # a converter's scans from its conversion on
            pet_folder = os.path.join(pet_dir, row.subject, row.pet_date)
            pet_path = os.path.join(pet_folder, pet_name) if pet_name else _first_file(pet_folder)
            t1_path = _first_file(os.path.join(t1_dir, row.subject, row.t1_date))
            if use_pet and (pet_path is None or not os.path.isfile(pet_path)):
                continue
            if use_t1 and t1_path is None:
                continue
            self.rows.append(row)
            self.paths.append((pet_path, t1_path))
            self.labels.append(label)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, index: int):
        row = self.rows[index]
        pet_path, t1_path = self.paths[index]
        channels = [_load(path, self.crop_size) for path, used in ((pet_path, self.use_pet), (t1_path, self.use_t1))
                    if used]
        if self.need_values:
            info = covariate_vector(row, self.need_values, self.min_and_max, invert_abeta=True)
        else:
            info = np.zeros((0,), np.float32)
        return np.stack(channels, axis=-1), info, self.labels[index], row.subject, row.pet_date, row.t1_date


def pack_mci(dataset: MCIClassificationDataset, out_dir: str, dtype=np.float16) -> str:
    """Decode and preprocess every classification session once into memory-mapped
    arrays: volumes.npy (N, D, H, W, C) in ``dtype``, covariates.npy (N, K)
    float32, labels.npy (N,) int32 and index.json (the covariate names, the
    rows, and ``pet_source``, "fake" for synthesized PET else "real", so that a
    run never evaluates a store of the other kind). Returns ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(dataset)
    c = int(dataset.use_pet) + int(dataset.use_t1)
    k = len(dataset.need_values)
    vols = np.lib.format.open_memmap(
        os.path.join(out_dir, "volumes.npy"), mode="w+", dtype=dtype, shape=(n, *dataset.crop_size, c)
    )
    covs = np.zeros((n, k), np.float32)
    labels = np.zeros((n,), np.int32)
    index = []
    for i in range(n):
        imgs, info, label, subject, pet_date, t1_date = dataset[i]
        vols[i] = imgs.astype(dtype)
        if k:
            covs[i] = info
        labels[i] = label
        index.append({"subject": subject, "pet_date": pet_date, "t1_date": t1_date})
    vols.flush()
    np.save(os.path.join(out_dir, "covariates.npy"), covs)
    np.save(os.path.join(out_dir, "labels.npy"), labels)
    with open(os.path.join(out_dir, "index.json"), "w", encoding="utf-8") as f:
        json.dump({"need_values": dataset.need_values, "pet_source": "fake" if dataset.pet_name else "real",
                   "rows": index}, f)
    return out_dir


class PackedMCIDataset:
    """The memory-mapped sessions that `pack_mci` wrote; ``pet_source`` is None
    for a store written before the field existed."""

    def __init__(self, path: str):
        self.volumes = np.load(os.path.join(path, "volumes.npy"), mmap_mode="r")
        self.covariates = np.load(os.path.join(path, "covariates.npy"))
        self.labels = np.load(os.path.join(path, "labels.npy"))
        with open(os.path.join(path, "index.json"), encoding="utf-8") as f:
            meta = json.load(f)
        self.need_values = meta["need_values"]
        self.pet_source = meta.get("pet_source")
        self.index = meta["rows"]

    def __len__(self) -> int:
        return self.volumes.shape[0]


class MCIBatchLoader:
    """Shuffled epoch iterator over a `PackedMCIDataset` in the JAX package's order
    (as `BatchLoader`: node ``process_index`` of ``process_count``, this rank's
    share of each batch ``shard_index`` of ``shard_count``). Yields numpy
    batches {"imgs": (B, D, H, W, C) float32, "info": (B, 1, K), "labels": (B,) int32}."""

    def __init__(
        self,
        packed: PackedMCIDataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        self.packed = packed
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.shard_index = shard_index
        self.shard_count = shard_count

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.packed))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        order = order[self.process_index :: self.process_count]
        num_batches = len(order) // self.batch_size
        if not self.drop_last and len(order) % self.batch_size:
            num_batches += 1
        for b in range(num_batches):
            idx = np.sort(order[b * self.batch_size : (b + 1) * self.batch_size])
            idx = idx[shard_rows(len(idx), self.shard_index, self.shard_count)]
            yield {"imgs": self.packed.volumes[idx].astype(np.float32), "info": self.packed.covariates[idx][:, None, :],
                   "labels": self.packed.labels[idx]}

    def steps_per_epoch(self) -> int:
        n = len(self.packed) // self.process_count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)
