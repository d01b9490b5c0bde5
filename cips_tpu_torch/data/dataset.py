"""Paired T1/PET volume dataset, the packed-array store and the two batch
loaders, and the MCI classifier's dataset, store and loader (port of the
NIfTI-backed datasets, `pack_pairs`, `PackedDataset`, `BatchLoader`,
`StreamingLoader`, `MCIClassificationDataset`, `pack_mci`, `PackedMCIDataset`
and `MCIBatchLoader` in cips_tpu/data/dataset.py).

The trainers' default path decodes every pair once: `pack_pairs` writes a
memory-mapped float16 store (N, 2, D, H, W) and `BatchLoader` serves shuffled
batches from it, so training sees the fp16-rounded volumes, as the JAX
package's does. The store's files are the JAX package's, so a store packed by
either package loads in the other (the classifier's `pack_mci` store too).
`StreamingLoader` (``--streaming``) decodes the NIfTIs as it goes. Decoding is
the pure-numpy NIfTI reader; the JAX package's C++ decode runtime and its
prefetch pool are not ported yet, and there is no fallback between the two:
the port's streaming path is the JAX package's synchronous one, random crop
included (JAX's native prefetch pool decodes at ``crop_size`` and skips the
crop).

Across ranks (`cips_tpu_torch.parallel.mesh`) each loader takes JAX's
``process_index`` and ``process_count``, the node's place, and serves only this
rank's share of each node batch (``shard_index`` of ``shard_count``,
`parallel.mesh.shard_rows`), while it makes the random draws of the whole node
batch: every rank's rows are those of JAX's one-process loader.
"""

from __future__ import annotations

import csv
import json
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from cips_tpu_torch.data import nifti
from cips_tpu_torch.data.covariates import covariate_vector
from cips_tpu_torch.data.manifest import PairRow, read_manifest
from cips_tpu_torch.ops.resample import resize_trilinear
from cips_tpu_torch.parallel.mesh import shard_rows

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
    """Decode, pad/center-crop to ``crop_size``, linearly resize to ``resize_size``
    (the reference's optional MONAI Resize, dataset.py:88-90; on the host, as
    `ops.resample.resize_trilinear` computes it) and (``normalize``) max-normalise."""
    vol = pad_crop_np(nifti.read_array(path).astype(np.float32), crop_size)
    if resize_size is not None:
        vol = resize_trilinear(torch.from_numpy(np.ascontiguousarray(vol)), resize_size).numpy()
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
        row = self.rows[index]
        t1, pet = (_load(path, self.crop_size, normalize=self.random_crop_size is None, resize_size=self.resize_size)
                   for path in self.paths[index])
        if self.random_crop_size is not None:
            window = tuple(slice(o, o + r) for o, r in zip(corner, self.random_crop_size))
            t1, pet = (max_normalize_np(np.ascontiguousarray(v[window])) for v in (t1, pet))
        if self.need_values:
            info = covariate_vector(row, self.need_values, self.min_and_max)
        else:
            info = np.zeros((0,), np.float32)
        return Sample(t1, pet, info, row.subject, row.t1_date, row.pet_date)


class StreamingLoader:
    """Epoch iterator that decodes the dataset's NIfTIs as it goes.

    The order is the JAX package's: ``np.random.default_rng(seed + epoch)``
    shuffles the indices (when ``shuffle``), node ``process_index`` of
    ``process_count`` takes every ``process_count``-th of them, ``drop_last``
    drops a short last batch. A random-cropping dataset draws the corners of
    the whole node batch in order; this rank decodes only its share of the rows
    (``shard_index`` of ``shard_count``). Yields numpy batches {"t1": (B, D, H,
    W, 1), "pet": (B, D, H, W, 1), "info": (B, 1, K)}.
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

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
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
            samples = [self.dataset.load(int(i), c) for i, c in zip(idx[rows], corners[rows])]
            yield {
                "t1": np.stack([s.t1 for s in samples])[..., None],
                "pet": np.stack([s.pet for s in samples])[..., None],
                "info": np.stack([s.info for s in samples])[:, None, :],
            }


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
