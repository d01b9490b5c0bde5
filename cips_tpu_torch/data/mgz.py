"""FreeSurfer MGH/MGZ reader, pure numpy (the port's copy of cips_tpu/data/mgz.py).

The reference converts FastSurfer's `aseg.mgz` to NIfTI with FreeSurfer's
`mri_convert` before computing SUVR (proprocess/apply_surfurseg_to_PET.py:
119-121); this reader takes the .mgz directly.

MGH format: big-endian; a 284-byte header (version, width, height, depth,
nframes, type, dof, goodRASFlag, spacing and direction cosines), then the voxels
x-fastest. Types: 0 uint8, 1 int32, 3 float32, 4 int16.
"""

from __future__ import annotations

import gzip
import struct
from typing import Tuple

import numpy as np

_DATA_OFFSET = 284
_TYPES = {0: np.uint8, 1: np.dtype(">i4"), 3: np.dtype(">f4"), 4: np.dtype(">i2")}


def read_mgz(path: str) -> Tuple[np.ndarray, Tuple[float, float, float]]:
    """(volume, spacing); the volume is (z, y, x)[, frames] as in `data.nifti`."""
    opener = gzip.open if path.endswith((".mgz", ".gz")) else open
    with opener(path, "rb") as f:
        raw = f.read()
    version, width, height, depth, nframes, dtype_code, _dof = struct.unpack_from(">7i", raw, 0)
    if version != 1:
        raise ValueError(f"{path}: unsupported MGH version {version}")
    if dtype_code not in _TYPES:
        raise ValueError(f"{path}: unsupported MGH dtype code {dtype_code}")
    spacing = (1.0, 1.0, 1.0)
    if struct.unpack_from(">h", raw, 28)[0] > 0:  # goodRASFlag
        spacing = tuple(float(s) for s in struct.unpack_from(">3f", raw, 30))
    dt = np.dtype(_TYPES[dtype_code])
    data = np.frombuffer(raw, dtype=dt, count=width * height * depth * nframes, offset=_DATA_OFFSET)
    data = data.reshape(nframes, depth, height, width)  # stored [frame][z][y][x]
    if nframes == 1:
        data = data[0]
    return np.ascontiguousarray(data.astype(dt.newbyteorder("="))), spacing


def read_segmentation(path: str) -> np.ndarray:
    """A FastSurfer/FreeSurfer segmentation (.mgz or .nii[.gz]) as an int32 (z, y, x) label volume."""
    if path.endswith(".mgz"):
        vol, _ = read_mgz(path)
    else:
        from cips_tpu_torch.data import nifti

        vol = nifti.read_array(path)
    return np.asarray(vol, np.int32)
