"""Minimal NIfTI-1 reader/writer (pure numpy; .nii and .nii.gz).

The port's own copy of cips_tpu/data/nifti.py. Arrays follow the (z, y, x)
axis convention SimpleITK's GetArrayFromImage returns, so crop sizes like
(96, 128, 96) mean the same thing they do in the reference.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

_HDR_SIZE = 348
_MAGIC_OFFSET = 344

# nifti datatype code -> numpy dtype
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiImage:
    """Volume + geometry. ``data`` is (z, y, x)[, t] in sitk array order."""

    data: np.ndarray
    affine: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float64))
    spacing: Tuple[float, ...] = (1.0, 1.0, 1.0)  # (x, y, z) voxel mm

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.data.shape


def _open_maybe_gz(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read(path: str) -> NiftiImage:
    with _open_maybe_gz(path, "rb") as f:
        raw = f.read()
    hdr = raw[:_HDR_SIZE]
    sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
    endian = "<"
    if sizeof_hdr != _HDR_SIZE:
        endian = ">"
        sizeof_hdr = struct.unpack_from(">i", hdr, 0)[0]
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
    magic = hdr[_MAGIC_OFFSET:_MAGIC_OFFSET + 4]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack_from(endian + "8h", hdr, 40)
    ndim = dim[0]
    shape_xyz = tuple(int(d) for d in dim[1 : 1 + max(ndim, 3)])
    datatype = struct.unpack_from(endian + "h", hdr, 70)[0]
    pixdim = struct.unpack_from(endian + "8f", hdr, 76)
    vox_offset = int(struct.unpack_from(endian + "f", hdr, 108)[0])
    scl_slope = struct.unpack_from(endian + "f", hdr, 112)[0]
    scl_inter = struct.unpack_from(endian + "f", hdr, 116)[0]
    srow = np.array(
        [
            struct.unpack_from(endian + "4f", hdr, 280),
            struct.unpack_from(endian + "4f", hdr, 296),
            struct.unpack_from(endian + "4f", hdr, 312),
        ],
        dtype=np.float64,
    )
    qform_code = struct.unpack_from(endian + "h", hdr, 252)[0]
    sform_code = struct.unpack_from(endian + "h", hdr, 254)[0]
    quatern = struct.unpack_from(endian + "3f", hdr, 256)  # b, c, d
    qoffset = struct.unpack_from(endian + "3f", hdr, 268)  # x, y, z

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")
    np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    count = int(np.prod(shape_xyz))
    data = np.frombuffer(raw, dtype=np_dtype, count=count, offset=vox_offset)
    # nifti stores x-fastest (Fortran); reshape via reversed dims -> (t,)z,y,x
    data = data.reshape(tuple(reversed(shape_xyz)))

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter
    else:
        data = np.asarray(data)

    affine = np.eye(4, dtype=np.float64)
    if sform_code > 0:
        affine[:3, :] = srow
    elif qform_code > 0:
        # NIfTI-1 qform: unit quaternion (a, b, c, d) with a derived, qfac
        # in pixdim[0] flipping the k axis (real ADNI exports frequently
        # carry qform-only oblique geometry)
        b, c, d = (float(q) for q in quatern)
        a_sq = max(0.0, 1.0 - (b * b + c * c + d * d))
        a = float(np.sqrt(a_sq))
        rot = np.array(
            [
                [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
                [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
                [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
            ],
            dtype=np.float64,
        )
        qfac = -1.0 if pixdim[0] < 0 else 1.0
        affine[:3, :3] = rot @ np.diag([pixdim[1], pixdim[2], qfac * pixdim[3]])
        affine[:3, 3] = qoffset
    else:
        affine[0, 0], affine[1, 1], affine[2, 2] = pixdim[1], pixdim[2], pixdim[3]
    spacing = (float(pixdim[1] or 1.0), float(pixdim[2] or 1.0), float(pixdim[3] or 1.0))
    return NiftiImage(data=data, affine=affine, spacing=spacing)


def read_array(path: str) -> np.ndarray:
    """Volume data as (z, y, x); singleton leading (time/frame) axes of 4-D
    files are squeezed (some ADNI exports store 3-D volumes as (x, y, z, 1))."""
    data = read(path).data
    while data.ndim > 3 and data.shape[0] == 1:
        data = data[0]
    return data


def write(path: str, img: NiftiImage | np.ndarray) -> None:
    if isinstance(img, np.ndarray):
        img = NiftiImage(data=img)
    data = np.ascontiguousarray(img.data)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    datatype = _DTYPE_CODES[np.dtype(data.dtype)]
    bitpix = data.dtype.itemsize * 8

    shape_xyz = tuple(reversed(data.shape))
    ndim = len(shape_xyz)
    dim = [ndim] + list(shape_xyz) + [1] * (7 - ndim)

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, datatype)
    struct.pack_into("<h", hdr, 72, bitpix)
    pixdim = [1.0] + [float(s) for s in img.spacing[:3]] + [1.0] * 4
    struct.pack_into("<8f", hdr, 76, *pixdim[:8])
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform_code: unset (quaternion not encoded)
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    affine = np.asarray(img.affine, dtype=np.float64)
    struct.pack_into("<4f", hdr, 280, *affine[0, :])
    struct.pack_into("<4f", hdr, 296, *affine[1, :])
    struct.pack_into("<4f", hdr, 312, *affine[2, :])
    hdr[_MAGIC_OFFSET:_MAGIC_OFFSET + 4] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + data.tobytes(order="C")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with _open_maybe_gz(path, "wb") as f:
        f.write(payload)
