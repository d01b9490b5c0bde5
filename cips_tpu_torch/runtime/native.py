"""ctypes bindings and build of the native C++ data-loading runtime (port of
cips_tpu/runtime/native.py).

`build` compiles ``nifti_loader.cpp`` with g++ into
``build/cips_tpu_torch/libcips_runtime.so`` at the repo root (listed in
``.gitignore``) when the library is missing or older than its source: under a
file lock, into a temporary name that `os.replace` puts in place, so
processes that start together (xdist workers, torchrun's ranks) never load a
half-written library. A failed build raises with g++'s output; nothing falls
back to the numpy reader. The library does not depend on the host that built
it (no ``-march=native``).

`decode` reads one NIfTI-1 file into a padded, center-cropped and (by default)
max-normalised (z, y, x) float32 array in one pass; `nifti_shape` reads the
header only; `NativePrefetcher` decodes (t1, pet) pairs on worker threads and
hands them back in the order they finish (`data.dataset.StreamingLoader`
restores its own order).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import os
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "nifti_loader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), "build", "cips_tpu_torch")
LIBRARY = os.path.join(BUILD_DIR, "libcips_runtime.so")
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
LINK = ("-lz", "-lpthread")

def _fresh(library: str) -> bool:
    return os.path.exists(library) and os.path.getmtime(library) >= os.path.getmtime(SOURCE)


@contextlib.contextmanager
def _locked(path: str):
    with open(path, "a+", encoding="utf-8") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def build(force: bool = False) -> str:
    """Compile the runtime if it is missing or older than its source (or
    ``force``); returns the library's path. Raises RuntimeError with g++'s
    output when the compiler is missing or fails."""
    if not force and _fresh(LIBRARY):
        return LIBRARY
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _locked(LIBRARY + ".lock"):
        if not force and _fresh(LIBRARY):  # another process built it while we waited
            return LIBRARY
        tmp = f"{LIBRARY}.{os.getpid()}.tmp"
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, SOURCE, *LINK], capture_output=True, text=True,
                                  check=False)
        except OSError as err:
            raise RuntimeError(f"building the NIfTI runtime: cannot run {CXX!r}: {err}") from err
        if proc.returncode != 0:
            with contextlib.suppress(FileNotFoundError):
                os.remove(tmp)
            raise RuntimeError(f"building the NIfTI runtime failed ({CXX} exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, LIBRARY)
    return LIBRARY


@functools.cache
def load() -> ctypes.CDLL:
    """The runtime (built first if needed) with its entry points declared."""
    lib = ctypes.CDLL(build())
    i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
    signatures = {
        "cips_nifti_decode": (ctypes.c_int, [ctypes.c_char_p, f32p, i64, i64, i64, ctypes.c_int]),
        "cips_nifti_shape": (ctypes.c_int, [ctypes.c_char_p, ctypes.POINTER(i64)]),
        "cips_prefetcher_create": (ctypes.c_void_p, [ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
                                                     i64, i64, i64, i64, ctypes.c_int, ctypes.c_int, i64]),
        "cips_prefetcher_submit": (None, [ctypes.c_void_p, ctypes.POINTER(i64), i64]),
        "cips_prefetcher_next": (i64, [ctypes.c_void_p, f32p]),
        "cips_prefetcher_errors": (i64, [ctypes.c_void_p]),
        "cips_prefetcher_destroy": (None, [ctypes.c_void_p]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _floats(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode(path: str, shape: Sequence[int], normalize: bool = True) -> np.ndarray:
    """One NIfTI-1 file as a (z, y, x) float32 array of ``shape``: padded
    symmetrically and center-cropped (MONAI SpatialPad + CenterSpatialCrop)
    and, with ``normalize``, divided by its maximum when that is positive.
    Raises IOError when the file cannot be read or parsed."""
    out = np.empty(tuple(int(s) for s in shape), np.float32)
    if load().cips_nifti_decode(os.fsencode(path), _floats(out), *out.shape, int(normalize)) != 0:
        raise IOError(f"native NIfTI decode failed: {path}")
    return out


def nifti_shape(path: str) -> Tuple[int, int, int]:
    """The (z, y, x) size in a NIfTI-1 header, without decoding the voxels."""
    zyx = (ctypes.c_int64 * 3)()
    if load().cips_nifti_shape(os.fsencode(path), zyx) != 0:
        raise IOError(f"native NIfTI header parse failed: {path}")
    return (zyx[0], zyx[1], zyx[2])


class NativePrefetcher:
    """Background decode of (t1, pet) path pairs into (2, z, y, x) float32
    samples on ``n_threads`` threads, at most ``capacity`` decoded samples
    waiting. Indices are decoded in the order they are submitted and come
    back in the order their decodes finish."""

    def __init__(
        self,
        t1_paths: Sequence[str],
        pet_paths: Sequence[str],
        shape: Sequence[int],
        normalize: bool = True,
        n_threads: int = 2,
        capacity: int = 8,
    ):
        if len(t1_paths) != len(pet_paths):
            raise ValueError(f"{len(t1_paths)} T1 paths but {len(pet_paths)} PET paths")
        self._lib = load()
        self._handle = None
        self.shape = tuple(int(s) for s in shape)
        n = len(t1_paths)
        self._t1 = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in t1_paths])
        self._pet = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in pet_paths])
        self._handle = self._lib.cips_prefetcher_create(self._t1, self._pet, n, *self.shape, int(normalize),
                                                        n_threads, capacity)
        if not self._handle:
            raise RuntimeError("failed to create the native prefetcher")

    def submit(self, indices: Sequence[int]) -> None:
        arr = (ctypes.c_int64 * len(indices))(*[int(i) for i in indices])
        self._lib.cips_prefetcher_submit(self._handle, arr, len(indices))

    def next(self) -> Tuple[int, Optional[np.ndarray]]:
        """(index, (2, z, y, x) sample), blocking until one is decoded;
        (index, None) when that sample's decode failed; (-1, None) when
        nothing is queued, in flight or ready."""
        out = np.empty((2,) + self.shape, np.float32)
        idx = int(self._lib.cips_prefetcher_next(self._handle, _floats(out)))
        if idx == -1:
            return -1, None
        if idx <= -2:  # -2 - index: that sample failed
            return -2 - idx, None
        return idx, out

    @property
    def errors(self) -> int:
        return int(self._lib.cips_prefetcher_errors(self._handle))

    def close(self) -> None:
        """Stops the workers (each ends its current decode) and frees what is queued."""
        if self._handle:
            self._lib.cips_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the library may be gone already
            pass
