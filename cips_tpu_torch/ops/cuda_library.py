"""The port's CUDA kernel library: every `csrc/*.cu` built by nvcc for sm_90a into
one shared library with a plain C interface, at first use, and loaded with ctypes.

Each op module declares the C entry points it calls (`load`) and checks their
return code (`check`); this module knows how the library is built and where it
lives (`build/cips_tpu_torch/`, which `.gitignore` lists).
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import shutil
import subprocess
import time
from typing import Dict, Sequence

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), "build", "cips_tpu_torch")
LIBRARY = os.path.join(BUILD_DIR, "libcips_kernels.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _dependencies() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def build(verbose: bool = False) -> str:
    """Compile the kernel library if it is missing or older than any source in
    `csrc/`; returns its path. One nvcc per `.cu` file runs at once, then one
    link. ``verbose`` prints nvcc's register/shared-memory report and when each
    compile ended."""
    deps = _dependencies()
    if os.path.exists(LIBRARY) and os.path.getmtime(LIBRARY) >= max(os.path.getmtime(p) for p in deps):
        return LIBRARY
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    start = time.perf_counter()
    jobs = []
    for src in (p for p in deps if p.endswith(".cu")):
        stem = os.path.join(BUILD_DIR, os.path.splitext(os.path.basename(src))[0])
        log = open(f"{stem}.{tag}.log", "w+", encoding="utf-8")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", f"{stem}.{tag}.o", src]
        jobs.append((src, f"{stem}.{tag}.o", log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    reports, failed = [], []
    for src, _, log, proc in jobs:
        rc = proc.wait()
        log.seek(0)
        text = log.read().strip()
        log.close()
        os.remove(log.name)
        reports.append(f"{os.path.basename(src)} (nvcc done {time.perf_counter() - start:.1f} s after start):\n{text}")
        if rc != 0:
            failed.append(f"nvcc failed on {src} ({rc}):\n{text}")
    if failed:
        raise RuntimeError("\n".join(failed))
    if verbose:
        print("\n".join(reports))
    tmp = f"{LIBRARY}.{tag}"
    objects = [obj for _, obj, _, _ in jobs]
    proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objects], capture_output=True, text=True, check=False)
    for obj in objects:
        os.remove(obj)
    if proc.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


@functools.cache
def _handle() -> ctypes.CDLL:
    return ctypes.CDLL(build())


def load(signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The library (built first if needed), with ``signatures`` (entry point ->
    argtypes) declared; every entry point returns an int CUDA error code."""
    lib = _handle()
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raises if the C entry point ``name`` returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
