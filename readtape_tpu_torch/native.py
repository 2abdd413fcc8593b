"""The native host scan (``tape_scan`` of native/readtape_io.cpp) for the
port's segmentation, through ctypes.

At first use ``g++`` compiles native/readtape_io.cpp into
``build/torch_native/<hash of the source>/`` next to the package (never
into ``native/``). Without ``g++``, or if the build fails, ``tape_scan``
returns None and ``segment.host_activity`` runs its numpy sweep instead;
both give the same activity mask and height estimate.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "readtape_io.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_native")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


@functools.lru_cache(maxsize=None)
def _load():
    """The loaded library, or None when it cannot be built here."""
    gxx = shutil.which("g++")
    if gxx is None or not os.path.exists(SOURCE):
        return None
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + f.read())
    out_dir = os.path.join(BUILD_DIR, h.hexdigest()[:16])
    lib_path = os.path.join(out_dir, "libreadtape_io.so")
    if not os.path.exists(lib_path):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        r = subprocess.run([gxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                           capture_output=True, timeout=300)
        if r.returncode != 0:
            return None
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    lib.tape_scan.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.tape_scan.restype = None
    return lib


def available() -> bool:
    return _load() is not None


def tape_scan(samples: np.ndarray, step: int):
    """One native pass over an int16 [N, T] tape: (chunk_max int32
    [N//16] = max |x| over each 16-row chunk and all tracks, sub int32
    [ceil(N/step)*T] = |x| of every step-th row). Returns None if the
    native library is unavailable."""
    lib = _load()
    if lib is None or samples.dtype != np.int16 or samples.ndim != 2:
        return None
    samples = np.ascontiguousarray(samples)
    n, t = samples.shape
    chunk_max = np.empty(n // 16, np.int32)
    sub = np.empty(-(-n // step) * t, np.int32)
    lib.tape_scan(
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ctypes.c_int64(n), ctypes.c_int32(t), ctypes.c_int64(step),
        chunk_max.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        sub.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return chunk_max, sub
