"""The native host helpers of native/readtape_io.cpp for the port, through
ctypes: the CSV scanners (``csv_scan``, ``csv_scan_scanfast``,
``csv_deltat``, ``csv_free``) and the host activity scan (``tape_scan``).

At first use ``g++`` compiles native/readtape_io.cpp into
``build/torch_native/<hash of the source and flags>/`` next to the
package (never into ``native/``). The flags keep g++ from contracting
a multiply and an add into one fused multiply-add, since the scanfast
parser must round each step in float32 as the reference does. Without
``g++``, or if the build fails, ``tape_scan`` returns None and
``segment.host_activity`` runs its numpy sweep instead, and
``csv_scan_native`` raises, so that ``formats.csvfmt.read_csv`` and
``csvtbin`` use their numpy and Python readers; each pair gives the same
values.
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
CXX_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-fPIC", "-shared")


class _CsvScan(ctypes.Structure):
    _fields_ = [("first_time", ctypes.c_double),
                ("deltat", ctypes.c_double),
                ("nrows", ctypes.c_int64),
                ("ncols", ctypes.c_int32),
                ("volts", ctypes.POINTER(ctypes.c_float))]


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
    for name in ("csv_scan", "csv_scan_scanfast"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(_CsvScan)]
        fn.restype = ctypes.c_int
    lib.csv_deltat.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_double)]
    lib.csv_deltat.restype = ctypes.c_int
    lib.csv_free.argtypes = [ctypes.POINTER(_CsvScan)]
    lib.csv_free.restype = None
    return lib


def available() -> bool:
    return _load() is not None


def csv_scan_native(path: str, scanfast: bool = False):
    """Returns (first_time, deltat, volts [N, T] float32) of a CSV capture
    (two title lines, then "time, v0, v1, ..." rows). Raises if the
    native library is unavailable or the parse fails. scanfast=True reads
    the voltages with the float32 digit fold of the reference's
    scanfast_float (csvtbin.c:403-417), else each field is parsed in
    float64 and rounded to float32."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    scan = _CsvScan()
    fn = lib.csv_scan_scanfast if scanfast else lib.csv_scan
    rc = fn(os.fsencode(path), ctypes.byref(scan))
    if rc != 0:
        raise RuntimeError(f"csv_scan failed ({rc}) for {path}")
    try:
        buf = np.ctypeslib.as_array(scan.volts, shape=(scan.nrows,
                                                       scan.ncols))
        volts = np.array(buf, dtype=np.float32)     # copy before the free
    finally:
        lib.csv_free(ctypes.byref(scan))
    dt = ctypes.c_double()
    lib.csv_deltat(os.fsencode(path), ctypes.byref(dt))
    return float(scan.first_time), float(dt.value), volts


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
