"""ctypes bindings for the native host library (C++/OpenMP).

Builds native/build/libgppe_native.so with ``make -C native`` every time it
is first loaded in a process (a no-op when it is up to date); falls back to
the pure-Python paths when a toolchain is unavailable. The native pieces
cover the reference's host-native roles
(reference: Cython/OpenMP assembly, _generate_sparse_correlation.pyx):
cell-binned tapered CSR construction at O(n k) with lock-free two-pass
parallelism.
"""

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")

_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libgppe_native.so")

_lib = None
_load_failed = False


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        import fcntl

        # one build at a time across processes (test workers start
        # together on a fresh checkout)
        with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        lib = ctypes.CDLL(_LIB_PATH)
        lib.gppe_taper_count.restype = ctypes.c_int64
        lib.gppe_taper_count.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int,
            ctypes.c_double, ctypes.POINTER(ctypes.c_int64)]
        lib.gppe_taper_fill.restype = ctypes.c_int32
        lib.gppe_taper_fill.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int,
            ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double)]
        lib.gppe_num_threads.restype = ctypes.c_int32
        _lib = lib
    except Exception:
        _load_failed = True
        _lib = None
    return _lib


def available():
    return _load() is not None


def num_threads():
    lib = _load()
    return int(lib.gppe_num_threads()) if lib else 0


def taper_csr(points_scaled, radius, nu):
    """Tapered Matern CSR (data, indices, indptr) via the native
    cell-binned builder. ``points_scaled``: (n, d) float64 already
    divided by the correlation scale; ``radius``: scaled taper radius.
    Returns None when the native library is unavailable or nu has no
    closed form."""
    if float(nu) not in (0.5, 1.5, 2.5) and float(nu) < 100.0:
        return None
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points_scaled, dtype=np.float64)
    n, d = pts.shape
    if d > 8:
        return None
    indptr = np.zeros(n + 1, dtype=np.int64)
    p_pts = pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    p_indptr = indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    nnz = lib.gppe_taper_count(p_pts, n, d, float(radius), p_indptr)
    if nnz < 0:
        return None
    indices = np.empty(nnz, dtype=np.int64)
    values = np.empty(nnz, dtype=np.float64)
    rc = lib.gppe_taper_fill(
        p_pts, n, d, float(radius), float(nu), p_indptr,
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        return None
    return values, indices, indptr
