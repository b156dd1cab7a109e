"""ctypes bindings to the native C++ EDT kernel (native/edt.cpp).

Auto-builds the shared library with g++ on first use if the repo's native/
sources are present and no .so exists yet (offline host path — never in the
device hot loop). Falls back gracefully when no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LIB_NAME = "libstomp_edt.so"
_lock = threading.Lock()
_lib = None
_tried = False


def _lib_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "_native", _LIB_NAME)


def _src_dir() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "native")


def _build() -> bool:
    src = os.path.join(_src_dir(), "edt.cpp")
    if not os.path.exists(src):
        return False
    out = _lib_path()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cmd = ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
           "-pthread", src, "-o", out]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except (subprocess.SubprocessError, FileNotFoundError):
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _lib_path()
        if not os.path.exists(path) and not _build():
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.edt_sq_3d.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.edt_sq_3d.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def edt_sq(seed: np.ndarray) -> np.ndarray:
    """Exact squared EDT (voxel² units) to the nearest True voxel. [X,Y,Z]."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native EDT library unavailable")
    seed = np.ascontiguousarray(seed, np.uint8)
    out = np.empty(seed.shape, np.float64)
    lib.edt_sq_3d(
        seed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        *map(int, seed.shape),
    )
    out[out >= 1e29] = np.inf
    return out
