"""ctypes bindings for the native point-ops library (native/pointops.cc);
copied from ``dl_biomass_tpu/native/pointops.py``. This file sits two levels
below the repo root, as the JAX one does, so ``_NATIVE_DIR`` is the same
``native/``.

Builds on demand with the repo Makefile (g++); every entry point has identical
semantics to the numpy references in ``ops/reference.py``, so callers can fall
back transparently when no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libpointops.so"))

_lib: Optional[ctypes.CDLL] = None
_build_attempted = False
_lock = threading.Lock()

_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_attempted
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH) and not _build_attempted:
            _build_attempted = True
            try:
                subprocess.run(
                    ["make", "-C", os.path.abspath(_NATIVE_DIR)],
                    check=True, capture_output=True, timeout=120,
                )
            except Exception:
                return None
        if not os.path.exists(_LIB_PATH):
            return None
        lib = ctypes.CDLL(_LIB_PATH)
        lib.fps.argtypes = [_f64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _i32p]
        lib.ball_query.argtypes = [_f64p, ctypes.c_int64, _f64p, ctypes.c_int64,
                                   ctypes.c_double, ctypes.c_int64, _i32p, _u8p]
        lib.knn.argtypes = [_f64p, ctypes.c_int64, _f64p, ctypes.c_int64,
                            ctypes.c_int64, _i32p, _f64p]
        lib.voxel_downsample.argtypes = [_f64p, ctypes.c_int64, ctypes.c_double, _i32p]
        lib.voxel_downsample.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def fps(coords: np.ndarray, k: int, start: int = 0) -> np.ndarray:
    lib = _load()
    coords = np.ascontiguousarray(coords, np.float64)
    if lib is None:
        from dl_biomass_tpu_torch.ops.reference import fps_numpy

        return fps_numpy(coords, np.ones(len(coords), bool), k, start)
    out = np.empty(k, np.int32)
    lib.fps(coords, len(coords), k, start, out)
    return out


def ball_query(centers: np.ndarray, pos: np.ndarray, radius: float, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    lib = _load()
    centers = np.ascontiguousarray(centers, np.float64)
    pos = np.ascontiguousarray(pos, np.float64)
    if lib is None:
        from dl_biomass_tpu_torch.ops.reference import ball_query_numpy

        m, n = len(centers), len(pos)
        return ball_query_numpy(centers, np.ones(m, bool), pos, np.ones(n, bool), radius, k)
    idx = np.empty((len(centers), k), np.int32)
    mask = np.empty((len(centers), k), np.uint8)
    lib.ball_query(centers, len(centers), pos, len(pos), radius, k, idx, mask)
    return idx, mask.astype(bool)


def knn(queries: np.ndarray, pos: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    lib = _load()
    queries = np.ascontiguousarray(queries, np.float64)
    pos = np.ascontiguousarray(pos, np.float64)
    if lib is None:
        d = np.linalg.norm(queries[:, None] - pos[None], axis=-1)
        idx = np.argsort(d, axis=1)[:, :k].astype(np.int32)
        return idx, np.take_along_axis(d, idx, axis=1)
    idx = np.empty((len(queries), k), np.int32)
    dist = np.empty((len(queries), k), np.float64)
    lib.knn(queries, len(queries), pos, len(pos), k, idx, dist)
    return idx, dist


def voxel_downsample(pos: np.ndarray, voxel: float) -> np.ndarray:
    lib = _load()
    pos = np.ascontiguousarray(pos, np.float64)
    if lib is None:
        from dl_biomass_tpu_torch.io.resample import voxel_downsample as vd

        return vd(pos, voxel).astype(np.int32)
    out = np.empty(len(pos), np.int32)
    cnt = lib.voxel_downsample(pos, len(pos), voxel, out)
    return np.sort(out[:cnt])
