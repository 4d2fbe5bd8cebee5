"""ctypes bindings for the native C++ grid index (the repository's
native/gridindex.cpp), a copy of `stratanet2_tpu/data/native.py`.

The library is built on first use with native/Makefile (`make -C` on a copy
of native/ under the git-ignored build/native/, the library then renamed into
place: the JAX package's module builds native/libgridindex.so itself, and
the two never write one file). It is named by a hash of the sources, so an
edited gridindex.cpp is rebuilt. If the toolchain or the build is
unavailable, callers take the vectorized numpy path
(`transforms.min_z_in_radius_numpy`; `transforms.min_z_path()` says which
one runs) — same results, slower. A compiler without OpenMP gets a serial
build (`_build`). `disk_query`'s caller, parcel tiling
(`inference/tiling.py`), holds the scipy cKDTree path.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("stratanet2_tpu_torch")

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_SOURCES = ("Makefile", "gridindex.cpp")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _lib_path() -> Path:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update((_NATIVE_DIR / name).read_bytes())
    return _BUILD_DIR / f"libgridindex-{h.hexdigest()[:16]}.so"


# native/Makefile's CXXFLAGS without -fopenmp: the serial build, taken when
# the OpenMP one fails (a compiler without OpenMP's runtime or its spec file).
# gridindex.cpp includes <omp.h> only under _OPENMP and otherwise ignores its
# `#pragma omp` lines, so it builds and gives the same results on one thread.
SERIAL_CXXFLAGS = "-O3 -march=native -fPIC -shared -std=c++17"


def _build(path: Path) -> bool:
    """Build the library into `path`: `make` with native/Makefile's flags
    (OpenMP), and if that fails once more with SERIAL_CXXFLAGS. Logs which
    build was kept."""
    tmp = _BUILD_DIR / f"src.{os.getpid()}"
    try:
        tmp.mkdir(parents=True, exist_ok=True)
        for name in _SOURCES:
            shutil.copy2(_NATIVE_DIR / name, tmp / name)
        for kind, flags in (("OpenMP", []), ("serial", [f"CXXFLAGS={SERIAL_CXXFLAGS}"])):
            try:
                subprocess.run(["make", "-C", str(tmp), *flags], check=True, capture_output=True,
                               text=True, timeout=120)
            except subprocess.SubprocessError as err:
                output = (getattr(err, "stdout", None) or "") + (getattr(err, "stderr", None) or "")
                logger.warning("native gridindex %s build failed: %s %s", kind, err,
                               output[-2000:])
                continue
            os.replace(tmp / "libgridindex.so", path)  # atomic: concurrent builds agree
            logger.info("native gridindex: kept the %s build", kind)
            return True
        return False
    except OSError as err:
        logger.warning("native gridindex build failed: %s", err)
        return False
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = _lib_path()
        except OSError as err:  # native/ is not beside the package
            logger.warning("native gridindex sources not found: %s", err)
            return None
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as err:
            logger.warning("native gridindex load failed: %s", err)
            return None
        dp = ctypes.POINTER(ctypes.c_double)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.minz_in_radius.argtypes = [dp, dp, ctypes.c_int64, ctypes.c_double, dp]
        lib.disk_query_count.argtypes = [dp, ctypes.c_int64, dp, ctypes.c_int64, ctypes.c_double, i64p]
        lib.disk_query_fill.argtypes = [dp, ctypes.c_int64, dp, ctypes.c_int64, ctypes.c_double, i64p, i32p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native gridindex library could not be built or loaded")
    return lib


def min_z_in_radius(xy: np.ndarray, z: np.ndarray, radius: float) -> np.ndarray:
    lib = _need()
    xy = np.ascontiguousarray(xy, np.float64)
    z = np.ascontiguousarray(z, np.float64)
    n = len(z)
    out = np.empty(n, np.float64)
    lib.minz_in_radius(_dptr(xy), _dptr(z), n, float(radius), _dptr(out))
    return out


def disk_query(
    xy: np.ndarray, centers: np.ndarray, radius: float
) -> Tuple[np.ndarray, np.ndarray]:
    """CSR disk query: returns (offsets (M+1,) int64, indices int32) — the
    point indices within `radius` of center q are
    indices[offsets[q]:offsets[q+1]]."""
    lib = _need()
    xy = np.ascontiguousarray(xy, np.float64)
    centers = np.ascontiguousarray(centers, np.float64)
    n, m = len(xy), len(centers)
    counts = np.empty(m, np.int64)
    lib.disk_query_count(
        _dptr(xy), n, _dptr(centers), m, float(radius),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    offsets = np.zeros(m + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    out = np.empty(int(offsets[-1]), np.int32)
    lib.disk_query_fill(
        _dptr(xy), n, _dptr(centers), m, float(radius),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return offsets, out
