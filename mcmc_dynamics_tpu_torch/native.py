"""ctypes binding to the repository's native C++ host library
(``native/mcmcd_native.cpp``): numeric CSV ingest, the binary catalog cache and
the greedy radial binning.

The port's own binding (it imports nothing of ``mcmc_dynamics_tpu``): the
library is compiled with ``g++`` at first use into ``native-<digest of the
source>/`` under :func:`cache_root`: ``$MCMCD_NATIVE_CACHE`` when it is set,
else ``mcmc_dynamics_tpu_torch/_build/`` (a directory ``.gitignore`` lists).
It is written under a temporary name and renamed into place, so a killed or
concurrent build never leaves a truncated library where a later load would
find it.  As in the JAX package, every entry point returns None (or False)
when no compiler or library is available, or the build directory cannot be
made or is refused, and its callers then take their NumPy paths, which give
the same answers.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import pathlib
import stat
import subprocess
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["CACHE_VARIABLE", "cache_root", "load_library", "native_available",
           "read_csv", "cache_write", "cache_read", "radial_bins"]

_SOURCE = pathlib.Path(__file__).resolve().parents[1] / "native" / "mcmcd_native.cpp"
_BUILD_ROOT = pathlib.Path(__file__).resolve().parent / "_build"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
# the directory the port's libraries (this one and the CUDA kernels) build in
CACHE_VARIABLE = "MCMCD_NATIVE_CACHE"


def cache_root(default: pathlib.Path) -> pathlib.Path:
    """The directory the port's compiled libraries live in.

    ``$MCMCD_NATIVE_CACHE`` when it is set, made with mode 0700, and refused
    (``RuntimeError``), as the JAX package refuses it, when it is a symlink,
    owned by another user, or group- or world-writable: a library another
    user could plant there would be loaded into this process.  Else
    ``default``, inside the package.  ``OSError`` when the directory cannot
    be made."""
    base = os.environ.get(CACHE_VARIABLE)
    if not base:
        default.mkdir(parents=True, exist_ok=True)
        return default
    path = pathlib.Path(base)
    path.mkdir(parents=True, exist_ok=True, mode=0o700)
    # lstat: a symlink to a directory that passes the checks is refused too
    st = os.lstat(path)
    if stat.S_ISLNK(st.st_mode):
        raise RuntimeError(f"{CACHE_VARIABLE} directory {path} is a symlink; "
                           "refusing to load libraries through it.")
    if hasattr(os, "getuid") and st.st_uid != os.getuid():
        raise RuntimeError(f"{CACHE_VARIABLE} directory {path} is owned by uid "
                           f"{st.st_uid}, not this user; refusing to load "
                           "libraries from it.")
    if st.st_mode & 0o022:
        raise RuntimeError(f"{CACHE_VARIABLE} directory {path} is group- or "
                           "world-writable; refusing to load libraries from it.")
    return path


@functools.cache
def load_library() -> Optional[ctypes.CDLL]:
    """Compile (once per source digest) and load the library; None when the
    source, the build directory, the compiler or the load is unavailable."""
    if not _SOURCE.exists():
        return None
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_FLAGS).encode())
    try:
        build_dir = cache_root(_BUILD_ROOT) / f"native-{digest.hexdigest()[:16]}"
        build_dir.mkdir(exist_ok=True, mode=0o700)
    except (OSError, RuntimeError) as err:
        logger.warning("Native library build directory unavailable (%s); using "
                       "NumPy paths.", err)
        return None
    so_path = build_dir / "libmcmcd_native.so"
    if not so_path.exists():
        tmp_path = build_dir / f".libmcmcd_native.{os.getpid()}.tmp.so"
        cmd = ["g++", *_FLAGS, str(_SOURCE), "-o", str(tmp_path)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp_path, so_path)
        except (OSError, subprocess.SubprocessError) as err:
            logger.warning("Native library build failed (%s); using NumPy paths.",
                           err)
            tmp_path.unlink(missing_ok=True)
            return None
    try:
        lib = ctypes.CDLL(str(so_path))
    except OSError as err:
        logger.warning("Native library load failed (%s).", err)
        return None

    lib.mcmcd_read_csv.restype = ctypes.c_long
    lib.mcmcd_read_csv.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                   ctypes.POINTER(ctypes.POINTER(ctypes.c_double))]
    lib.mcmcd_free.restype = None
    lib.mcmcd_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
    lib.mcmcd_cache_write.restype = ctypes.c_int
    lib.mcmcd_cache_write.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_double),
                                      ctypes.c_long, ctypes.c_long]
    lib.mcmcd_cache_open.restype = ctypes.POINTER(ctypes.c_double)
    lib.mcmcd_cache_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                                     ctypes.POINTER(ctypes.c_long),
                                     ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.POINTER(ctypes.c_long)]
    lib.mcmcd_cache_close.restype = None
    lib.mcmcd_cache_close.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.mcmcd_radial_bins.restype = ctypes.c_long
    lib.mcmcd_radial_bins.argtypes = [ctypes.POINTER(ctypes.c_double),
                                      ctypes.c_long, ctypes.c_long,
                                      ctypes.c_double,
                                      ctypes.POINTER(ctypes.c_int32)]
    return lib


def native_available() -> bool:
    return load_library() is not None


def read_csv(path, n_cols: int) -> Optional[np.ndarray]:
    """Numeric CSV -> (rows, n_cols) float64 array (rows whose first field is
    not a number, such as the header, are skipped); None on fallback."""
    if n_cols < 1 or n_cols > 64:
        return None  # beyond the native row buffer
    lib = load_library()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_double)()
    rows = lib.mcmcd_read_csv(str(path).encode(), n_cols, ctypes.byref(out))
    if rows < 0:
        return None
    try:
        arr = np.ctypeslib.as_array(out, shape=(rows, n_cols)).copy()
    finally:
        lib.mcmcd_free(out)
    return arr


def cache_write(path, data: np.ndarray) -> bool:
    """Write a (rows, cols) float64 array to the binary catalog cache."""
    lib = load_library()
    if lib is None:
        return False
    data = np.ascontiguousarray(data, dtype=np.float64)
    if data.ndim != 2:
        raise ValueError(f"cache_write takes a 2-d array, got shape {data.shape}")
    rows, cols = data.shape
    ptr = data.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    return lib.mcmcd_cache_write(str(path).encode(), ptr, rows, cols) == 0


def cache_read(path) -> Optional[np.ndarray]:
    """Load a binary catalog cache through mmap (copied out to own the memory);
    None when unavailable or not a valid cache."""
    lib = load_library()
    if lib is None:
        return None
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    handle = ctypes.c_void_p()
    size = ctypes.c_long()
    ptr = lib.mcmcd_cache_open(str(path).encode(), ctypes.byref(rows),
                               ctypes.byref(cols), ctypes.byref(handle),
                               ctypes.byref(size))
    if not ptr:
        return None
    try:
        arr = np.ctypeslib.as_array(ptr, shape=(rows.value, cols.value)).copy()
    finally:
        lib.mcmcd_cache_close(handle, size)
    return arr


def radial_bins(r: np.ndarray, nstars: int, dlogr: float) -> Optional[np.ndarray]:
    """Per-star bin numbers of the greedy radial binning; None on fallback."""
    lib = load_library()
    if lib is None:
        return None
    r = np.ascontiguousarray(r, dtype=np.float64)
    out = np.empty(r.size, dtype=np.int32)
    lib.mcmcd_radial_bins(r.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                          r.size, int(nstars), float(dlogr),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
