"""Build and bind the port's CUDA kernels (``csrc/*.cu``) at first use.

Every ``.cu`` file under ``csrc/`` is compiled by its own ``nvcc`` process for
Hopper (``sm_90a``), all started together, and the objects are linked into ONE
shared library with a plain C interface, loaded with ``ctypes``.  No PyTorch
header is included, so a build takes seconds.  The library lands in
``<root>/<hash of the sources, headers and flags>/``, the root being
``$MCMCD_NATIVE_CACHE`` when it is set (made 0700, and refused as the native
library's is: ``native.cache_root``) and ``_build/`` inside this package (a
directory that ``.gitignore`` lists) otherwise, so an edited source rebuilds
and an unchanged one is loaded as it is.

A kernel is reached through a :class:`Kernel`: it calls the C launcher on the
caller's stream (in a ``tier.kernel`` span), raises on a non-zero CUDA
error code, and counts its launches, so a run can show which kernels its
main path went through.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

from ..native import CACHE_VARIABLE, cache_root
from ..profiling import span

__all__ = ["Kernel", "BuildError", "build_library", "build_root", "find_nvcc"]

_PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
_CSRC_DIR = _PKG_DIR / "csrc"
_BUILD_ROOT = _PKG_DIR / "_build"

_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class BuildError(RuntimeError):
    """nvcc is missing or refused a source (the message carries its stderr),
    or the build directory cannot be made or is refused."""


def build_root() -> pathlib.Path:
    """The directory the kernel library is built under (see the module's
    docstring); :class:`BuildError`, naming the variable, when it cannot be
    made or is refused.  The kernels have no plain fallback to give way to."""
    try:
        return cache_root(_BUILD_ROOT)
    except (OSError, RuntimeError) as err:
        raise BuildError(f"kernel build directory unavailable ({err}); set "
                         f"{CACHE_VARIABLE} to a private writable directory") from err


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise BuildError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                     "toolkit is needed to build the port's kernels.")


class BuildInfo:
    """Where the library is, how long its build took (0 when it was already
    built) and what nvcc printed (ptxas register and shared-memory use)."""

    def __init__(self, path: pathlib.Path, seconds: float, log: str):
        self.path = path
        self.seconds = seconds
        self.log = log


@functools.cache
def build_library() -> BuildInfo:
    """Compile ``csrc/*.cu`` into one ``.so`` (once per source hash)."""
    sources = sorted(_CSRC_DIR.glob("*.cu"))
    if not sources:
        raise BuildError(f"no CUDA sources under {_CSRC_DIR}")
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in sorted(_CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = build_root() / digest.hexdigest()[:16]
    lib = out_dir / "libmcmc_kernels.so"
    log_file = out_dir / "nvcc.log"
    if lib.exists():
        log = log_file.read_text() if log_file.exists() else ""
        return BuildInfo(lib, 0.0, log)

    try:
        out_dir.mkdir(exist_ok=True, mode=0o700)
    except OSError as err:
        raise BuildError(f"cannot make {out_dir} ({err}); set {CACHE_VARIABLE} "
                         "to a private writable directory") from err
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        # one nvcc per source, all running at once
        objects, procs = [], []
        for src in sources:
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *_NVCC_FLAGS, "-c", "-o", obj, str(src)]
            objects.append(obj)
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        outputs = [proc.communicate()[0] for _, proc in procs]   # wait for all
        for (cmd, proc), output in zip(procs, outputs):
            if proc.returncode != 0:
                raise BuildError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                                 f"{output}")
        log = "".join(outputs)
        # link to a temporary name and rename: a process that finds the final
        # name never loads a half-written library
        tmp_lib = os.path.join(tmp, lib.name)
        link = subprocess.run([nvcc, "-shared", "-o", tmp_lib, *objects],
                              capture_output=True, text=True, check=False)
        if link.returncode != 0:
            raise BuildError(f"nvcc link failed ({link.returncode})\n"
                             f"{link.stderr}{link.stdout}")
        os.replace(tmp_lib, lib)
    log_file.write_text(log)
    return BuildInfo(lib, time.perf_counter() - t0, log)


@functools.cache
def _library() -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library().path))


class Kernel:
    """One C launcher of the library: ``int name(..., void* stream)``.

    ``argtypes`` lists the ctypes types of every argument but the trailing
    stream; every pointer is ``c_void_p`` so ctypes never truncates it.
    ``launches`` counts the calls that launched the kernel.  A kernel that
    splits the star axis over blocks has its own ``star_chunk``: the stars a
    block takes (``None`` for the others).
    """

    def __init__(self, symbol: str, argtypes, star_chunk: int | None = None):
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.star_chunk = star_chunk
        self.launches = 0

    @functools.cached_property
    def _fn(self):
        fn = getattr(_library(), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def __call__(self, *args, stream: int) -> None:
        with span("tier.kernel"):
            err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"CUDA launch of {self.symbol} failed with "
                               f"cudaError {err}")
        self.launches += 1
