#!/usr/bin/env python3
"""Check where the port's libraries build, and that chip_smoke.py refuses the
kernels' switch.  Run from the root of the repository on a machine with a
CUDA card, the CUDA toolkit and g++:

    python3 chip_switches.py

1. ``chip_smoke.py`` with ``MCMC_TPU_DISABLE_PALLAS=1`` in its environment
   exits non-zero in phase 1, naming the variable, and prints no result.
2. In a copy of the package in a temporary directory whose ``_build/`` is a
   regular file (no user, root included, can build there): with
   ``MCMCD_NATIVE_CACHE`` set, the CUDA kernels and the native host library
   both build into the variable's directory, made 0700; without it, the
   kernel build raises ``BuildError`` naming the variable and the native
   binding gives None (its callers then take the NumPy paths).

Prints one line for each check and exits 0 when every check holds.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import stat
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
SWITCH = "MCMC_TPU_DISABLE_PALLAS"
CACHE = "MCMCD_NATIVE_CACHE"

# built in the copy: each library's path, or what stopped it
BUILD = """\
import mcmc_dynamics_tpu_torch.native as native
from mcmc_dynamics_tpu_torch.ops._build import BuildError, build_library
lib = native.load_library()
print("native", lib._name if lib is not None else None)
try:
    print("cuda", build_library().path)
except BuildError as err:
    print("cuda BuildError", str(err).splitlines()[0])
"""


def check_refusal() -> None:
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, **{SWITCH: "1"}))
    last = run.stderr.strip().splitlines()[-1] if run.stderr.strip() else ""
    if run.returncode == 0 or SWITCH not in last or '"ok"' in run.stdout:
        raise AssertionError(f"chip_smoke.py with {SWITCH}=1: rc {run.returncode}, "
                             f"stdout {run.stdout[-300:]!r}, stderr {last!r}")
    print(f"check 1: chip_smoke.py with {SWITCH}=1 exits {run.returncode} in "
          f"phase 1 and prints no result: {last}")


def build_in(copy: pathlib.Path, cache) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in (CACHE, "PYTHONPATH")}
    if cache is not None:
        env[CACHE] = str(cache)
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", BUILD], cwd=copy, capture_output=True,
                         text=True, timeout=900, env=dict(env, PYTHONPATH=str(copy)))
    if run.returncode != 0:
        raise AssertionError(f"build in the copy failed:\n{run.stdout}{run.stderr}")
    out = dict(line.split(" ", 1) for line in run.stdout.splitlines())
    out["seconds"] = time.perf_counter() - t0
    return out


def check_build_directories() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        copy = pathlib.Path(tmp) / "checkout"
        shutil.copytree(REPO / "mcmc_dynamics_tpu_torch", copy / "mcmc_dynamics_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copytree(REPO / "native", copy / "native")
        (copy / "mcmc_dynamics_tpu_torch" / "_build").write_text("not a directory")
        cache = pathlib.Path(tmp) / "cache"
        got = build_in(copy, cache)
        for name in ("native", "cuda"):
            if not got[name].startswith(str(cache)):
                raise AssertionError(f"{name} library at {got[name]}, not under {cache}")
        mode = stat.S_IMODE(os.stat(cache).st_mode)
        if mode != 0o700:
            raise AssertionError(f"{CACHE} directory made with mode {oct(mode)}")
        built = sorted(str(p.relative_to(cache)) for p in cache.rglob("*.so"))
        print(f"check 2a: {CACHE} set, _build/ a file: both libraries built there in "
              f"{got['seconds']:.1f} s ({', '.join(built)}), the directory mode "
              f"{oct(mode)}")
        got = build_in(copy, None)
        if got["native"] != "None" or not got["cuda"].startswith("BuildError") \
                or CACHE not in got["cuda"]:
            raise AssertionError(f"without {CACHE}: {got}")
        print(f"check 2b: no {CACHE}, _build/ a file: native None (NumPy paths); "
              f"cuda {got['cuda']}")


def main() -> int:
    check_refusal()
    check_build_directories()
    return 0


if __name__ == "__main__":
    sys.exit(main())
