"""The benchmark's one command:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with an NVIDIA GPU.  Prints one
JSON line last on standard output (the result) and the compared numbers
beside their limits last on standard error.  Exits 2 without a CUDA device
(or with fewer than the cell needs) and 3 when a forbidden module (JAX or
the JAX package) was loaded, printing no result.

``--control bf16|tf32`` runs the cell's control instead of the program (the
reference in bfloat16 in the lnprob's place, or the program's products in
TF32), and ``--readings N`` prints the compared numbers of N seeds from
``--seed`` on, one line each, in one process: both serve to set the limits
and are not part of the benchmark's runs.
"""

import os
import pathlib
import sys
import time

_T0 = time.perf_counter()


def _process_age():
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        fields = pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        uptime = float(pathlib.Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE = _process_age()
ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "perfbench" / "_cache"


def _environment():
    """Build and kernel caches at fixed places inside the checkout, and no
    JAX pulled in by a library of the program."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    for name, sub in (("MCMCD_NATIVE_CACHE", "build"), ("TRITON_CACHE_DIR", "triton"),
                      ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[name] = str(CACHE / sub)
    CACHE.mkdir(parents=True, exist_ok=True)
    (CACHE / "build").mkdir(mode=0o700, exist_ok=True)
    # the checkout's root in place of this script's directory: the program
    # and the ``perfbench`` package import from there
    here = str(pathlib.Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT)] + [p for p in sys.path if p and
                                 str(pathlib.Path(p).resolve()) != here]


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", choices=("bf16", "tf32"), default=None)
    parser.add_argument("--readings", type=int, default=0)
    args = parser.parse_args(argv)
    _environment()
    from perfbench import harness

    return harness.main(args, t_start=_T0 - _AGE)


if __name__ == "__main__":
    sys.exit(main())
