#!/usr/bin/env python3
"""Time variants of a kernel's source beside the source as it is.

Run from the root of the repository, on a machine with the CUDA toolkit and
one NVIDIA GPU:

    python3 kernel_variants.py                    # every kernel of VARIANTS
    python3 kernel_variants.py constant_mixture   # one of them

A variant is a kernel's ``csrc/`` source with some of its text replaced
(``VARIANTS`` below: the other way of a choice the source makes).  Each is
compiled by its own nvcc, with the build's flags, into a library of its
own; for its timings its launcher takes the place of the built one in the
kernel's ``Kernel``, so the wrapper, its checks and its scratch are the
source's.  For each kernel, shape and variant it prints the max_abs_err of
the source and of the variant against the float64 plain version (at the
kernel's gate: a variant that misses it says so) and their device times
(``chip_smoke.cuda_ms``), taken in turns: source, variant, variant,
source.  Then it prints each variant's ptxas registers and spills.
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess
import sys
import tempfile

import chip_smoke

CSRC = pathlib.Path(__file__).resolve().parent / "mcmc_dynamics_tpu_torch" / "csrc"

# kernel -> (source, {variant: [(text in the source, its replacement), ...]})
_ACCURATE_LOG = ("(__logf(rs)", "(logf(rs)")
_SMEM_CONSTANTS = [
    ("  Walker m[TW];\n", "  const Walker* m;                 // the tile's, in shared memory\n"),
    ("""      : rows(r) {
#pragma unroll
    for (int k = 0; k < TW; ++k)
      // the ragged last tile repeats the last walker and never writes it
      m[k].set(params + 4 * min(w0 + k, n_walkers - 1));
  }""", """      : rows(r),
        m(walker_reduce::tile_constants<TW, Walker>(
            w0, n_walkers, [&](Walker& c, int w) { c.set(params + 4 * w); })) {}""")]
_LOG1P = "__logf(1.0f + __expf(-fabsf(a - s.lb)))"
VARIANTS = {
    "constant_mixture": ("constant_mixture.cu", {
        "logf, log1pf(expf) (the accurate pair)": [
            _ACCURATE_LOG, (_LOG1P, "log1pf(expf(-fabsf(a - s.lb)))")],
        "logf(rs)": [_ACCURATE_LOG],
        "log1pf(__expf)": [(_LOG1P, "log1pf(__expf(-fabsf(a - s.lb)))")],
        "tile_constants": _SMEM_CONSTANTS,
    }),
    "model_tensor": ("model_tensor.cu", {
        "4-walker small tile": [("kSmallTile = 8;", "kSmallTile = 4;")],
        "32-walker wide tile": [("kWideTile = 16;", "kWideTile = 32;")],
        "small tile's a-rank loop unrolled by 4": [
            ("TW == kWideTile ? 4 : 12;", "TW == kWideTile ? 4 : 4;")],
        "wide tile's a-rank loop unrolled by 8": [
            ("TW == kWideTile ? 4 : 12;", "TW == kWideTile ? 8 : 12;")],
        "wide tile's a-rank loop unrolled by 12": [
            ("TW == kWideTile ? 4 : 12;", "TW == kWideTile ? 12 : 12;")],
        "bases read from L2": [
            ("cheb_dot(s_xi[TW + idx % TW], s_ua + idx / TW, t.d_a, t.ra)",
             "cheb_dot(s_xi[TW + idx % TW], t.u_a + idx / TW, t.d_a, t.ra)"),
            ("cheb_dot(s_xi[idx % TW], s_us + idx / TW, t.d_s, n_ps)",
             "cheb_dot(s_xi[idx % TW], t.u_s + i_first + idx / TW, t.d_s, t.rs)")],
        "a block barrier after each pass": [
            ("      warp_reduce_spread<TW>(acc,",
             "      walker_reduce::block_reduce_spread<TW>(acc,")],
        "wide tile one chunk a block": [
            ("const int per_block = TW == kWideTile ? min(n_chunks, kMaxPerBlock) : 1;",
             "const int per_block = 1;")],
    }),
}


def build_variants(kernel_name):
    """{variant: (ctypes library, ptxas lines)}, one nvcc per variant, all
    started together."""
    from mcmc_dynamics_tpu_torch.ops._build import _NVCC_FLAGS, find_nvcc

    source, variants = VARIANTS[kernel_name]
    text = (CSRC / source).read_text()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="kernel_variants_"))
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        var = text
        for old, new in edits:
            if old not in var:
                raise ValueError(f"{kernel_name} variant {name!r}: {old!r} not in {source}")
            var = var.replace(old, new)
        src = tmp / f"v{i}" / source
        shutil.copytree(CSRC, src.parent)
        src.write_text(var)
        lib = src.with_suffix(".so")
        cmd = [find_nvcc(), *_NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{out}")
        ptxas = [ln.strip() for ln in out.splitlines() if "Used" in ln or "spill" in ln]
        built[name] = (ctypes.CDLL(str(lib)), ptxas)
    return built, tmp


def kernel_cases(kernel_name, device):
    """(Kernel, [(label, run, args, plain on float64 args, tol)]) at the
    kernel's shapes: its main path's and 16384 walkers."""
    import torch

    from mcmc_dynamics_tpu_torch import ops

    if kernel_name == "constant_mixture":
        make = chip_smoke.constant_inputs(device, gb=False)
        cases = []
        for shape in ((128, 20_480, 0), (16384, 10_000, 240)):
            a32 = make(shape)[0]

            def plain(a32=a32):
                a64 = [t.double() for t in a32]
                return torch.cat([ops.constant_mixture_lnlike_reference(p, *a64[1:])
                                  for p in torch.split(a64[0], 2048)])
            cases.append((chip_smoke.size_label(shape), chip_smoke.constant_mixture_split,
                          a32, plain, chip_smoke.DIRECT_TOL))
        return ops.CONSTANT_MIXTURE, cases
    fit, _ = chip_smoke.mock_fit(device, n_stars=100_000, seed=5)
    stats = fit.tensor_stats()
    stats64 = stats.to(dtype=torch.float64)
    cases = []
    for n_walkers in (512, 16384):
        params = chip_smoke.tensor_inputs(stats, device)((n_walkers,))[0][0]

        def plain(params=params):
            return torch.cat([stats64.lnlike(p) for p in torch.split(params.double(), 4096)])
        cases.append((f"{n_walkers} walkers", lambda p: ops.model_tensor_lnlike(stats, p),
                      [params], plain, chip_smoke.TENSOR_TOL))
    return ops.MODEL_TENSOR, cases


def error(label, got, ref, tol) -> str:
    try:
        return f"{chip_smoke.compare(label, got, ref, **tol):.4g}"
    except AssertionError as exc:
        return f"FAILS the gate ({str(exc).splitlines()[0]})"


def main(argv=None) -> int:
    import torch

    names = (sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU.", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"kernel_variants on {smi}")
    for kernel_name in names:
        built, tmp = build_variants(kernel_name)
        kernel, cases = kernel_cases(kernel_name, device)
        own = kernel._fn                     # the built library's launcher
        try:
            for label, run, args, plain, tol in cases:
                ref = plain()
                base_err = error(f"{kernel_name} {label}", run(*args), ref, tol)
                for name, (lib, _) in built.items():
                    fn = getattr(lib, kernel.symbol)
                    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
                    kernel.__dict__["_fn"] = fn
                    var_err = error(f"{kernel_name} {label} {name}", run(*args), ref, tol)
                    times = []
                    for f in (own, fn, fn, own):
                        kernel.__dict__["_fn"] = f
                        times.append(chip_smoke.cuda_ms(lambda: run(*args)))
                    kernel.__dict__["_fn"] = own
                    print(f"{kernel_name} {label}: source {times[0]:.4f}, {times[3]:.4f} "
                          f"ms, max_abs_err {base_err} | variant {name!r} {times[1]:.4f}, "
                          f"{times[2]:.4f} ms, max_abs_err {var_err} | variant/source "
                          f"{(times[1] + times[2]) / (times[0] + times[3]):.3f}")
        finally:
            kernel.__dict__["_fn"] = own
            shutil.rmtree(tmp, ignore_errors=True)
        for name, (_, ptxas) in built.items():
            print(f"  {kernel_name} variant {name!r} ptxas: " + " | ".join(ptxas))
    return 0


if __name__ == "__main__":
    sys.exit(main())
