#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py              # every phase (what the check runs)
    python3 chip_smoke.py --profile    # also trace each main path with torch.profiler
    python3 chip_smoke.py --chunk-sweep    # also time kernels 1-4, 7, 9, 12, 13 per chunk

It builds the port's CUDA kernels from ``mcmc_dynamics_tpu_torch/csrc``,
checks each against its plain torch version at the shapes the main paths give
it, then samples each main path end to end through the entry points a user
calls, and fails (non-zero exit) if any phase does:

1. environment: torch, CUDA, the card, ``nvidia-smi``, ``nvcc`` and the build
   (ptxas registers and spills);
2. kernel 1 (fixed-centre walker x star likelihood, split over star
   chunks) against its float64 plain version at 16384 walkers x 1e4 stars
   and at path A's 32 walkers x 6400 stars; and its batch invariance, as in
   phase 14;
3. kernel 2 (tensor-Chebyshev tables, its contraction split over row
   chunks) against its float64 plain version at 16384 walkers and at path
   B's half-ensemble of 512 on the tables of a 1e5-star mock catalog; and
   its batch invariance, as in phase 14;
4. main path A, the omega Cen fixed-centre recipe (``example/``): 64 walkers x
   600 steps through kernel 1, goldens, profiles, and a bitwise resume;
5. main path B, the tensor tier: 1e5-star mock, 1024 walkers x 200 steps
   through kernel 2, recovery of the truth;
6. kernel 3 (free-centre walker x star likelihood, as kernel 1, with its
   batch invariance), 7. kernel 4 (ConstantFit + fixed background) and 8.
   kernel 5 (ConstantFitGB density mixture), both split over star chunks,
   against their float64 plain versions at 16384 walkers x 1e4 stars and
   at their path's half-ensemble, each with its batch invariance, as in
   phase 14; 9. kernel 10 (SingleStars KDE) at 20480 targets x 8192
   catalog stars and at a ragged catalog, with targets past the catalog's
   edge (every exponent below -104), and the same bits in two calls;
10. main path C, the omega Cen free-centre ConstantFit recipe (generic tier,
    plain torch): 64 walkers x 600 steps, goldens;
11. main path D, free-centre ModelFit on the omega Cen catalog through kernel
    3: 64 walkers x 600 steps, goldens, bitwise resume;
12. main path E1, ConstantFitGB on a contaminated mock catalog (16384 members
    + 4096 field stars) through kernel 5, recovery of the truth;
13. main path E2, ConstantFit with a SingleStars background on the same
    catalog: kernel 10 at construction, kernel 4 while sampling;
14. kernel 6 (ModelFit density mixture) with its Gaussian background and 15.
    with a fixed per-star background, 16. kernel 7 (DoubleModelFit) and 17.
    kernel 8 (DoubleModelFitGB) against their float64 plain versions at 16384
    walkers x 1e4 stars and at their path's half-ensemble; kernels 6, 7 and 8
    (split over star chunks) also give walkers 0-127 of the 16384 batch
    bitwise the same value alone, and the same bits in two calls;
18. main path F1, ModelFitGB on a contaminated catalog with rotating members
    through kernel 6, recovery of the truth;
19. main path F2, ModelFitConstantBackground with a SingleStars background on
    the same catalog: kernel 10 at construction, kernel 6 while sampling;
20. main path G1, DoubleModelFit on the omega Cen catalog through kernel 7,
    with a bitwise resume;
21. main path G2, DoubleModelFitGB on path F's catalog through kernel 8;
22. kernel 9 (the binned table tier) on path H's float32 tables at 16384
    walkers and at the path's half-ensemble of 512, against its float64 plain
    version, and the tables against the exact star sum; and its batch
    invariance, as in phase 14;
23. kernel 11 (the same function on the tensor cores, 3xTF32 ``wgmma``): one
    bin's product against the float64 product of its rounded operands (the
    operand layouts), the kernel at phase 22's inputs beside kernel 9 timed
    in turns, on ``bench.py --validate``'s set-up at its matrix-unit gate,
    and its batch invariance, as in phase 14;
24. kernel 12 and 25. kernel 13 (the restructured density mixtures, split
    over star chunks) against their float64 plain versions at 16384 walkers
    x 1e4 stars and at 128 x 20480, beside kernels 5 and 6 on the same
    inputs, each with its batch invariance, as in phase 14;
26. main path H, the binned tier: path B's 1e5-star mock with the default
    unbounded a and r_peak priors, 1024 walkers x 200 steps through kernel 9,
    recovery of the truth;
27. the tier crossover: kernel 1 and kernel 9 on one 16384-star catalog
    (path H's mock at the star count where auto dispatch takes the binned
    tier) at 512 walkers, each held to the exact star sum and timed;
28. the native host library (``native/mcmcd_native.cpp`` through
    ``mcmc_dynamics_tpu_torch/native.py``): it builds with g++, its radial
    binning equals the NumPy branch on the omega Cen radii and on path B's
    mock's, and a catalog cache round trip returns the same columns;
29. main path I1, the reference's production binned workload:
    ``pipelines.fit_radial_bins`` with ConstantFit's default parameters on
    the omega Cen catalog (400 stars, 0.05 dex a bin; 64 walkers x 300
    steps, every bin's ensemble in one step loop), no kernel (the sufficient
    tables in plain torch, as in the JAX package): set-up, best of 3 timed
    runs, each bin's sigma_max and v_sys medians inside the JAX package's
    bands (``chip_smoke_binned_reference.json``, from
    ``chip_smoke_reference.py``);
30. main path I2, the same pipeline on path B's 1e5-star mock, where the
    bins are many and uneven: as I1, and the bucketed chains equal a run
    with every bin in one bucket, bit for bit;
31. main path J, convergence and the new moves: A's recipe through
    ``sample_to_convergence`` with a DE/snooker mixture (kernel 1), capped at
    twice the steps the JAX package needs there; goldens after discarding
    twice the largest tau, ``predict_fields`` on a 32 x 32 grid and
    ``profiling.benchmark_lnprob`` at 1024 walkers;
32. the JAM engine on the card (plain torch, no kernel of its own): on
    ``bench.py --validate``'s set-ups (Axisymmetric with a free black hole on
    400 stars with a tail at 15-25 sigma, AnalyticalProfiles, a two-population
    ChemoProfiles on 500 stars; 64 seeded walkers), float32 and float64 on
    both tiers against the JAX package's float64 values
    (``chip_smoke_jam_reference.json``, from ``chip_smoke_reference.py K``),
    grid against direct, and the timings: one batched lnprob at 64 and 512
    walkers, its exp and product shares, the walker-chunk sweep, TF32 for
    the record, the pair table's bytes;
33. main path K1, the production recipe: ``python -m
    mcmc_dynamics_tpu_torch.cli.run`` on ``example/omega_cen_config.json``
    (AnalyticalProfiles on 6284 stars, auto dispatch on the grid tier, 32
    walkers x 60 steps, profiles, the mass posterior, the binned section),
    the recipe's 64 seeded walkers against the JAX package on both tiers,
    and a bitwise resume;
34. main path K2: Axisymmetric with mlr, barq, kappa_x, kappa_y, mbh and
    delta_v free on a 16384-star self-consistent mock (the recipe's MGE, the
    velocities from the port's float64 engine at a stated truth), 64 walkers
    x 1500 steps on the grid tier; every truth inside its posterior's
    0.15-99.85 % interval;
35. main path L1, the tempered recipe: ``example/omega_cen_tempered.json``
    without its ``parallel`` block (a 4-device mesh) and with
    ``sampling.n_temps`` 4, through ``cli.run.main`` in this process: a
    ladder of 4 x 32 walkers x 500 steps on kernel 1 (64 walkers a
    half-step), kernel 1 launched 1 + 2 x 500 times by the CLI, the cold
    chain in the omega_cen_tempered goldens, a finite log-evidence, each
    pair's swap acceptance; ``sample_tempered`` in 17 + 23 steps through
    ``state=`` bitwise equal to 40;
36. main path L2, HMC: ``sample_hmc`` on the omega Cen fixed-centre recipe
    (32 walkers, the windowed warmup of 200 + 100 steps, 300 steps, 10
    leapfrog steps), through the generic tier's autograd (no kernel
    launches), finite, the medians in the omega_cen_fixed goldens (as the
    JAX package's float64 run at these settings,
    ``chip_smoke_samplers_reference.json``);
37. main path L3, the emcee-compatible sampler: a per-walker torch Gaussian
    through ``torch.func.vmap`` (64 x 3000, moments within
    tests/test_torch_moves.py's bounds), the omega Cen recipe's batched
    lnprob with ``vectorize=True`` through kernel 1 (300 + 300 steps
    through an in-memory Backend bitwise equal to 600 and to ``fit(...)``
    at the seed the sampler draws, goldens), and a scipy log-prob on the
    NumPy path;
38. main path M1, A's recipe on meshes of ranks (one process a rank;
    phases 38-40 share one world of four processes that this script spawns
    with the torchrun environment, whose ranks share the one card, their
    collectives over gloo staged through the host): dp 2 x sp 2 (kernel 1
    on 1571-star slices, the partial sums all-reduced; the medians in A's
    goldens, the final lnP against the full catalog's kernel 1 at
    DIRECT_TOL, a checkpoint at 300 steps resumed bit for bit) and dp 4 x sp
    1, and dp 1 x sp 1 in this script (a world of one rank: NCCL), the last
    two path A's chain bit for bit; every rank's chain identical;
39. main path M2, every partial tier on four star slices (dp 1 x sp 4 in
    the world of four): the models and walkers of paths A (kernel 1), D (3), E1
    (5), F1 and F2 (6, both backgrounds), G1 (7), G2 (8) and K2 (the JAM
    grid tier, plain torch), each sampled 20 steps on the star-sharded mesh
    (K2 2), each rank's slice against the float64 plain version and the
    slices' all-reduced sum against one full-catalog call, at the path's
    gate; rank 0 times each kernel on its slice;
40. main path M3, ``example/omega_cen_tempered.json`` as written, its
    ``parallel: {axes: {tp: 4}}`` block included, through ``cli.run.main``
    in the world of four, one temperature a rank: kernel 1 1 + 2 x 500
    times a rank, the cold chain in the goldens, a finite log-evidence,
    every pair swapping; 25 + 35 ladder steps through ``state=`` bitwise
    equal to 60;
41. main path M4, path I1 with its bins over dp 2 (a world of two): both
    ranks' chains path I1's bit for bit.

With ``--profile`` rank 0 of each world (and the script for M1's one rank)
also traces 100 steps of paths M1 and M3 and M4's pipeline.

The walker x star phases (2, 6, 14-17, 25) include walkers at r_peak 1e19,
1e20 and 1e37 (the double models also 1e13, 3e38 and 1e-3), where float32
overflows the TPU kernels' forms; the port's kernels stay within the float64
plain version's tolerance there.  ``--chunk-sweep`` also times kernels 1, 3,
4, 7, 12 and 13 at several star chunks (the kernel's chunk is an attribute
of its launcher, so no rebuild is needed), kernel 2 at several row chunks
(``ops.model_tensor.ROW_CHUNK``), kernel 9 at several bin groups
(``ops.model_sufficient.BIN_GROUP``) and kernel 11 at several bin groups
and walker tiles a warpgroup (``MMA_BIN_GROUP``, ``MMA_WALKER_TILES``).
Choices compiled into a source (kernel 9's walkers a lane, kernel 10's
lanes a target, kernel 11's warpgroups a block) are timed by
``kernel_variants.py``.

Each phase prints one line of numbers.  Before the last line come the card's
name and power limit (``nvidia-smi``) and one JSON object with every kernel's
route, source, launch count on the main paths, error, times and bound at
16384 walkers, and its time and bound at its main path's shape
(``main_path``); the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
1 and prints no result.
"""

from __future__ import annotations

import json
import logging
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
RECIPE = REPO / "example" / "omega_cen_fixed.json"
CENTER_RECIPE = REPO / "example" / "omega_cen_center.json"
GOLDENS = REPO / "example" / "goldens" / "omega_cen_goldens.json"

# the reference's validate-gate tolerances (bench.py: direct kernel, table tier)
DIRECT_TOL = dict(rtol=2e-4, atol=5e-2)
TENSOR_TOL = dict(rtol=2e-4, atol=0.5)
# kernel 10: a log-likelihood of order -5 per target; float32 sums up to 2048
# terms per thread (relative rounding <= 2048 x 2^-24 = 1.2e-4 in the worst
# case, ~1e-6 in practice) and rounds each exponent -(v_i - c_j)^2 / (2 n_i):
# an absolute 1e-3 on the log is 8x the worst-case sum error
BACKGROUND_TOL = dict(rtol=1e-5, atol=1e-3)
CANONICAL = ["v_sys", "sigma_max", "a", "v_maxx", "v_maxy", "r_peak"]

# the least time for a kernel's work on an H100 SXM at its 700 W limit
# (NVIDIA's H100 data sheet): HBM3 at 3.35 TB/s, 67
# TFLOP/s FP32 outside the tensor cores, and the special-function unit at 16
# operations per clock per SM (CUDA programming guide, compute capability 9.0)
# x 132 SMs x 1.98 GHz boost = 4.18e12 rsqrt/log/exp/sin per second
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9
# (FP32 flops, SFU operations) per (walker, star) or (target, catalog) pair,
# counted from each kernel's source (an FMA is two flops)
# (an IEEE division, or a reciprocal and its product, as one reciprocal on the
# unit and its refinement, 8 flops; each log, exp, log1p and rsqrt as one
# operation on the unit).  The double models take u = x / r_peak per
# component, so that no r_peak^2 is formed (finite in float32 at any r_peak);
# kernels 1, 3, 6 and 13 scale q per walker, which adds nothing to a pair
PAIR_COST = {"model_lnlike": (18, 3), "model_freecenter": (36, 3),
             "constant_mixture": (17, 4), "constant_gb": (30, 7),
             "model_mixture": (37, 8), "model_mixture_lnb": (30, 6),
             "double_model": (47, 5), "double_model_gb": (62, 10),
             "background_lse": (10, 1),
             # kernels 12 and 13: three logs/exps a pair, a quarter log for
             # the product of four nb and a half for the two products of
             # D + f, and one reciprocal, of n nb (13: of q^2 n nb, beside
             # the Plummer rsqrt), which all of the pair's divisions share:
             # the least the function needs, and what both kernels' SASS
             # issues (sass_pair_counts.py); the flops counted from the
             # source as written, each MUFU function's scaling multiply
             # included
             "constant_gb_v2": (34.25, 4.75), "model_gb_v2": (44.25, 5.75)}
# r_peak of the walkers that each walker x star phase adds: float32 overflows
# the TPU kernels' q^2 from ~1.8e19 and their double models' 2 r_peak v_max
# near 1e37
LARGE_R_PEAK = (1e19, 1e20, 1e37)


def bound_ms(n_bytes, flops, sfu):
    """(least ms, what bounds it): bytes moved once over the memory rate
    against the operations over their peak rates."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / FP32_FLOPS_PER_S, sfu / SFU_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` in ms.

    CUDA events bracket each call, and all calls are queued behind a spin
    kernel (~50 ms), so the host's time to issue a call (Python, argument
    checks, launch latency) is not counted: a small kernel is timed by what
    the device spends on it, not by the host between two events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)           # clock cycles: ~50 ms at 2 GHz
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def compare(name, got, ref, rtol, atol) -> float:
    """Kernel output against its plain version: same -inf pattern, no NaN,
    finite values within tolerance.  Returns the max absolute error."""
    got = got.double().cpu().numpy()
    ref = ref.double().cpu().numpy()
    if np.isnan(got).any():
        raise AssertionError(f"{name}: kernel returned NaN")
    fin = np.isfinite(ref)
    if not (np.isfinite(got) == fin).all():
        raise AssertionError(f"{name}: -inf pattern differs from the plain version")
    np.testing.assert_allclose(got[fin], ref[fin], rtol=rtol, atol=atol,
                               err_msg=name)
    return float(np.max(np.abs(got[fin] - ref[fin]))) if fin.any() else 0.0


# ----------------------------------------------------------------------------- phases
def phase_environment():
    import torch

    from mcmc_dynamics_tpu_torch.ops._build import build_library, find_nvcc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0] if smi else "unknown"
    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    info = build_library()
    ptxas = [ln.strip() for ln in info.log.splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    print(f"phase 1 environment: torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} | nvidia-smi: {smi} | {nvcc} | "
          f"kernel build {info.seconds:.2f} s")
    for ln in ptxas:
        print(f"  {ln}")
    return smi


def direct_inputs(device):
    """Kernel 1's inputs at a (walkers, stars, masked tail) shape: random
    params and a star table with a masked zero padding tail; walker 0 has
    sigma_max = 0 and walker 1 has a = 0 (prior-legal boundaries), and
    walkers 2-4 r_peak 1e19, 1e20 and 1e37 (``LARGE_R_PEAK``)."""
    def make(shape):
        n_walkers, n_stars, n_pad = shape
        rng = np.random.default_rng(n_walkers)
        params = np.column_stack([
            rng.uniform(-5, 5, n_walkers), rng.uniform(5, 30, n_walkers),
            rng.uniform(0.5, 10, n_walkers), rng.uniform(-10, 10, n_walkers),
            rng.uniform(-10, 10, n_walkers), rng.uniform(0.5, 10, n_walkers)])
        params[0, 1] = 0.0
        params[1, 2] = 0.0
        params[2:5, 5] = LARGE_R_PEAK
        dxm, dym = rng.normal(0, 3, (2, n_stars))
        v = 10 * rng.normal(size=n_stars)
        verr2 = rng.uniform(0.5, 2.0, n_stars) ** 2
        stars = _padded(n_stars, n_pad, dxm, dym, dxm * dxm + dym * dym, v, verr2)
        return _on(device, params, *stars), {}, {}, n_walkers * n_stars
    return make


def mock_catalog(n_stars, seed):
    """Paths B and H's mock catalog (``make_mock_cluster``: sigma_max 12 km/s,
    v_max 6 km/s, r_peak 60 and a 30 arcsec) as ``{name: (values, unit)}``
    numpy columns, and its truth."""
    from mcmc_dynamics_tpu_torch import make_mock_cluster

    data, truth = make_mock_cluster(n_stars=n_stars, sigma_max=12.0, v_max=6.0,
                                    theta_0=0.8, r_peak=60.0, a=30.0, seed=seed)
    table = data.data
    columns = {name: (table.value(name), table.units[name].name)
               for name in ("ra", "dec", "v", "verr")}
    return columns, truth


def mock_params(parameters, truth, bounded):
    """Paths B and H's priors (centre fixed at the truth, sigma_max <= 60 km/s)
    and near-truth initials on ``parameters`` (either package's).  With
    ``bounded`` a and r_peak get finite priors enclosing the truth (the tensor
    tier's box, path B); without, they keep the parameter file's unbounded
    ones (the binned tier, path H)."""
    parameters["ra_center"].set(value=truth["ra_center"], fixed=True)
    parameters["dec_center"].set(value=truth["dec_center"], fixed=True)
    parameters["v_sys"].set(min=-20.0, max=20.0, initials="rng.normal(0, 0.5, size=n)")
    parameters["sigma_max"].set(max=60.0, initials="rng.uniform(10.8, 13.2, size=n)")
    parameters["v_maxx"].set(min=-30.0, max=30.0,
                             initials="rng.normal(loc=0, scale=2, size=n)")
    parameters["v_maxy"].set(min=-30.0, max=30.0,
                             initials="rng.normal(loc=0, scale=2, size=n)")
    box = dict(min=10.0, max=1000.0) if bounded else {}
    parameters["a"].set(initials="rng.uniform(24, 36, size=n)", **box)
    parameters["r_peak"].set(initials="rng.uniform(48, 72, size=n)", **box)
    return parameters


def mock_fit(device, n_stars, seed, bounded=True):
    """ModelFit on the mock catalog: path B (``bounded``, the tensor tier) or
    path H (the default unbounded a/r_peak priors, the binned tier)."""
    from mcmc_dynamics_tpu_torch.models import ModelFit

    columns, truth = mock_catalog(n_stars, seed)
    params = mock_params(ModelFit.default_parameters(), truth, bounded)
    return ModelFit(port_reader(columns), parameters=params, seed=seed,
                    device=device), truth


def box_params(stats, n_walkers, seed, device, dtype):
    """Walkers spread over the tensor tier's (sigma_max, a, r_peak) box."""
    import torch

    rng = np.random.default_rng(seed)
    p = np.column_stack([
        rng.uniform(-5, 5, n_walkers),
        rng.uniform(1.0, math.sqrt(stats.s_max) * 0.5, n_walkers),
        np.exp(rng.uniform(math.log(stats.a_lo), math.log(stats.a_hi), n_walkers)),
        rng.uniform(-15, 15, n_walkers), rng.uniform(-15, 15, n_walkers),
        np.exp(rng.uniform(math.log(stats.r_lo), math.log(stats.r_hi), n_walkers))])
    return torch.as_tensor(p, dtype=dtype, device=device)


def tensor_inputs(stats, device):
    """Kernel 2's walkers at a (walkers,) shape, as ``pair_kernel_phase``'s
    inputs give them (``box_params``)."""
    def make(shape):
        return [box_params(stats, shape[0], seed=7, device=device,
                           dtype=stats.table.dtype)], {}, {}, 0
    return make


def phase_tensor_kernel(device, fit, ensembles=(16384, 512)):
    """Kernel 2 at 16384 walkers and at path B's half-ensemble of 512,
    against its float64 plain version, and its batch invariance at 16384
    walkers; the tables against the exact star sum."""
    import torch

    from mcmc_dynamics_tpu_torch.ops import (model_lnlike_reference,
                                             model_tensor_lnlike)
    from mcmc_dynamics_tpu_torch.ops.model_tensor import tensor_chunks

    t0 = time.perf_counter()
    stats = fit.tensor_stats()
    build_s = time.perf_counter() - t0
    stats64 = stats.to(dtype=torch.float64)
    rows, probe = [], None
    for n_walkers in ensembles:
        params = tensor_inputs(stats, device)((n_walkers,))[0][0]
        if probe is None:
            probe = params[:256].double()
        got = model_tensor_lnlike(stats, params)
        torch.cuda.synchronize()
        ref = torch.cat([stats64.lnlike(p) for p in torch.split(params.double(), 4096)])
        err = compare(f"model_tensor W={n_walkers}", got, ref, **TENSOR_TOL)
        ms = cuda_ms(lambda: model_tensor_lnlike(stats, params))
        plain_ms = cuda_ms(lambda: stats.lnlike(params), reps=10)
        # the contraction dominates: 2 flops per table element and walker;
        # the tables, params and output are each moved once
        k, n_ch = stats.table.shape
        n_bytes = 4 * (k * n_ch + stats.u_s.numel() + stats.u_a.numel() + 7 * n_walkers)
        b_ms, b_by = bound_ms(n_bytes, 2.0 * k * n_ch * n_walkers, 0)
        rows.append(dict(W=n_walkers, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by))

    # the tables against the exact star sum (float64 direct plain version)
    dx, dy = fit.fixed_center_offsets()
    dx, dy = dx * (10800.0 / math.pi), dy * (10800.0 / math.pi)
    cols = [torch.as_tensor(c, dtype=torch.float64, device=device) for c in
            (dx, dy, dx * dx + dy * dy, fit.data.data.value("v", "km/s"),
             fit.data.data.value("verr", "km/s") ** 2, np.ones_like(dx))]
    exact = torch.cat([model_lnlike_reference(p, *cols) for p in torch.split(probe, 32)])
    tab_err = compare("tensor tables vs exact star sum", stats64.lnlike(probe),
                      exact, **TENSOR_TOL)
    s_rows, n_chunks = tensor_chunks(stats.u_s.shape[1], stats.u_a.shape[1])
    for row in rows:
        print(f"phase 3 kernel model_tensor W={row['W']} N={fit.n_data} table "
              f"{tuple(stats.table.shape)} ranks {tuple(stats.u_s.shape)}x"
              f"{tuple(stats.u_a.shape)} Dr {stats.n_r}, {n_chunks} row chunks of "
              f"{s_rows} s-ranks (host build {build_s:.2f} s): "
              f"max_abs_err {row['max_abs_err']:.4g} vs float64 plain (rtol "
              f"{TENSOR_TOL['rtol']}, atol {TENSOR_TOL['atol']}) | tables vs exact "
              f"star sum {tab_err:.4g} | kernel {row['ms']:.4f} ms | plain f32 "
              f"{row['plain_ms']:.4f} ms | bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})")
    batch_invariance(3, "model_tensor", lambda p: model_tensor_lnlike(stats, p),
                     tensor_inputs(stats, device), (ensembles[0],))
    return rows, stats


def read_catalog(cfg):
    """A recipe's bundled catalog (v_sys subtracted), read with numpy."""
    from mcmc_dynamics_tpu_torch import DataReader, units as u

    path = REPO / cfg["data"]["file"]
    header = path.read_text().splitlines()[0].split(",")
    table = np.loadtxt(path, delimiter=",", skiprows=1)
    col = {name: table[:, i] for i, name in enumerate(header)}
    v_sys = float(cfg["data"].get("v_sys") or 0.0)
    return DataReader({"ra": u.Quantity(col["ra"], "deg"),
                       "dec": u.Quantity(col["dec"], "deg"),
                       "v": u.Quantity(col["v"] - v_sys, "km/s"),
                       "verr": u.Quantity(col["verr"], "km/s")})


def load_recipe(device, recipe=RECIPE, model="ModelFit"):
    """An omega Cen recipe as ``cli/run.py`` sets it up: the bundled catalog
    and the config's parameter specs on ``model``'s parameter file."""
    from mcmc_dynamics_tpu_torch import models

    cfg = json.loads(recipe.read_text())
    cls = getattr(models, model)
    params = cls.default_parameters()
    for name, spec in cfg["parameters"].items():
        params[name].set(**spec)
    sampling = cfg["sampling"]
    fit = cls(read_catalog(cfg), parameters=params, seed=sampling["seed"],
              device=device)
    return fit, sampling


def check_goldens(chain, n_burn, golden) -> dict:
    flat = chain[:, n_burn:, :].reshape(-1, chain.shape[-1])
    values = dict(zip(CANONICAL, np.median(flat, axis=0)))
    values["v_max"] = math.hypot(values["v_maxx"], values["v_maxy"])
    values["theta_0"] = math.atan2(values["v_maxy"], values["v_maxx"])
    for key, (lo, hi) in golden.items():
        if not lo <= values[key] <= hi:
            raise AssertionError(f"golden {key} = {values[key]:.4g} outside "
                                 f"[{lo}, {hi}]")
    return values


def run_with_resume(label, fit, n_walkers, n_steps, n_out, n_extra=50):
    """Sample ``n_steps`` with a checkpoint every ``n_out``, resume from the
    checkpoint for ``n_extra`` more, and check that an uninterrupted run of
    ``n_steps + n_extra`` is bitwise equal.  Returns (first run, seconds per
    step of the uninterrupted run)."""
    import torch

    pos = fit.get_initials(n_walkers)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = str(pathlib.Path(tmp) / "checkpoint")
        run = fit(n_walkers=n_walkers, n_steps=n_steps, n_out=n_out, pos=pos,
                  prefix=prefix)
        resumed = fit(state=fit.load_state(prefix + "_chain.npz"), n_steps=n_extra,
                      prefix=None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole = fit(n_walkers=n_walkers, n_steps=n_steps + n_extra, pos=pos, prefix=None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not (np.array_equal(whole.chain[:, :n_steps], run.chain)
            and np.array_equal(whole.chain[:, n_steps:], resumed.chain)
            and np.array_equal(whole.lnprobability[:, n_steps:],
                               resumed.lnprobability)):
        raise AssertionError(f"path {label}: checkpoint resume is not bitwise "
                             "equal to the uninterrupted run")
    return run, seconds / (n_steps + n_extra)


def phase_recipe(device):
    """Main path A; returns its numbers."""
    fit, sampling = load_recipe(device)
    if fit.lnprob_tier() != "direct":
        raise AssertionError(f"recipe tier {fit.lnprob_tier()}, expected direct")
    n_walkers, n_steps = sampling["n_walkers"], sampling["n_steps"]
    n_burn = sampling["n_burn"]
    run, s_per_step = run_with_resume("A", fit, n_walkers, n_steps, sampling["n_out"])

    golden = json.loads(GOLDENS.read_text())["omega_cen_fixed"]
    values = check_goldens(run.chain, n_burn, golden)
    best = fit.compute_bestfit_values(run.chain, n_burn=n_burn)
    profile = fit.create_profiles(run.chain, n_burn=n_burn)
    theta = fit.compute_theta_vmax(run.chain, n_burn=n_burn)
    for name in ("v_rot", "v_rot_lower_1s", "sigma", "sigma_upper_3s"):
        if not np.isfinite(profile.value(name)).all():
            raise AssertionError(f"profile column {name} not finite")
    if theta is None or not np.isfinite(theta.value("v_max")).all():
        raise AssertionError("compute_theta_vmax failed")
    if not np.isfinite(best.value("sigma_max")).all():
        raise AssertionError("compute_bestfit_values not finite")
    acc = float(np.mean(run.acceptance_fraction))
    return dict(stars=fit.n_data, walkers=n_walkers, steps=n_steps,
                s_per_step=s_per_step, acceptance=acc, medians=values, chain=run.chain)


def phase_table_path(device, fit, truth, tier, n_walkers=1024, n_steps=200):
    """Main path B (``tier`` "tensor") or H ("sufficient"); returns its
    numbers."""
    import torch

    if fit.lnprob_tier() != tier:
        raise AssertionError(f"tier {fit.lnprob_tier()}, expected {tier}")
    pos = fit.get_initials(n_walkers)
    t0 = time.perf_counter()
    fit.batched_lnprob()                    # set-up: the tables, built once
    setup_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = fit(n_walkers=n_walkers, n_steps=n_steps, pos=pos, prefix=None)
    if device.type == "cuda":
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    tail = run.chain[:, n_steps // 2:, :].reshape(-1, run.chain.shape[-1])
    med = dict(zip(CANONICAL, np.median(tail, axis=0)))
    if abs(med["v_sys"] - truth["v_sys"]) > 0.5:
        raise AssertionError(f"v_sys median {med['v_sys']:.4g} vs truth "
                             f"{truth['v_sys']}")
    if abs(med["sigma_max"] / truth["sigma_max"] - 1.0) > 0.05:
        raise AssertionError(f"sigma_max median {med['sigma_max']:.4g} vs "
                             f"truth {truth['sigma_max']}")
    evals = n_walkers * n_steps            # one lnprob per walker per step
    return dict(stars=fit.n_data, walkers=n_walkers, steps=n_steps,
                setup_s=setup_s, s_per_step=run_s / n_steps,
                evals_per_s=evals / run_s,
                acceptance=float(np.mean(run.acceptance_fraction)), medians=med)


# ----------------------------------------------------------------------------- slice 2
def pair_kernel_phase(phase, name, run, plain, inputs, shapes, tol, rows_k, cols_k,
                      split=True):
    """A walker x star (or target x catalog) kernel against its float64
    plain version at each (size, partner size, masked tail) of ``shapes``.

    ``inputs(shape)`` gives (args32, kwargs, kwargs of the float64 plain
    version, unmasked pair count); the float64 arguments are the float32
    ones upcast, so both see the same inputs.  With ``split`` the float64
    plain version runs on slices of 2048 of the first argument (walkers).
    ``rows_k``/``cols_k``: the partner rows and per-item columns the kernel
    reads (for the bound)."""
    import torch

    rows = []
    for shape in shapes:
        a32, kw, kw64, pairs = inputs(shape)
        a64 = [t.double() for t in a32]
        got = run(*a32, **kw)
        torch.cuda.synchronize()
        if split:
            ref = torch.cat([plain(p, *a64[1:], **kw64)
                             for p in torch.split(a64[0], 2048)])
        else:
            ref = plain(*a64, **kw64)
        label = f"{name} {shape[0]} x {shape[1] + shape[2]}"
        err = compare(label, got, ref, **tol)
        ms = cuda_ms(lambda: run(*a32, **kw))
        plain_ms = cuda_ms(lambda: plain(*a32, **kw), reps=10)
        flops, sfu = PAIR_COST[name]
        n_items, n_partners = shape[0], shape[1] + shape[2]
        b_ms, b_by = bound_ms(4 * ((cols_k + 1) * n_items + rows_k * n_partners),
                              flops * pairs, sfu * pairs)
        print(f"phase {phase} kernel {label} (masked or ragged tail {shape[2]}): "
              f"max_abs_err {err:.4g} vs float64 plain (rtol {tol['rtol']}, atol "
              f"{tol['atol']}) | kernel {ms:.4f} ms | plain f32 {plain_ms:.4f} ms "
              f"| bound {b_ms:.4f} ms ({b_by})")
        rows.append(dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by))
    return rows


def batch_invariance(phase, name, run, inputs, shape, n_alone=128):
    """A walker's value does not depend on its batch (what a bitwise resume
    rests on): walkers 0 .. n_alone - 1 of the ``shape`` batch (the wide
    walker tile) evaluated alone (2-walker tiles) give the same bits, and so
    does a second call."""
    import torch

    a32, kw, _, _ = inputs(shape)
    whole, again = run(*a32, **kw), run(*a32, **kw)
    alone = run(a32[0][:n_alone].contiguous(), *a32[1:], **kw)
    torch.cuda.synchronize()
    if not torch.equal(whole.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    if not torch.equal(whole[:n_alone].view(torch.int32), alone.view(torch.int32)):
        raise AssertionError(f"{name}: walkers 0-{n_alone - 1} of a {shape[0]}-walker "
                             "batch differ from the same walkers alone")
    print(f"phase {phase} kernel {name}: batch invariance ok (walkers 0-{n_alone - 1} of "
          f"{size_label(shape)} alone bitwise equal; two calls bitwise equal)")


def size_label(shape):
    """"walkers x stars" of a (walkers, stars, masked tail) shape, or "W
    walkers" of a table kernel's (walkers,)."""
    return f"{shape[0]} x {shape[1] + shape[2]}" if len(shape) == 3 else \
        f"{shape[0]} walkers"


def _on(device, *arrays):
    import torch

    return [torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32,
                            device=device) for a in arrays]


def _padded(n, n_pad, *cols):
    """Star columns with a masked tail of zero padding, and the mask."""
    out = []
    for c in cols + (np.ones(n),):
        full = np.zeros(n + n_pad)
        full[:n] = c
        out.append(full)
    return out


def freecenter_inputs(device):
    """Kernel 3 at omega Cen's position: stars within ~6 arcmin, walkers
    within ~1 arcmin of the reference centre and one 5 degrees off; walker 0
    has sigma_max = 0, walker 1 a = 0 and walkers 2-4 r_peak 1e19, 1e20 and
    1e37."""
    def make(shape):
        n_walkers, n_stars, n_pad = shape
        rng = np.random.default_rng(n_walkers)
        arcmin_per_rad = 10800.0 / math.pi
        ra_c0, dec_c0 = math.radians(201.697), math.radians(-47.48)
        ra = ra_c0 + 1.7e-3 * rng.normal(size=n_stars)
        dec = dec_c0 + 1.7e-3 * rng.normal(size=n_stars)
        ra0, dec0 = float(np.median(ra)), float(np.median(dec))
        s0, c0 = math.sin(dec0), math.cos(dec0)
        d = ra - ra0
        pm = arcmin_per_rad * np.cos(dec) * np.cos(d)
        qm = arcmin_per_rad * np.cos(dec) * np.sin(d)
        sm = arcmin_per_rad * np.sin(dec)
        stars = _padded(n_stars, n_pad, -qm, sm * c0 - pm * s0, pm, qm,
                        sm * s0 + pm * c0, 10 * rng.normal(size=n_stars),
                        rng.uniform(0.5, 2.0, n_stars) ** 2)
        params = np.column_stack([
            rng.uniform(-5, 5, n_walkers), rng.uniform(5, 30, n_walkers),
            rng.uniform(0.5, 10, n_walkers), rng.uniform(-10, 10, n_walkers),
            rng.uniform(-10, 10, n_walkers), rng.uniform(0.5, 10, n_walkers),
            3e-4 * rng.normal(size=n_walkers), 3e-4 * rng.normal(size=n_walkers)])
        params[0, 1] = 0.0
        params[1, 2] = 0.0
        params[2:5, 5] = LARGE_R_PEAK
        params[-1, 6:] = math.radians(5.0), math.radians(-5.0)
        kw = dict(s0=s0, c0=c0)
        return _on(device, params, *stars), kw, kw, n_walkers * n_stars
    return make


def constant_inputs(device, gb):
    """Kernels 4 and 5: a 1e4-star table of unit position vectors, Gaussian
    velocities and errors; walker 0 has sigma_max = 0.  Kernel 4 adds the
    membership logs and a Gaussian field's lnL; kernel 5 a density column
    with one zero density (clamped to 1e-300, 0 in float32) and walkers 2
    and 3 at f_back = 0, and holds the float64 plain version to the float32
    normaliser clamp."""
    import torch

    def make(shape):
        n_walkers, n_stars, n_pad = shape
        rng = np.random.default_rng(n_walkers + 1)
        phi = rng.uniform(-math.pi, math.pi, n_stars)
        v = 10 * rng.normal(size=n_stars)
        verr2 = rng.uniform(0.5, 2.0, n_stars) ** 2
        params = np.column_stack([
            rng.uniform(-5, 5, n_walkers), rng.uniform(5, 30, n_walkers),
            rng.uniform(-10, 10, n_walkers), rng.uniform(-10, 10, n_walkers)])
        params[0, 1] = 0.0
        if gb:
            density = np.maximum(10.0 ** rng.uniform(-1, 2, n_stars), 1e-300)
            density[3] = 1e-300
            extra = (density, np.log(density))
            params = np.column_stack([
                params, rng.normal(40, 5, n_walkers), rng.uniform(30, 70, n_walkers),
                10.0 ** rng.uniform(-1, 1, n_walkers)])
            params[2:4, 6] = 0.0
            kw, kw64 = {}, dict(tiny=float(torch.finfo(torch.float32).tiny))
        else:
            pmember = rng.uniform(0.05, 0.95, n_stars)
            lnb = -0.5 * (np.log(2 * math.pi * (verr2 + 2500.0))
                          + (v - 40.0) ** 2 / (verr2 + 2500.0))
            extra = (np.log(pmember), np.log1p(-pmember) + lnb)
            kw, kw64 = {}, {}
        stars = _padded(n_stars, n_pad, np.cos(phi), np.sin(phi), v, verr2, *extra)
        args = _on(device, params, *stars)
        return args, kw, kw64, n_walkers * n_stars
    return make


def constant_mixture_split(params, gx, gy, v, verr2, lgp, lgb, mask):
    """Kernel 4's wrapper fed the precombined background branch (its
    ``lg1mp + lnb`` is ``0 + lgb``)."""
    from mcmc_dynamics_tpu_torch.ops import constant_mixture_lnlike_batched

    return constant_mixture_lnlike_batched(params, gx, gy, v, verr2, lgp,
                                           lgb.new_zeros(()), lgb, mask)


def background_inputs(device):
    """Kernel 10 on path E2's problem: (catalog, targets, errors) with
    targets from a cluster + field mixture, errors as the members', a field
    catalog of N(40, 50^2) draws and sigma_int = 0 (SingleStars' default)."""
    def make(shape):
        n_targets, n_catalog, _ = shape
        rng = np.random.default_rng(n_catalog)
        v = np.where(rng.random(n_targets) < 0.8, rng.normal(0, 12, n_targets),
                     rng.normal(40, 50, n_targets))
        verr = 1.2 * rng.lognormal(0.0, 0.5, n_targets)
        args = _on(device, rng.normal(40, 50, n_catalog), v, verr)
        return args, {}, {}, n_targets * n_catalog
    return make


def kde_far_and_repeat(device, shape=(20_480, 8192, 0), n_far=64):
    """Phase 9's further checks of kernel 10 on ``background_inputs``: the
    first ``n_far`` targets moved 15-30.5 km/s past the catalog's edges with
    1 km/s errors, where every exponent is below -104 (a float32 sum of exp
    without the max shift underflows to 0 there, its log to -inf), against
    the float64 plain version; and two calls give the same bits."""
    import torch

    from mcmc_dynamics_tpu_torch.ops import (background_logsumexp,
                                             background_logsumexp_reference)

    (catalog, v, verr), _, _, _ = background_inputs(device)(shape)
    step = torch.arange(n_far // 2, dtype=torch.float32, device=device) * 0.5
    v = v.clone()
    v[:n_far] = torch.cat([catalog.max() + 15.0 + step, catalog.min() - 15.0 - step])
    verr = verr.clone()
    verr[:n_far] = 1.0
    expo = -(catalog[None, :] - v[:n_far, None]) ** 2 / (2.0 * verr[:n_far, None] ** 2)
    if float(expo.max()) >= -104.0:
        raise AssertionError(f"far targets: largest exponent {float(expo.max())}")
    unshifted = torch.log(torch.exp(expo).sum(dim=1))
    if not torch.isneginf(unshifted).all():
        raise AssertionError("far targets: float32 sum without the shift is finite")
    got, again = background_logsumexp(catalog, v, verr), background_logsumexp(catalog, v, verr)
    torch.cuda.synchronize()
    ref = background_logsumexp_reference(catalog.double(), v.double(), verr.double())
    err = compare("background_lse with far targets", got, ref, **BACKGROUND_TOL)
    far_err = float((got[:n_far].double() - ref[:n_far]).abs().max())
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError("background_lse: two calls on the same inputs differ")
    print(f"phase 9 kernel background_lse {size_label(shape)} with {n_far} far targets "
          f"(largest exponent {float(expo.max()):.1f}; float32 without the shift: -inf): "
          f"max_abs_err {err:.4g} ({far_err:.4g} on the far targets, lnL "
          f"{float(ref[:n_far].min()):.1f} to {float(ref[:n_far].max()):.1f}) vs float64 "
          f"plain (rtol {BACKGROUND_TOL['rtol']}, atol {BACKGROUND_TOL['atol']}) | two "
          f"calls bitwise equal")


def medians(chain, names, n_burn):
    flat = chain[:, n_burn:, :].reshape(-1, chain.shape[-1])
    return dict(zip(names, (float(x) for x in np.median(flat, axis=0))))


def timed_run(fit, **kw):
    """``fit(...)`` between two synchronisations: (result, seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = fit(**kw)
    torch.cuda.synchronize()
    return run, time.perf_counter() - t0


def check_band(label, values, golden):
    for key, (lo, hi) in golden.items():
        if not lo <= values[key] <= hi:
            raise AssertionError(f"{label}: {key} = {values[key]:.5g} outside "
                                 f"[{lo}, {hi}]")


def phase_center_recipe(device):
    """Main path C: example/omega_cen_center.json through ConstantFit's
    generic tier (a sampled centre), medians in its golden bands."""
    fit, sampling = load_recipe(device, CENTER_RECIPE, "ConstantFit")
    if fit.lnprob_tier() != "generic":
        raise AssertionError(f"path C tier {fit.lnprob_tier()}, expected generic")
    n_walkers, n_steps = sampling["n_walkers"], sampling["n_steps"]
    pos = fit.get_initials(n_walkers)
    run, seconds = timed_run(fit, n_walkers=n_walkers, n_steps=n_steps, pos=pos,
                             prefix=None)
    values = medians(run.chain, fit.fitted_parameters, sampling["n_burn"])
    check_band("path C", values, json.loads(GOLDENS.read_text())["omega_cen_center"])
    return dict(stars=fit.n_data, walkers=n_walkers, steps=n_steps,
                s_per_step=seconds / n_steps, evals_per_s=n_walkers * n_steps / seconds,
                acceptance=float(np.mean(run.acceptance_fraction)), medians=values)


# path D holds sigma_max to the fixed-centre band: a float64 CPU run of the
# JAX package on the same set-up meets it, and misses the v_sys band (the
# sampled centre shifts v_sys through the rotation field), so v_sys is left
# out (chip_smoke_reference.py)
FREECENTER_FIXED_KEYS = ("sigma_max",)


def freecenter_fit(device):
    """Path D's fit: the omega Cen catalog, the kinematic specs of
    omega_cen_fixed.json and the centre specs of omega_cen_center.json, both
    centre coordinates sampled."""
    from mcmc_dynamics_tpu_torch.models import ModelFit

    fixed = json.loads(RECIPE.read_text())
    center = json.loads(CENTER_RECIPE.read_text())
    params = ModelFit.default_parameters()
    for name, spec in fixed["parameters"].items():
        if name not in ("ra_center", "dec_center"):
            params[name].set(**spec)
    for name in ("ra_center", "dec_center"):
        params[name].set(fixed=False, **center["parameters"][name])
    sampling = fixed["sampling"]
    fit = ModelFit(read_catalog(fixed), parameters=params, seed=sampling["seed"],
                   device=device)
    return fit, sampling


def phase_freecenter_path(device):
    """Main path D: the free-centre ModelFit through kernel 3, checkpointed
    and resumed bit for bit."""
    fit, sampling = freecenter_fit(device)
    if fit.lnprob_tier() != "freecenter":
        raise AssertionError(f"path D tier {fit.lnprob_tier()}, expected freecenter")
    n_walkers, n_steps = sampling["n_walkers"], sampling["n_steps"]
    run, s_per_step = run_with_resume("D", fit, n_walkers, n_steps, sampling["n_out"])
    values = medians(run.chain, fit.fitted_parameters, sampling["n_burn"])
    goldens = json.loads(GOLDENS.read_text())
    check_band("path D", values, {k: v for k, v in goldens["omega_cen_center"].items()
                                  if k in ("ra_center", "dec_center")})
    check_band("path D", values, {k: goldens["omega_cen_fixed"][k]
                                  for k in FREECENTER_FIXED_KEYS})
    return dict(stars=fit.n_data, walkers=n_walkers, steps=n_steps,
                s_per_step=s_per_step, evals_per_s=n_walkers / s_per_step,
                acceptance=float(np.mean(run.acceptance_fraction)), medians=values)


# path E: a contaminated catalog.  The truth and the bounds the fits are held
# to; a float64 CPU run of the JAX package on the same catalog
# (chip_smoke_reference.py) lands well inside them.
E_TRUTH = dict(v_sys=0.0, sigma_max=12.0, v_back=40.0, sigma_back=50.0, f_back=1.0)
TRUTH_BOUNDS = dict(v_sys=("abs", 0.5), sigma_max=("rel", 0.05), v_back=("abs", 3.0),
                    sigma_back=("rel", 0.10), v_max=("abs", 1.0))


def contaminated_catalog(seed=21, n_members=16384, n_field=4096,
                         n_field_catalog=8192, v_max=0.0, a=1e6, theta_0=None):
    """Path E's catalog, as numpy columns: ``make_mock_cluster`` members with a
    near-constant dispersion (a = 1e6 arcsec) and no rotation, plus field
    stars uniform over the same disk (r < 300 arcsec) with v ~ N(40, 50^2) and
    errors drawn as the members' are.  ``density`` is the members' surface
    density at the star's radius over the field's, so the true f_back is 1;
    ``pmember`` is density / (density + 1).  Also returns ``n_field_catalog``
    fresh draws of the field's velocity law (the SingleStars catalog).  Paths
    F and G pass rotating members (``v_max``, ``a``, ``theta_0``)."""
    from math import erf

    from mcmc_dynamics_tpu_torch import make_mock_cluster

    data, truth = make_mock_cluster(n_stars=n_members, sigma_max=12.0, v_max=v_max,
                                    a=a, theta_0=theta_0, seed=seed)
    table = data.data
    ra_c, dec_c = truth["ra_center"], truth["dec_center"]
    r_max = truth["r_peak"] * 5.0                     # make_mock_cluster's cut
    rng = np.random.default_rng(seed + 1)
    r_f = r_max * np.sqrt(rng.random(n_field))
    phi = rng.uniform(-math.pi, math.pi, n_field)
    ra_f = ra_c - (r_f / 3600.0) * np.cos(phi) / math.cos(math.radians(dec_c))
    dec_f = dec_c + (r_f / 3600.0) * np.sin(phi)
    sigma_los = 12.0 / (1.0 + (r_f / a) ** 2) ** 0.25
    verr_f = 0.1 * sigma_los * rng.lognormal(0.0, 0.5, size=n_field)
    v_f = rng.normal(40.0, 50.0, n_field) + verr_f * rng.normal(size=n_field)
    ra = np.concatenate([table.value("ra", "deg"), ra_f])
    dec = np.concatenate([table.value("dec", "deg"), dec_f])
    # radius from the placement formula, inverted exactly (arcsec)
    r = 3600.0 * np.hypot((ra_c - ra) * math.cos(math.radians(dec_c)), dec - dec_c)
    # members: radii half-normal of scale r_max / 2 truncated at r_max
    scale = r_max / 2.0
    pdf_r = (2.0 / (scale * math.sqrt(2 * math.pi)) * np.exp(-0.5 * (r / scale) ** 2)
             / erf(r_max / (scale * math.sqrt(2.0))))
    sigma_members = n_members * pdf_r / (2.0 * math.pi * np.maximum(r, 1e-3))
    sigma_field = n_field / (math.pi * r_max ** 2)
    density = sigma_members / sigma_field
    columns = {"ra": (ra, "deg"), "dec": (dec, "deg"),
               "v": (np.concatenate([table.value("v", "km/s"), v_f]), "km/s"),
               "verr": (np.concatenate([table.value("verr", "km/s"), verr_f]), "km/s"),
               "density": (density, None), "pmember": (density / (density + 1.0), None)}
    field_catalog = rng.normal(40.0, 50.0, n_field_catalog)
    return columns, field_catalog, dict(truth, **E_TRUTH)


def contaminated_params(parameters, gb):
    """Priors and initial walkers of path E's fits (centre fixed at truth)."""
    parameters["ra_center"].set(value=56.345, fixed=True)
    parameters["dec_center"].set(value=-26.675, fixed=True)
    parameters["v_sys"].set(min=-20.0, max=20.0, initials="rng.normal(0, 1, size=n)")
    parameters["sigma_max"].set(max=60.0, initials="rng.uniform(8, 16, size=n)")
    for name in ("v_maxx", "v_maxy"):
        parameters[name].set(min=-30.0, max=30.0, initials="rng.normal(0, 1, size=n)")
    if gb:
        parameters["v_back"].set(min=-100.0, max=200.0,
                                 initials="rng.uniform(20, 60, size=n)")
        parameters["sigma_back"].set(max=200.0, initials="rng.uniform(30, 70, size=n)")
        parameters["f_back"].set(max=5.0, initials="rng.uniform(0.5, 2, size=n)")
    return parameters


def check_truth(label, values, truth, keys):
    for key in keys:
        kind, tol = TRUTH_BOUNDS[key]
        off = values[key] - truth[key]
        if (abs(off) if kind == "abs" else abs(off / truth[key])) > tol:
            raise AssertionError(f"{label}: {key} median {values[key]:.5g} vs truth "
                                 f"{truth[key]} (bound {kind} {tol})")


def port_reader(columns):
    """The port's DataReader of ``{name: (values, unit or None)}`` columns."""
    from mcmc_dynamics_tpu_torch import DataReader, units as u

    return DataReader({name: (u.Quantity(values, unit) if unit else values)
                       for name, (values, unit) in columns.items()})


def phase_contaminated(device, path, columns, field_catalog, truth, n_walkers=256,
                       n_steps=400):
    """Main path E1 (ConstantFitGB through kernel 5) or E2 (ConstantFit with a
    SingleStars background: kernel 10 at construction, kernel 4 after)."""
    from mcmc_dynamics_tpu_torch.background import SingleStars
    from mcmc_dynamics_tpu_torch.models import ConstantFit, ConstantFitGB

    gb = path == "E1"
    data = port_reader({n: c for n, c in columns.items() if gb or n != "density"})
    t0 = time.perf_counter()
    if gb:
        fit = ConstantFitGB(data, parameters=contaminated_params(
            ConstantFitGB.default_parameters(), gb=True), seed=22, device=device)
        tier = "gb"
    else:
        fit = ConstantFit(data, parameters=contaminated_params(
            ConstantFit.default_parameters(), gb=False), seed=23, device=device,
            background=SingleStars(field_catalog, device=device))
        tier = "mixture"
    setup_s = time.perf_counter() - t0
    if fit.lnprob_tier() != tier:
        raise AssertionError(f"path {path} tier {fit.lnprob_tier()}, expected {tier}")
    pos = fit.get_initials(n_walkers)
    run, seconds = timed_run(fit, n_walkers=n_walkers, n_steps=n_steps, pos=pos,
                             prefix=None)
    values = medians(run.chain, fit.fitted_parameters, n_steps // 2)
    keys = ("v_sys", "sigma_max") + (("v_back", "sigma_back") if gb else ())
    check_truth(f"path {path}", values, truth, keys)
    return dict(stars=fit.n_data, walkers=n_walkers, steps=n_steps, setup_s=setup_s,
                s_per_step=seconds / n_steps, evals_per_s=n_walkers * n_steps / seconds,
                acceptance=float(np.mean(run.acceptance_fraction)), medians=values,
                fit=fit)


# ----------------------------------------------------------------------------- slice 3
def radial_inputs(device, kind):
    """Kernels 6, 7 and 8 (``kind``: "model_mixture", "model_mixture_lnb",
    "double_model" or "double_model_gb"): star offsets within ~5 arcmin,
    Gaussian velocities and errors; walker 0 has sigma_max = 0 and walker 1
    a = 0.  The mixtures add a density column with one zero density (clamped
    to 1e-300, 0 in float32), walkers 2 and 3 at f_back = 0 and a float32
    normaliser clamp for the float64 plain version.  The prior allows any
    r_peak: the mixtures give walkers 5-7 r_peak 1e19, 1e20 and 1e37; the
    double models give walker 4 a second component at v_max = 0, walkers 5,
    7 and 8 a first component at r_peak 1e20, 1e19 and 1e37, walker 6 both at
    1e13 (the product of their x^2 + r_peak^2 would overflow float32),
    walker 9 both at 3e38 and walker 10 both at 1e-3."""
    import torch

    def make(shape):
        n_walkers, n_stars, n_pad = shape
        rng = np.random.default_rng(n_walkers + 2)
        dx, dy = rng.normal(0, 3, (2, n_stars))
        v = 10 * rng.normal(size=n_stars)
        verr2 = rng.uniform(0.5, 2.0, n_stars) ** 2
        w = n_walkers
        params = [rng.uniform(-5, 5, w), rng.uniform(5, 30, w), rng.uniform(0.5, 10, w),
                  rng.uniform(-10, 10, w), rng.uniform(-10, 10, w),
                  rng.uniform(0.5, 10, w)]
        if kind.startswith("double"):
            params += [rng.uniform(-5, 5, w), rng.uniform(-5, 5, w),
                       rng.uniform(0.2, 5, w)]
        kw, kw64, extra = {}, {}, ()
        if kind != "double_model":
            density = np.maximum(10.0 ** rng.uniform(-1, 2, n_stars), 1e-300)
            density[3] = 1e-300
            extra = (density, np.log(density))
            background = [rng.normal(40, 5, w), rng.uniform(30, 70, w),
                          10.0 ** rng.uniform(-1, 1, w)]
            params += background[2:] if kind == "model_mixture_lnb" else background
            kw64 = dict(tiny=float(torch.finfo(torch.float32).tiny))
        if kind.startswith("model_mixture"):
            lnb = -0.5 * (np.log(2 * math.pi * (verr2 + 2500.0))
                          + (v - 40.0) ** 2 / (verr2 + 2500.0))
            extra += (lnb,)
            kw = dict(parametric_bg=kind == "model_mixture")
            kw64.update(kw)
        params = np.column_stack(params)
        params[0, 1] = 0.0
        params[1, 2] = 0.0
        if kind != "double_model":
            params[2:4, -1] = 0.0
        if kind.startswith("double"):
            params[4, 6:8] = 0.0
            params[5, 5], params[7, 5], params[8, 5] = 1e20, 1e19, 1e37
            params[6, [5, 8]] = 1e13
            params[9, [5, 8]] = 3e38
            params[10, [5, 8]] = 1e-3
        else:
            params[5:8, 5] = LARGE_R_PEAK
        stars = _padded(n_stars, n_pad, dx, dy, dx * dx + dy * dy, v, verr2, *extra)
        return _on(device, params, *stars), kw, kw64, n_walkers * n_stars
    return make


def model_mixture_lnb(params, dxm, dym, r2, v, verr2, density, ln_density, lnb, mask,
                      **kw):
    """Kernel 6's wrapper with the fixed per-star background."""
    from mcmc_dynamics_tpu_torch.ops import model_mixture_lnlike_batched

    return model_mixture_lnlike_batched(params, dxm, dym, r2, v, verr2, density,
                                        ln_density, lnb, mask, parametric_bg=False)


# paths F and G2: path E's catalog with rotating members (seed 31)
F_CATALOG = dict(seed=31, v_max=6.0, a=30.0, theta_0=1.0)
# (model class, tier, seed, keys held to the truth) of each path
RADIAL_PATHS = {
    "F1": ("ModelFitGB", "model_mixture", 32,
           ("v_sys", "sigma_max", "v_max", "v_back", "sigma_back")),
    "F2": ("ModelFitConstantBackground", "model_mixture", 33,
           ("v_sys", "sigma_max", "v_max")),
    "G2": ("DoubleModelFitGB", "double_gb", 34,
           ("v_sys", "sigma_max", "v_back", "sigma_back")),
}


# F2's sigma_max is held, with the same bound, to the JAX package's float64
# median on the same set-up instead of the truth: that posterior sits 9 %
# under the truth (a = 51 arcsec instead of 30), after 400 steps as after 2000
# (chip_smoke_reference.py)
HELD_TO_REFERENCE = {"F2": dict(sigma_max=10.881)}


def second_component(parameters):
    """Priors and initial walkers of a double model's second component,
    inside the first (r_peak_c below every initial r_peak)."""
    for name in ("v_maxx_c", "v_maxy_c"):
        parameters[name].set(min=-30.0, max=30.0, initials="rng.normal(0, 1, size=n)")
    parameters["r_peak_c"].set(min=1.0, max=1000.0, initials="rng.uniform(5, 30, size=n)")
    return parameters


def radial_params(parameters, path):
    """Priors and initial walkers of paths F1, F2 and G2: path E's, finite
    a and r_peak priors around the truth; F2 holds the unused v_back and
    sigma_back fixed (its kernel layout); G2 keeps f_back <= 1 (its joint
    prior)."""
    contaminated_params(parameters, gb=path != "F2")
    parameters["a"].set(min=1.0, max=1000.0, initials="rng.uniform(20, 40, size=n)")
    parameters["r_peak"].set(min=1.0, max=1000.0, initials="rng.uniform(40, 80, size=n)")
    if path == "F2":
        parameters["v_back"].set(value=E_TRUTH["v_back"], fixed=True)
        parameters["sigma_back"].set(value=E_TRUTH["sigma_back"], fixed=True)
        parameters["f_back"].set(max=5.0, initials="rng.uniform(0.5, 2, size=n)")
    if path == "G2":
        second_component(parameters)
        parameters["f_back"].set(max=1.0, initials="rng.uniform(0.5, 1, size=n)")
    return parameters


def radial_fit(models, reader, path, columns, background=None, **kw):
    """Path F1, F2 or G2's fit through ``models`` (either package) on the
    ``columns`` read by ``reader``; ``background``: F2's field model."""
    name, _, seed, _ = RADIAL_PATHS[path]
    cls = getattr(models, name)
    data = reader({n: c for n, c in columns.items() if n != "pmember"})
    if path == "F2":
        kw["background"] = background
    return cls(data, parameters=radial_params(cls.default_parameters(), path),
               seed=seed, **kw)


def radial_medians(chain, names, n_burn):
    """Posterior medians, and that of v_max = hypot(v_maxx, v_maxy)."""
    flat = chain[:, n_burn:, :].reshape(-1, chain.shape[-1])
    out = dict(zip(names, (float(x) for x in np.median(flat, axis=0))))
    out["v_max"] = float(np.median(np.hypot(flat[:, names.index("v_maxx")],
                                            flat[:, names.index("v_maxy")])))
    return out


def phase_radial(device, path, columns, field_catalog, truth, n_walkers=256,
                 n_steps=400):
    """Main path F1 (ModelFitGB, kernel 6), F2 (ModelFitConstantBackground +
    SingleStars: kernel 10 at construction, kernel 6 after) or G2
    (DoubleModelFitGB, kernel 8); medians of the last half against the truth."""
    from mcmc_dynamics_tpu_torch import models
    from mcmc_dynamics_tpu_torch.background import SingleStars

    _, tier, _, keys = RADIAL_PATHS[path]
    t0 = time.perf_counter()
    background = SingleStars(field_catalog, device=device) if path == "F2" else None
    fit = radial_fit(models, port_reader, path, columns, background, device=device)
    setup_s = time.perf_counter() - t0
    if fit.lnprob_tier() != tier:
        raise AssertionError(f"path {path} tier {fit.lnprob_tier()}, expected {tier}")
    pos = fit.get_initials(n_walkers)
    run, seconds = timed_run(fit, n_walkers=n_walkers, n_steps=n_steps, pos=pos,
                             prefix=None)
    values = radial_medians(run.chain, fit.fitted_parameters, n_steps // 2)
    check_truth(f"path {path}", values, dict(truth, **HELD_TO_REFERENCE.get(path, {})),
                keys)
    return dict(stars=fit.n_data, walkers=n_walkers, steps=n_steps, setup_s=setup_s,
                s_per_step=seconds / n_steps, evals_per_s=n_walkers * n_steps / seconds,
                acceptance=float(np.mean(run.acceptance_fraction)),
                medians={k: values[k] for k in keys}, fit=fit)


# path G1 holds v_sys and sigma_max to the fixed-centre omega Cen bands: the
# JAX package's float64 run of the same set-up meets them
# (chip_smoke_reference.py)
DOUBLE_RECIPE_KEYS = ("v_sys", "sigma_max")


def double_recipe_params(parameters):
    """Path G1's priors: omega_cen_fixed.json's specs and a second
    component."""
    for name, spec in json.loads(RECIPE.read_text())["parameters"].items():
        parameters[name].set(**spec)
    return second_component(parameters)


def phase_double_recipe(device):
    """Main path G1: DoubleModelFit on the omega Cen catalog and centre of
    omega_cen_fixed.json through kernel 7, checkpointed and resumed bit for
    bit."""
    from mcmc_dynamics_tpu_torch.models import DoubleModelFit

    cfg = json.loads(RECIPE.read_text())
    sampling = cfg["sampling"]
    fit = DoubleModelFit(read_catalog(cfg), seed=sampling["seed"], device=device,
                         parameters=double_recipe_params(
                             DoubleModelFit.default_parameters()))
    if fit.lnprob_tier() != "double":
        raise AssertionError(f"path G1 tier {fit.lnprob_tier()}, expected double")
    n_walkers, n_steps = sampling["n_walkers"], sampling["n_steps"]
    run, s_per_step = run_with_resume("G1", fit, n_walkers, n_steps, sampling["n_out"])
    values = medians(run.chain, fit.fitted_parameters, sampling["n_burn"])
    golden = json.loads(GOLDENS.read_text())["omega_cen_fixed"]
    check_band("path G1", values, {k: golden[k] for k in DOUBLE_RECIPE_KEYS})
    profile = fit.create_profiles(run.chain, n_burn=sampling["n_burn"])
    if not np.isfinite(profile.value("v_rot")).all():
        raise AssertionError("path G1: create_profiles not finite")
    return dict(stars=fit.n_data, walkers=n_walkers, steps=n_steps,
                s_per_step=s_per_step, evals_per_s=n_walkers / s_per_step,
                acceptance=float(np.mean(run.acceptance_fraction)), medians=values,
                fit=fit)


# ----------------------------------------------------------------------------- slice 4
# bench.py --validate's gate for the matrix-unit form of the binned tier
# (model/sufficient-mxu); the tier itself is held to TENSOR_TOL
MXU_TOL = dict(rtol=2e-5, atol=0.05)
# kernel 11's tensor-core rate: TF32 at 495 TFLOP/s dense (NVIDIA's H100 SXM
# data sheet), a third of it for the three passes of 3xTF32
TF32X3_FLOPS_PER_S = 495e12 / 3
# per (walker, bin) besides the contraction's 2 D 61 flops, counted from
# model_sufficient.cuh: the Taylor scalars, xi and combine() (~200 FP32
# flops) and 4 special-function operations (rsqrt, two reciprocals, log)
BIN_COST = (200, 4)


def sufficient_bound(stats, n_walkers, mma):
    """(least ms, what bounds it) of kernel 9 (FP32) or kernel 11 (``mma``:
    the contraction at the 3xTF32 rate, the rest at the FP32 rate): the
    tables, params and output moved once against the operations."""
    n_bins, n_coef, n_ch = stats.coeffs.shape
    n_bytes = 4 * (n_bins * n_coef * n_ch + n_bins + 7 * n_walkers)
    pairs = n_walkers * n_bins
    contraction = 2.0 * n_coef * n_ch * pairs
    if not mma:
        return bound_ms(n_bytes, contraction + BIN_COST[0] * pairs, BIN_COST[1] * pairs)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (contraction / TF32X3_FLOPS_PER_S
             + max(BIN_COST[0] * pairs / FP32_FLOPS_PER_S,
                   BIN_COST[1] * pairs / SFU_OPS_PER_S)) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def near_truth_params(n_walkers, seed, device):
    """Walkers drawn as path H's initial walkers are (``mock_params``), in
    internal units (km/s, arcmin), from a generator of their own."""
    import torch

    rng = np.random.default_rng(seed)
    p = np.column_stack([
        rng.normal(0, 0.5, n_walkers), rng.uniform(10.8, 13.2, n_walkers),
        rng.uniform(24, 36, n_walkers) / 60.0, rng.normal(0, 2, n_walkers),
        rng.normal(0, 2, n_walkers), rng.uniform(48, 72, n_walkers) / 60.0])
    return torch.as_tensor(p, dtype=torch.float32, device=device)


def validate_setup(device, n_stars=4000, n_walkers=2048):
    """bench.py --validate's ModelFit set-up, where the matrix-unit gate was
    set: 4000 stars within ~2 arcmin, errors of 0.5-1 km/s, an unbounded
    sigma_max prior (s_max 1e6), its walker distribution; float32 tables."""
    import torch

    from mcmc_dynamics_tpu_torch.ops import ModelSufficientStats
    from mcmc_dynamics_tpu_torch.utils.coordinates import xy_offset_rad

    rng = np.random.default_rng(0)
    ra_c, dec_c = 56.345, -26.675
    ra = ra_c + 0.03 * rng.normal(size=n_stars)
    dec = dec_c + 0.03 * rng.normal(size=n_stars)
    v = 5.0 * rng.normal(size=n_stars)
    verr = 0.5 + 0.5 * rng.random(n_stars)
    dx, dy = xy_offset_rad(np.radians(ra), np.radians(dec), math.radians(ra_c),
                           math.radians(dec_c), xp=np)
    arcmin = 10800.0 / math.pi
    stats = ModelSufficientStats.build(dx * arcmin, dy * arcmin, v, verr ** 2,
                                       s_max=1e6, device=device, dtype=torch.float32)
    wr = np.random.default_rng(1)
    params = np.column_stack([
        wr.normal(0, 1, n_walkers), np.exp(wr.normal(1.8, 0.2, n_walkers)),
        wr.uniform(20, 60, n_walkers) / 60.0, wr.normal(0, 3, n_walkers),
        wr.normal(0, 3, n_walkers), wr.uniform(30, 90, n_walkers) / 60.0])
    return stats, torch.as_tensor(params, dtype=torch.float32, device=device)


def table_kernel_row(label, kernel, stats, params, tol, mma):
    """Kernel 9 or 11 on ``params``: held to the float64 plain version of the
    same float32 tables at ``tol``; times and bound."""
    import torch

    stats64 = stats.to(dtype=torch.float64)
    got = kernel(stats, params)
    torch.cuda.synchronize()
    ref = torch.cat([stats64.lnlike(p) for p in torch.split(params.double(), 1024)])
    err = compare(label, got, ref, **tol)
    rel = float(torch.max(torch.abs(got.double() - ref) / torch.abs(ref)))
    ms = cuda_ms(lambda: kernel(stats, params))
    plain_ms = cuda_ms(lambda: stats.lnlike(params), reps=5)
    b_ms, b_by = sufficient_bound(stats, params.shape[0], mma)
    return dict(W=params.shape[0], max_abs_err=err, max_rel_err=rel, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, out=got)


def sufficient_inputs(device):
    """Kernel 9's walkers at a (walkers,) shape (``near_truth_params``), as
    ``pair_kernel_phase``'s inputs give them."""
    def make(shape):
        return [near_truth_params(shape[0], seed=shape[0], device=device)], {}, {}, 0
    return make


def phase_sufficient_kernel(device, fit, ensembles=(16384, 512)):
    """Phase 22: kernel 9 on path H's float32 tables at 16384 walkers and at
    the path's half-ensemble, against the float64 plain version (the tier's
    gate), and the tables against the exact float64 star sum; its batch
    invariance at 16384 walkers against walkers 0-127 alone."""
    import torch

    from mcmc_dynamics_tpu_torch.ops import (model_lnlike_reference,
                                             model_sufficient_lnlike)

    t0 = time.perf_counter()
    stats = fit.sufficient_stats()
    build_s = time.perf_counter() - t0
    n_bins, n_coef, _ = stats.coeffs.shape
    rows = []
    for n_walkers in ensembles:
        params = sufficient_inputs(device)((n_walkers,))[0][0]
        row = table_kernel_row(f"model_sufficient W={n_walkers}", model_sufficient_lnlike,
                               stats, params, TENSOR_TOL, mma=False)
        row["params"] = params
        rows.append(row)
    # the tables against the exact star sum (float64 direct plain version)
    dx, dy = fit.fixed_center_offsets()
    dx, dy = dx * (10800.0 / math.pi), dy * (10800.0 / math.pi)
    cols = [torch.as_tensor(c, dtype=torch.float64, device=device) for c in
            (dx, dy, dx * dx + dy * dy, fit.data.data.value("v", "km/s"),
             fit.data.data.value("verr", "km/s") ** 2, np.ones_like(dx))]
    probe = rows[0]["params"][:256].double()
    exact = torch.cat([model_lnlike_reference(p, *cols) for p in torch.split(probe, 32)])
    tab_err = compare("binned tables vs exact star sum",
                      stats.to(dtype=torch.float64).lnlike(probe), exact, **TENSOR_TOL)
    for row in rows:
        print(f"phase 22 kernel model_sufficient W={row['W']} N={fit.n_data} tables "
              f"B={n_bins} D={n_coef} (host build {build_s:.2f} s): max_abs_err "
              f"{row['max_abs_err']:.4g} (max rel {row['max_rel_err']:.3g}) vs float64 "
              f"plain (rtol {TENSOR_TOL['rtol']}, atol {TENSOR_TOL['atol']}) | tables "
              f"vs exact star sum {tab_err:.4g} | kernel {row['ms']:.4f} ms | plain "
              f"f32 {row['plain_ms']:.4f} ms | bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})")
    batch_invariance(22, "model_sufficient", lambda p: model_sufficient_lnlike(stats, p),
                     sufficient_inputs(device), (ensembles[0],))
    return stats, rows


def mma_layout_check(device, stats, b=40):
    """Kernel 11's product of one bin alone (``model_sufficient_mma_product``)
    for 64 of path H's walkers, against the float64 product of the same tf32
    operands (the basis's hi rounded and its lo as the tensor core reads it,
    13 low bits dropped; the table's hi/lo; the three passes): the operand
    layouts (the A fragments, the B descriptor, the accumulator rows and
    columns).  Held to 1e-5 of the largest moment (float32 accumulation); the
    exact float64 moments are printed beside."""
    import torch

    from mcmc_dynamics_tpu_torch.ops import model_sufficient as ms

    n_coef = stats.coeffs.shape[1]
    d8 = -(-n_coef // 8) * 8
    params = near_truth_params(ms.MMA_TILE, seed=3, device=device)
    scal = stats._field_scalars(params[:, 1], params[:, 2], params[:, 5])
    basis = stats._basis(scal[0])[:, :, b].T                      # (64, D)
    basis = torch.nn.functional.pad(basis, (0, d8 - n_coef)).contiguous()
    got = ms.model_sufficient_mma_product(stats, b, basis)
    torch.cuda.synchronize()
    tab = stats.coeffs_mma[b].double()            # (hi/lo, quad, octet, column, position)
    hi, lo = tab.permute(0, 1, 4, 2, 3).reshape(2, d8, ms.CHANNELS_PAD)
    a = basis[:, list(ms.mma_orders(d8))].contiguous()              # by K position
    a_hi = ms._tf32(a)
    a_lo = ((a - a_hi).view(torch.int32) & -0x2000).view(torch.float32)
    ref = a_lo.double() @ hi + a_hi.double() @ lo + a_hi.double() @ hi
    exact = ms.model_sufficient_mma_product(stats.to(device="cpu", dtype=torch.float64), b,
                                            basis.cpu().double()).to(device)
    err = float((got.double() - ref).abs().max())
    scale = float(ref.abs().max())
    if not err <= 1e-5 * scale:
        raise AssertionError(f"kernel 11's one-bin product: max abs {err:.4g} against the "
                             f"float64 product of its operands (largest moment {scale:.4g})")
    print(f"phase 23 kernel model_sufficient_mma one-bin product (bin {b}, 64 walkers, "
          f"D8={d8}): max abs {err:.4g} vs the float64 product of its tf32 hi/lo operands "
          f"(largest moment {scale:.4g}; gate 1e-5 of it) | vs exact float64 moments "
          f"{float((got.double() - exact).abs().max()):.4g}")


def phase_sufficient_mma(device, stats, k9_rows):
    """Phase 23: kernel 11's operand layouts on one bin; the kernel at phase
    22's inputs, against the float64 plain version at the tier's gate and
    beside kernel 9 (timed in turns: 9, 11, 11, 9); on bench.py --validate's
    set-up at the matrix-unit gate it was held to there; and its batch
    invariance at 16384 walkers."""
    from mcmc_dynamics_tpu_torch.ops import (model_sufficient_lnlike,
                                             model_sufficient_lnlike_mma)

    mma_layout_check(device, stats)
    rows = []
    for k9 in k9_rows:
        row = table_kernel_row(f"model_sufficient_mma W={k9['W']}",
                               model_sufficient_lnlike_mma, stats, k9["params"],
                               TENSOR_TOL, mma=True)
        diff = float((row["out"].double() - k9["out"].double()).abs().max())
        turns = [cuda_ms(lambda: kernel(stats, k9["params"])) for kernel in (
            model_sufficient_lnlike, model_sufficient_lnlike_mma,
            model_sufficient_lnlike_mma, model_sufficient_lnlike)]
        print(f"phase 23 kernel model_sufficient_mma W={row['W']} (phase 22's tables "
              f"and walkers): max_abs_err {row['max_abs_err']:.4g} (max rel "
              f"{row['max_rel_err']:.3g}) vs float64 plain (rtol {TENSOR_TOL['rtol']}, "
              f"atol {TENSOR_TOL['atol']}) | vs kernel 9 {diff:.4g} | kernel "
              f"{row['ms']:.4f} ms | in turns kernel 9, 11, 11, 9: "
              f"{', '.join(f'{t:.4f}' for t in turns)} ms ({(turns[1] + turns[2]) / (turns[0] + turns[3]):.3f}x "
              f"kernel 9) | plain f32 {row['plain_ms']:.4f} ms | bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        rows.append(row)
    v_stats, v_params = validate_setup(device)
    for label, kernel, mma in (("model_sufficient_mma", model_sufficient_lnlike_mma, True),
                               ("model_sufficient", model_sufficient_lnlike, False)):
        row = table_kernel_row(f"{label} validate set-up", kernel, v_stats, v_params,
                               MXU_TOL, mma=mma)
        print(f"phase 23 kernel {label} on bench.py --validate's set-up (4000 stars, "
              f"{row['W']} walkers, B={v_stats.coeffs.shape[0]} "
              f"D={v_stats.coeffs.shape[1]}): max_abs_err {row['max_abs_err']:.4g} (max "
              f"rel {row['max_rel_err']:.3g}) vs float64 plain (rtol {MXU_TOL['rtol']}, "
              f"atol {MXU_TOL['atol']}) | kernel {row['ms']:.4f} ms")
    batch_invariance(23, "model_sufficient_mma",
                     lambda p: model_sufficient_lnlike_mma(stats, p),
                     sufficient_inputs(device), (k9_rows[0]["W"],))
    return rows


def mma_sweep(device, stats, ensembles=(512, 16384)):
    """``--chunk-sweep`` for kernel 11: its time at bin groups of 2, 4 and 8
    (``MMA_BIN_GROUP``) and at 1-16 tiles of 64 walkers a warpgroup
    (``MMA_WALKER_TILES``, with ``MMA_RANGES`` 1 so that the count is what
    is set), each restored after."""
    from mcmc_dynamics_tpu_torch.ops import model_sufficient as ms

    own = ms.MMA_BIN_GROUP, ms.MMA_WALKER_TILES, ms.MMA_RANGES
    try:
        for n_walkers in ensembles:
            params = near_truth_params(n_walkers, seed=n_walkers, device=device)
            run = lambda: ms.model_sufficient_lnlike_mma(stats, params)
            readings = []
            for group in (2, 4, 8):
                ms.MMA_BIN_GROUP = group
                readings.append(f"{group}: {cuda_ms(run):.4f} ms")
            ms.MMA_BIN_GROUP = own[0]
            print(f"  chunk sweep model_sufficient_mma {n_walkers} walkers, bins a block "
                  f"(own {own[0]}; {ms.mma_walker_tiles(n_walkers)} tiles a warpgroup): "
                  + " | ".join(readings))
            readings = []
            ms.MMA_RANGES = 1
            for tiles in (1, 2, 4, 8, 16):
                ms.MMA_WALKER_TILES = tiles
                readings.append(f"{ms.mma_walker_tiles(n_walkers)}: {cuda_ms(run):.4f} ms")
            ms.MMA_WALKER_TILES, ms.MMA_RANGES = own[1:]
            print(f"  chunk sweep model_sufficient_mma {n_walkers} walkers, tiles of 64 a "
                  f"warpgroup (own {ms.mma_walker_tiles(n_walkers)}): " + " | ".join(readings))
    finally:
        ms.MMA_BIN_GROUP, ms.MMA_WALKER_TILES, ms.MMA_RANGES = own


def phase_crossover(device, n_stars=16_384, n_walkers=512):
    """Phase 27: kernel 1 (the direct tier) and kernel 9 (the binned tier)
    on one catalog at the star count from which auto dispatch takes the
    binned tier for a ModelFit with an unbounded a or r_peak prior (path H's
    mock, cut to 16384 stars), at path H's half-ensemble of 512 walkers: each
    against the exact float64 star sum at its gate, and timed."""
    import torch

    from mcmc_dynamics_tpu_torch.ops import (model_lnlike_batched,
                                             model_lnlike_reference,
                                             model_sufficient_lnlike)

    fit, _ = mock_fit(device, n_stars=n_stars, seed=5, bounded=False)
    if fit.lnprob_tier() != "sufficient":
        raise AssertionError(f"{n_stars} stars: tier {fit.lnprob_tier()}, expected "
                             "sufficient")
    stats = fit.sufficient_stats()
    dx, dy = fit.fixed_center_offsets()
    dx, dy = dx * (10800.0 / math.pi), dy * (10800.0 / math.pi)
    cols = [torch.as_tensor(c, dtype=torch.float64, device=device) for c in
            (dx, dy, dx * dx + dy * dy, fit.data.data.value("v", "km/s"),
             fit.data.data.value("verr", "km/s") ** 2, np.ones_like(dx))]
    cols32 = [c.float() for c in cols]
    params = near_truth_params(n_walkers, seed=n_walkers, device=device)
    exact = torch.cat([model_lnlike_reference(p, *cols)
                       for p in torch.split(params.double(), 32)])
    err1 = compare("crossover: kernel 1", model_lnlike_batched(params, *cols32), exact,
                   **DIRECT_TOL)
    err9 = compare("crossover: kernel 9", model_sufficient_lnlike(stats, params), exact,
                   **TENSOR_TOL)
    ms1 = cuda_ms(lambda: model_lnlike_batched(params, *cols32))
    ms9 = cuda_ms(lambda: model_sufficient_lnlike(stats, params))
    flops, sfu = PAIR_COST["model_lnlike"]
    pairs = n_walkers * n_stars
    b1, _ = bound_ms(4 * (7 * n_walkers + 6 * n_stars), flops * pairs, sfu * pairs)
    b9, _ = sufficient_bound(stats, n_walkers, mma=False)
    n_bins, n_coef, _ = stats.coeffs.shape
    print(f"phase 27 tier crossover at {n_stars} stars, {n_walkers} walkers: kernel 1 "
          f"(direct) {ms1:.4f} ms, bound {b1:.4f} ms, max_abs_err {err1:.4g} vs the "
          f"exact star sum | kernel 9 (binned, B={n_bins} D={n_coef}) {ms9:.4f} ms, "
          f"bound {b9:.4f} ms, max_abs_err {err9:.4g} | the "
          f"{'direct' if ms1 < ms9 else 'binned'} tier is "
          f"{max(ms1, ms9) / min(ms1, ms9):.2f}x faster")


def model_gb_v2_inputs(device):
    """Kernel 13 on kernel 6's inputs (``radial_inputs``) without the per-star
    background row, which the Gaussian background does not read."""
    make = radial_inputs(device, "model_mixture")

    def inputs(shape):
        a32, _, kw64, pairs = make(shape)
        return a32[:8] + a32[9:], {}, dict(tiny=kw64["tiny"]), pairs
    return inputs


def model_mixture_gb(params, dxm, dym, r2, v, verr2, density, ln_density, mask):
    """Kernel 6's wrapper with its Gaussian background, in kernel 13's
    arguments."""
    from mcmc_dynamics_tpu_torch.ops import model_mixture_lnlike_batched

    return model_mixture_lnlike_batched(params, dxm, dym, r2, v, verr2, density,
                                        ln_density, v.new_zeros(v.shape), mask,
                                        parametric_bg=True)


def phase_v2(phase, name, v2, plain, v1, inputs, shapes, rows_k, cols_k):
    """Phases 24 and 25: kernel 12 or 13 against its float64 plain version
    (``pair_kernel_phase``) and its batch invariance at the first shape,
    then beside the kernel it restructures (5 or 6) on the same inputs: the
    largest difference relative to max(|lnL|, 1) over the walkers with
    f_back > 0 (at f_back = 0 the two forms clamp differently), and the two
    kernels' times, timed in turns."""
    import torch

    rows = pair_kernel_phase(phase, name, v2, plain, inputs, shapes, DIRECT_TOL,
                             rows_k=rows_k, cols_k=cols_k)
    batch_invariance(phase, name, v2, inputs, shapes[0])
    for shape, row in zip(shapes, rows):
        a32 = inputs(shape)[0]
        got, ref = v2(*a32).double(), v1(*a32).double()
        torch.cuda.synchronize()
        live = a32[0][:, -1] > 0
        diff = float(((got - ref).abs() / ref.abs().clamp(min=1.0))[live].max())
        v1_ms, v2_ms = cuda_ms(lambda: v1(*a32)), cuda_ms(lambda: v2(*a32))
        v2_ms2, v1_ms2 = cuda_ms(lambda: v2(*a32)), cuda_ms(lambda: v1(*a32))
        ratio = (v2_ms + v2_ms2) / (v1_ms + v1_ms2)
        print(f"phase {phase} kernel {name} {shape[0]} x {shape[1] + shape[2]} beside "
              f"the kernel it restructures: max rel diff {diff:.3g} (f_back > 0 "
              f"walkers) | v2 {v2_ms:.4f}, {v2_ms2:.4f} ms, v1 {v1_ms:.4f}, "
              f"{v1_ms2:.4f} ms: v2/v1 {ratio:.3f}")
        row.update(v1_rel_diff=diff, v1_ms=0.5 * (v1_ms + v1_ms2), v2_over_v1=ratio)
    return rows


# path H's medians in the JAX package's float64 run of the same set-up
# (chip_smoke_reference.py H: 192 bins), printed beside the port's
H_REFERENCE = dict(v_sys=-0.0038, sigma_max=11.96157, a=30.47835, v_maxx=4.2569,
                   v_maxy=4.31563, r_peak=59.76897)


def chunk_sweep(kernel, name, run, inputs, shapes, chunks, attr="star_chunk",
                count=None, unit="chunks"):
    """Kernel ``name``'s time at each chunk of ``chunks`` and each shape of
    ``shapes``.  The chunk is ``kernel``'s attribute ``attr`` (a launcher's
    ``star_chunk``; kernel 2's is its module's ``ROW_CHUNK``, kernel 9's
    ``BIN_GROUP``), set here for the sweep and restored after;
    ``count(shape)`` gives the ``unit``s at that setting (by default the star
    chunks of a (walkers, stars, tail) shape)."""
    from mcmc_dynamics_tpu_torch.ops import star_chunks

    count = count or (lambda shape: star_chunks(shape[1] + shape[2], getattr(kernel, attr)))
    own = getattr(kernel, attr)
    try:
        for shape in shapes:
            a32, kw, _, _ = inputs(shape)
            readings = []
            for chunk in chunks:
                setattr(kernel, attr, chunk)
                ms = cuda_ms(lambda: run(*a32, **kw))
                readings.append(f"{chunk}: {ms:.4f} ms ({count(shape)} {unit})")
            print(f"  chunk sweep {name} {size_label(shape)} (own {attr} {own}): "
                  + " | ".join(readings))
    finally:
        setattr(kernel, attr, own)


def profile_path(label, fn, n_steps, kernel_names):
    """Run ``fn`` (``n_steps`` ensemble steps) under torch.profiler and print
    the device time per step (CUDA kernel time summed by name), each named
    kernel's time per step, the device kernels per step, and the shares of
    the traced wall time.  The profiler slows the host: hold the per-step
    device times against an untraced ms/step, not the traced wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, per_kernel, n_kernels = 0.0, dict.fromkeys(kernel_names, 0.0), 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(evt, "self_device_time_total", None)
        t = evt.self_cuda_time_total if t is None else t
        busy += t
        n_kernels += evt.count
        for name in kernel_names:
            if name in evt.key:
                per_kernel[name] += t
    kernels = " ".join(f"| {n} {t / n_steps / 1e3:.4f} ms/step "
                       f"({100 * t / wall_us:.2f} % of traced wall)"
                       for n, t in per_kernel.items())
    print(f"  profile {label}: {n_steps} steps | device {busy / n_steps / 1e3:.4f} "
          f"ms/step, {n_kernels / n_steps:.1f} device kernels/step | traced wall "
          f"{wall_us / n_steps / 1e3:.4f} ms/step, device busy "
          f"{100 * busy / wall_us:.2f} % of it {kernels}")


def shape_label(row):
    """A kernel row's shape: "walkers x stars" (or targets x catalog stars),
    or "W walkers" for the table kernels."""
    if "shape" in row:
        return f"{row['shape'][0]} x {row['shape'][1] + row['shape'][2]}"
    return f"{row['W']} x {row['N']}" if "N" in row else f"{row['W']} walkers"


# ---------------------------------------------------------- binned pipeline, convergence
# paths I1 and I2: the reference's production binned workload (bin/run.py:146-259)
# at bench.py's binned-pipeline configuration
BINNED_RUN = dict(nstars=400, dlogr=0.05, n_walkers=64, n_steps=300, seed=0)
BINNED_BURN = 150
BINNED_KEYS = ("sigma_max", "v_sys")
BINNED_REFERENCE = REPO / "chip_smoke_binned_reference.json"
# path J: A's recipe sampled to convergence with a DE/snooker mixture; the JAX
# package needs J_JAX_STEPS steps there (chip_smoke_reference.py J, float64,
# CPU), and the port is given twice that
J_MOVE = (("de", 0.8), ("snooker", 0.2))
J_CHECK_EVERY = 500
J_JAX_STEPS = 12_000
J_MAX_STEPS = 2 * J_JAX_STEPS


def binned_catalog(path):
    """Path I1's catalog (the omega Cen recipe's) or I2's (path B's 1e5-star
    mock) as ``{name: (values, unit)}`` numpy columns, and its centre (deg)."""
    if path == "I1":
        cfg = json.loads(RECIPE.read_text())
        table = read_catalog(cfg).data
        columns = {name: (table.value(name), table.units[name].name)
                   for name in ("ra", "dec", "v", "verr")}
        return columns, (cfg["parameters"]["ra_center"]["value"],
                         cfg["parameters"]["dec_center"]["value"])
    columns, truth = mock_catalog(n_stars=100_000, seed=5)
    return columns, (truth["ra_center"], truth["dec_center"])


def binned_bands(result):
    """Per-bin medians of BINNED_KEYS after BINNED_BURN steps, each with its
    band: the median +- half its 16-84 % half-width."""
    table = result.summary(n_burn=BINNED_BURN)
    out = {}
    for key in BINNED_KEYS:
        med = np.asarray(table.value(f"{key} median"), np.float64)
        half = 0.5 * (np.asarray(table.value(f"{key} high"), np.float64)
                      + np.asarray(table.value(f"{key} low"), np.float64))
        out[key] = {"median": med.tolist(), "lo": (med - 0.5 * half).tolist(),
                    "hi": (med + 0.5 * half).tolist()}
    return out


def check_binned(label, result, reference):
    """Each bin's medians inside the JAX package's bands; returns the largest
    offset from the JAX median in units of the band's half-width."""
    got = binned_bands(result)
    worst = 0.0
    if len(got["v_sys"]["median"]) != len(reference["v_sys"]["median"]):
        raise AssertionError(f"path {label}: {len(got['v_sys']['median'])} bins, "
                             f"the JAX package made {len(reference['v_sys']['median'])}")
    for key in BINNED_KEYS:
        ref = reference[key]
        for b, value in enumerate(got[key]["median"]):
            lo, hi, med = ref["lo"][b], ref["hi"][b], ref["median"][b]
            if not lo <= value <= hi:
                raise AssertionError(f"path {label}: bin {b} {key} = {value:.5g} "
                                     f"outside the JAX band [{lo:.5g}, {hi:.5g}]")
            worst = max(worst, abs(value - med) / (0.5 * (hi - lo)))
    return worst


def phase_native():
    """The native host library: it builds, its radial binning equals the
    NumPy branch on the omega Cen radii and on path B's mock's, and a catalog
    cache round trip returns the same columns; returns seconds per binning."""
    from mcmc_dynamics_tpu_torch import native
    from mcmc_dynamics_tpu_torch.utils import data as data_mod

    if not native.native_available():
        raise AssertionError("the native library did not build (g++)")
    out = {}
    for path in ("I1", "I2"):
        columns, centre = binned_catalog(path)
        r = port_reader(columns).compute_distances(*centre).value
        t0 = time.perf_counter()
        got = native.radial_bins(r, BINNED_RUN["nstars"], BINNED_RUN["dlogr"])
        out[path] = time.perf_counter() - t0
        saved = native.radial_bins
        native.radial_bins = lambda *a, **k: None       # the NumPy branch
        try:
            t0 = time.perf_counter()
            want = data_mod.radial_bin_numbers(r, BINNED_RUN["nstars"],
                                               BINNED_RUN["dlogr"])
            out[path + " numpy"] = time.perf_counter() - t0
        finally:
            native.radial_bins = saved
        if not np.array_equal(got, want):
            raise AssertionError(f"native radial bins differ from NumPy's ({path})")
        out[path + " bins"] = int(got.max()) + 1
    columns, _ = binned_catalog("I1")
    reader = port_reader(columns)
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "omega_cen.mcmd"
        if not reader.to_cache(path):
            raise AssertionError("to_cache failed")
        back = type(reader).from_cache(
            path, units={name: unit for name, (_, unit) in columns.items()})
    for name, (values, _) in columns.items():
        if not np.array_equal(back.data.value(name), values):
            raise AssertionError(f"cache round trip changed column {name}")
    return out


def phase_binned(device, path, reference):
    """Main path I1 or I2: fit_radial_bins with ConstantFit's default
    parameters (the sufficient tables in plain torch); returns its numbers."""
    import torch

    from mcmc_dynamics_tpu_torch import pipelines

    columns, (ra_c, dec_c) = binned_catalog(path)

    def run(n_steps=BINNED_RUN["n_steps"]):
        return pipelines.fit_radial_bins(port_reader(columns), ra_c, dec_c,
                                         device=device,
                                         **dict(BINNED_RUN, n_steps=n_steps))

    run()                                                   # warm-up
    setup_s = best = math.inf
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(n_steps=0)
        torch.cuda.synchronize()
        setup_s = min(setup_s, time.perf_counter() - t0)
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    n_steps, n_walkers = BINNED_RUN["n_steps"], BINNED_RUN["n_walkers"]
    worst = check_binned(path, res, reference)
    out = dict(bins=res.n_bins, stars=int(res.n_per_bin.sum()),
               per_bin=(int(res.n_per_bin.min()), int(res.n_per_bin.max())),
               buckets=len(pipelines._size_buckets(res.n_per_bin)),
               setup_s=setup_s, wall_s=best,
               ms_per_step=(best - setup_s) / n_steps * 1e3,
               evals_per_s=res.n_bins * n_walkers * n_steps / best,
               acceptance=float(np.mean(np.diff(res.chains, axis=2).any(axis=-1))),
               worst=worst, result=res)
    if path == "I2":
        # the same run with every bin in one (B, N_max) block: the bucketed
        # chains must be these, bit for bit
        saved = pipelines._size_buckets
        pipelines._size_buckets = lambda counts, **kw: [np.arange(len(counts))]
        try:
            single = run()
        finally:
            pipelines._size_buckets = saved
        if not (np.array_equal(single.chains, res.chains)
                and np.array_equal(single.log_probs, res.log_probs)):
            raise AssertionError("path I2: bucketed chains differ from one bucket's")
    return out


def phase_convergence(device):
    """Main path J: A's recipe through sample_to_convergence with the
    DE/snooker mixture (kernel 1), goldens after discarding twice the largest
    tau, predict_fields on a 32 x 32 grid and benchmark_lnprob."""
    import torch

    from mcmc_dynamics_tpu_torch.profiling import benchmark_lnprob

    fit, _ = load_recipe(device)
    if fit.lnprob_tier() != "direct":
        raise AssertionError(f"recipe tier {fit.lnprob_tier()}, expected direct")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = fit.sample_to_convergence(n_walkers=64, move=J_MOVE,
                                    check_every=J_CHECK_EVERY, max_steps=J_MAX_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not run.converged:
        raise AssertionError(f"path J did not converge in {J_MAX_STEPS} steps "
                             f"(tau {np.round(run.tau, 1).tolist()})")
    discard = int(2 * np.max(run.tau))
    values = check_goldens(run.chain, discard,
                           json.loads(GOLDENS.read_text())["omega_cen_fixed"])
    ra_c, dec_c = fit.parameters["ra_center"].value, fit.parameters["dec_center"].value
    ra, dec = np.meshgrid(ra_c + np.linspace(-0.2, 0.2, 32) / math.cos(math.radians(dec_c)),
                          dec_c + np.linspace(-0.2, 0.2, 32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fields = fit.predict_fields(run.chain, discard, ra.ravel(), dec.ravel())
    predict_s = time.perf_counter() - t0
    for name in ("v_los", "sigma_los", "sigma_los_upper_1s"):
        col = fields.value(name)
        if col.shape != (1024,) or not np.isfinite(col).all():
            raise AssertionError(f"predict_fields {name}: shape {col.shape} or "
                                 "not finite")
    bench = benchmark_lnprob(fit, n_walkers=1024, n_steps=50)
    steps = run.chain.shape[1]
    return dict(steps=steps, seconds=seconds, ms_per_step=seconds / steps * 1e3,
                tau=np.round(run.tau, 2).tolist(), discard=discard,
                acceptance=float(np.mean(run.acceptance_fraction)), medians=values,
                predict_s=predict_s, bench=bench, fit=fit)


# ----------------------------------------------------------------------------- JAM
# phase 32: bench.py --validate's JAM set-up (bench.py:707-900); phase 33: path
# K1, the production recipe (cli/run.py on example/omega_cen_config.json);
# phase 34: path K2, bench.py's jam-bh/grid@16k width with a self-consistent mock
JAM_REFERENCE = REPO / "chip_smoke_jam_reference.json"
CONFIG = REPO / "example" / "omega_cen_config.json"
JAM_F32_TOL = dict(rtol=2e-5, atol=0.1)     # float32 against float64 (bench.py:772)
JAM_F64_TOL = dict(rtol=1e-9, atol=1e-6)    # float64 on the card against the JAX package
JAM_GRID_TOL = dict(rtol=3e-3, atol=1.0)    # grid tier against direct (bench.py:805)
JAM_CENTRE = (56.345, -26.675)
JAM_KINDS = ("axisymmetric", "profiles", "chemo")
JAM_MODELS = {"axisymmetric": "Axisymmetric", "profiles": "AnalyticalProfiles",
              "chemo": "ChemoProfiles"}
JAM_WALKERS = 64
# the validate catalogs hold 400 and 500 stars: the grid tier is forced by
# lowering the auto threshold, on both packages' instances
JAM_GRID_MIN_STARS = 100
K1_STEPS = dict(n_walkers=32, n_steps=60, n_out=30, n_extra=20)
# path K2: the truth of the mock and the run
K2_TRUTH = dict(mlr=2.5, barq=0.7, kappa_x=0.3, kappa_y=0.15, mbh=3.0e4, delta_v=0.5)
K2_FIXED = dict(d=5.2, beta=0.0, rbh=1.0, ra_center=201.697, dec_center=-47.48)
K2_RUN = dict(n_stars=16_384, n_walkers=64, n_steps=1500, n_burn=500)


def jam_columns(kind):
    """bench.py's validate catalogs as numpy columns: 400 stars around the
    centre with 40 pushed to 15-25 sigma of the outer 40" tracer Gaussian, or
    (chemo) 500 stars with [Fe/H] from two populations."""
    ra_c, dec_c = JAM_CENTRE
    if kind != "chemo":
        rng = np.random.default_rng(6)
        n = 400
        ra = ra_c + 0.03 * rng.normal(size=n)
        dec = dec_c + 0.03 * rng.normal(size=n)
        v = 5.0 * rng.normal(size=n)
        verr = 0.5 + 0.5 * rng.random(n)
        far = rng.integers(0, n, 40)
        ra[far] = ra_c + rng.uniform(0.18, 0.28, far.size)
        return {"ra": (ra, "deg"), "dec": (dec, "deg"), "v": (v, "km/s"),
                "verr": (verr, "km/s")}
    rng = np.random.default_rng(10)
    n = 500
    r = np.abs(rng.normal(0, 40, n)) + 1.0
    phi = rng.uniform(-np.pi, np.pi, n)
    x, y = r * np.cos(phi), r * np.sin(phi)
    pop = rng.random(n) < 0.6
    return {"ra": (ra_c - (x / 3600.0) / np.cos(np.radians(dec_c)), "deg"),
            "dec": (dec_c + y / 3600.0, "deg"),
            "v": (3.0 * rng.normal(size=n), "km/s"),
            "verr": (np.full(n, 0.3), "km/s"),
            "feh": (np.where(pop, -0.5, 0.2) + 0.1 * rng.normal(size=n), None),
            "feherr": (np.full(n, 0.05), None)}


def jam_parameters(kind, cls):
    """The validate set-up's parameters on ``cls`` (either package's model)."""
    ra_c, dec_c = JAM_CENTRE
    if kind == "chemo":
        params = cls.default_parameters(2)
        for name, val in dict(d=5.0, mlr_0=2.0, mlr_t=2.0, mlr_inf=2.0, r_mlr=20.0,
                              barq=0.5, beta=0.0, ra_center=ra_c, dec_center=dec_c,
                              mu_feh_b=0.2, sigma_feh_b=0.1, kappa_max_b=-0.2,
                              logr_kappa_b=float(np.log10(30.0 / 60.0)), h_ab=0.2,
                              sigma_feh_a=0.12,
                              logr_kappa_a=float(np.log10(20.0 / 60.0))).items():
            params[name].set(value=val, fixed=True)
        params["kappa_max_a"].set(value=0.4, min=-2.0, max=2.0, fixed=False)
        params["mu_feh_a"].set(value=-0.5, min=-1.0, max=1.0, fixed=False)
        params["h_aa"].set(value=0.8, min=0.0, max=1.0, fixed=False)
        return params
    params = cls.default_parameters()
    fixed = dict(d=5.0, beta=0.0, ra_center=ra_c, dec_center=dec_c, rbh=1.0,
                 delta_v=0.0)
    if kind == "profiles":
        fixed["mbh"] = 0.0
    for name, val in fixed.items():
        params[name].set(value=val, fixed=True)
    if kind == "axisymmetric":
        params["mlr"].set(value=2.0, min=0.1, max=10.0, fixed=False)
        params["mbh"].set(value=1e4, min=0.0, max=1e6, fixed=False,
                          initials="rng.uniform(5e3, 5e4, size=n)")
    else:
        for name in ("mlr_0", "mlr_t", "mlr_inf"):
            params[name].set(value=2.0, min=0.1, max=10.0, fixed=False)
    params["barq"].set(value=0.4, fixed=False)
    params["kappa_x"].set(value=0.5, min=-2.0, max=2.0, fixed=False)
    params["kappa_y"].set(value=0.0, min=-2.0, max=2.0, fixed=False)
    return params


def jam_fit(kind, pkg, **kw):
    """The validate set-up's model ``kind`` built by ``pkg`` (the port, or the
    JAX package in chip_smoke_reference.py), its grid threshold lowered."""
    q, table, mge = pkg.units.Quantity, pkg.utils.Table, pkg.utils.MgeReader
    i, s, qs = (([5000.0, 800.0], [10.0, 40.0], [0.9, 0.9]) if kind == "chemo" else
                ([5000.0, 1000.0], [10.0, 40.0], [0.9, 0.85]))
    lum = {"n": [1, 2], "i": q(i, "solLum/pc2"), "s": q(s, "arcsec"), "q": qs}
    if kind == "chemo":
        lum["pop"] = [0, 1]
        kw["n_pops"] = 2
    mass = {"n": [1, 2], "i": q(i, "solMass/pc2"), "s": q(s, "arcsec"), "q": qs}
    cls = getattr(pkg.models, JAM_MODELS[kind])
    reader = pkg.utils.DataReader({name: (q(v, unit) if unit else v)
                                   for name, (v, unit) in jam_columns(kind).items()})
    fit = cls(reader, parameters=jam_parameters(kind, cls),
              mge_lum=mge(table(lum), lum=True), mge_mass=mge(table(mass), lum=False),
              **kw)
    fit.jam_grid_min_stars = JAM_GRID_MIN_STARS
    return fit


def jam_walkers(kind, free):
    """bench.py's 64 seeded walkers of ``kind`` in ``free`` order; walker 0 off
    the barq prior (chemo: walker 3 crossing the populations in [Fe/H]) and
    walkers 1-2 rotating at kappa_x 1.9, where stars reach v2zz <= vz^2."""
    n = JAM_WALKERS
    if kind == "chemo":
        rng = np.random.default_rng(11)
        draws = {"kappa_max_a": rng.uniform(0.2, 0.6, n),
                 "mu_feh_a": rng.uniform(-0.6, -0.4, n),
                 "h_aa": rng.uniform(0.7, 0.95, n)}
        draws["mu_feh_a"][3] = 0.5
        return np.column_stack([draws[name] for name in free])
    if kind == "axisymmetric":
        rng = np.random.default_rng(8)
        draws = {"mlr": rng.uniform(1.5, 2.5, n), "barq": rng.uniform(0.41, 0.45, n),
                 "kappa_x": rng.uniform(0.3, 0.7, n),
                 "kappa_y": rng.uniform(-0.1, 0.1, n),
                 "mbh": rng.uniform(5e3, 5e4, n)}
    else:
        rng = np.random.default_rng(9)
        draws = {"mlr_0": rng.uniform(1.8, 2.6, n), "mlr_t": rng.uniform(1.6, 2.4, n),
                 "mlr_inf": rng.uniform(1.2, 2.0, n),
                 "r_mlr": rng.uniform(15.0, 30.0, n),
                 "r_kappa": rng.uniform(15.0, 30.0, n),
                 "barq": rng.uniform(0.41, 0.45, n),
                 "kappa_x": rng.uniform(0.3, 0.7, n),
                 "kappa_y": rng.uniform(-0.1, 0.1, n)}
    draws["barq"][0] = 0.05
    draws["kappa_x"][1:3] = 1.9
    return np.column_stack([draws[name] for name in free])


def k1_config(tmp):
    """The production recipe with absolute data and MGE paths and its prefix
    under ``tmp``, written there; returns (config dict, its path)."""
    cfg = json.loads(CONFIG.read_text())
    cfg["data"]["file"] = str(REPO / cfg["data"]["file"])
    cfg["mge"] = str(REPO / cfg["mge"])
    cfg["prefix"] = str(pathlib.Path(tmp) / "omega_cen_run")
    path = pathlib.Path(tmp) / "omega_cen_config.json"
    path.write_text(json.dumps(cfg, indent=1))
    return cfg, path


def k1_fit(pkg, **kw):
    """Path K1's model as cli/run.py builds it from the recipe, by ``pkg``
    (the catalog read with numpy)."""
    cfg = json.loads(CONFIG.read_text())
    cls = getattr(pkg.models, "AnalyticalProfiles")
    params = cls.default_parameters()
    for name, spec in cfg["parameters"].items():
        params[name].set(**spec)
    path = REPO / cfg["data"]["file"]
    header = path.read_text().splitlines()[0].split(",")
    col = dict(zip(header, np.loadtxt(path, delimiter=",", skiprows=1).T))
    q = pkg.units.Quantity
    reader = pkg.utils.DataReader({
        "ra": q(col["ra"], "deg"), "dec": q(col["dec"], "deg"),
        "v": q(col["v"] - float(cfg["data"].get("v_sys") or 0.0), "km/s"),
        "verr": q(col["verr"], "km/s")})
    mge_lum, mge_mass = pkg.utils.get_mge(REPO / cfg["mge"])
    return cls(reader, parameters=params, mge_lum=mge_lum, mge_mass=mge_mass,
               seed=cfg["sampling"]["seed"], **kw)


class jam_mode:
    """``MCMC_TPU_JAM`` set to ``mode`` inside the block."""

    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        import os
        self.saved = os.environ.get("MCMC_TPU_JAM")
        os.environ["MCMC_TPU_JAM"] = self.mode

    def __exit__(self, *exc):
        import os
        if self.saved is None:
            os.environ.pop("MCMC_TPU_JAM", None)
        else:
            os.environ["MCMC_TPU_JAM"] = self.saved


def jam_lnprob(fit, pos, tier):
    with jam_mode(tier):
        if fit.lnprob_tier() != tier:
            raise AssertionError(f"{type(fit).__name__}: tier {fit.lnprob_tier()}, "
                                 f"expected {tier}")
        return fit.batched_lnprob()(fit._to_device(pos))


def wall_ms(fn, reps=5):
    """Median wall time of one synchronised call of ``fn`` in ms (host and
    device: what a sampler step waits for)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def grid_vs_direct(label, grid, direct):
    """The grid tier within JAM_GRID_TOL of the direct one, the same -inf
    pattern, and the walkers' lnprob spread above 10x the largest difference
    (bench.py:799-816)."""
    maxd = compare(f"{label} grid vs direct", grid, direct, **JAM_GRID_TOL)
    ref = direct.double().cpu().numpy()
    spread = float(np.std(ref[np.isfinite(ref)]))
    if not spread > 10 * maxd:
        raise AssertionError(f"{label}: grid-direct difference {maxd:.3g} not << "
                             f"the walkers' spread {spread:.3g}")
    return maxd, spread


def jam_checks(label, fit32, fit64, pos, reference, need_inf=True):
    """Float32 and float64 on the card against the JAX package's float64 values
    (``reference[tier]``) on both tiers, and grid against direct; returns the
    errors.  ``need_inf``: the walkers must include -inf ones."""
    import torch

    out, lp32 = {}, {}
    for tier in ("direct", "grid"):
        want = torch.as_tensor(np.asarray(reference[tier], np.float64))
        lp32[tier] = jam_lnprob(fit32, pos, tier)
        got64 = jam_lnprob(fit64, pos, tier)
        fin = int(torch.isfinite(want).sum())
        if fin < 16 or (need_inf and fin == want.numel()):
            raise AssertionError(f"{label} {tier}: {fin} of {want.numel()} walkers "
                                 "finite")
        out[f"{tier} f64"] = compare(f"{label} {tier} float64", got64, want,
                                     **JAM_F64_TOL)
        out[f"{tier} f32"] = compare(f"{label} {tier} float32", lp32[tier], want,
                                     **JAM_F32_TOL)
        out["finite"] = fin
    out["grid-direct"], out["spread"] = grid_vs_direct(label, lp32["grid"],
                                                       lp32["direct"])
    return out


def jam_breakdown(fit, pos, tier):
    """One lnprob call under torch.profiler: device ms, kernels, and the
    shares of device time in exp kernels (the pair table and the tracer
    factor) and in the products (cuBLAS)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with jam_mode(tier):
        fn = fit.batched_lnprob()
        thetas = fit._to_device(pos)
        fn(thetas)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(thetas)
            torch.cuda.synchronize()
    total = exp = gemm = 0.0
    count = 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(evt, "self_device_time_total", None)
        t = evt.self_cuda_time_total if t is None else t
        total += t
        count += evt.count
        key = evt.key.lower()
        if "exp" in key:
            exp += t
        if any(k in key for k in ("gemm", "gemv", "cutlass", "xmma", "cublas")):
            gemm += t
    return dict(device_ms=total / 1e3, kernels=count,
                exp_share=exp / total if total else 0.0,
                product_share=gemm / total if total else 0.0)


def jam_table_bytes(fit, chunk, tier):
    """Bytes of the float32 pair table (chunk, T, P) of one engine call:
    T = mass components x n_u, P = positions x n_zeta."""
    n_pos = (fit.jam_grid_orders[0] * fit.jam_grid_orders[1] if tier == "grid"
             else fit.n_data)
    return chunk * fit._mge_tensors[3].shape[-1] * fit.n_u * n_pos * fit.n_zeta * 4


def phase_jam_engine(device, n_big=512):
    """Phase 32: the JAM engine on the card at the validate set-up, three
    models, and the free-BH Axisymmetric's timings at 64 and ``n_big``
    walkers; returns its numbers."""
    import torch

    import mcmc_dynamics_tpu_torch as port

    reference = json.loads(JAM_REFERENCE.read_text())["validate"]
    out = {}
    for kind in JAM_KINDS:
        fit32 = jam_fit(kind, port, device=device)
        fit64 = jam_fit(kind, port, device=device, dtype=torch.float64)
        free = fit32.fitted_parameters
        if free != reference[kind]["free"]:
            raise AssertionError(f"{kind}: free parameters {free}, reference "
                                 f"{reference[kind]['free']}")
        pos = jam_walkers(kind, free)
        if not np.array_equal(pos, np.asarray(reference[kind]["walkers"])):
            raise AssertionError(f"{kind}: walkers differ from the reference's")
        out[kind] = jam_checks(kind, fit32, fit64, pos, reference[kind])

    # timing, shares, chunks, TF32 and table bytes on the free-BH Axisymmetric
    fit = jam_fit("axisymmetric", port, device=device)
    free = fit.fitted_parameters
    rng = np.random.default_rng(12)
    big = np.column_stack([rng.uniform(1.5, 2.5, n_big), rng.uniform(0.41, 0.45, n_big),
                           rng.uniform(0.3, 0.7, n_big), rng.uniform(-0.1, 0.1, n_big),
                           rng.uniform(5e3, 5e4, n_big)])
    if free != ["mlr", "barq", "kappa_x", "kappa_y", "mbh"]:
        raise AssertionError(f"free parameters {free}")
    pos64 = jam_walkers("axisymmetric", free)
    ref = reference["axisymmetric"]
    timing = {}
    for tier in ("direct", "grid"):
        with jam_mode(tier):
            fn = fit.batched_lnprob()
            for w, pos in ((64, pos64), (n_big, big)):
                thetas = fit._to_device(pos)
                timing[f"{tier} {w} ms"] = wall_ms(lambda: fn(thetas))
            timing[f"{tier} breakdown {n_big}"] = jam_breakdown(fit, big, tier)
        attr = "jam_grid_chunk" if tier == "grid" else "lnprob_chunk"
        default = getattr(fit, attr)
        sweep = {}
        for chunk in (16, 32, 64, 128):
            setattr(fit, attr, chunk)
            with jam_mode(tier):
                fn = fit.batched_lnprob()
                thetas = fit._to_device(big)
                sweep[chunk] = wall_ms(lambda: fn(thetas))
        setattr(fit, attr, default)
        timing[f"{tier} chunk sweep {n_big} ms"] = sweep
        timing[f"{tier} table MB/chunk"] = jam_table_bytes(fit, default, tier) / 1e6
        # TF32 for the record only: the port runs its products in full FP32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got = jam_lnprob(fit, pos64, tier)
            with jam_mode(tier):
                fn = fit.batched_lnprob()
                thetas = fit._to_device(pos64)
                timing[f"{tier} tf32 64 ms"] = wall_ms(lambda: fn(thetas))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        want = np.asarray(ref[tier], np.float64)
        fin = np.isfinite(want)
        got = got.double().cpu().numpy()
        timing[f"{tier} tf32 max err"] = (float(np.max(np.abs(got[fin] - want[fin])))
                                          if np.isfinite(got[fin]).all() else math.inf)
    torch.cuda.reset_peak_memory_stats()
    jam_lnprob(fit, big, "grid")
    torch.cuda.synchronize()
    timing[f"grid peak MB {n_big}"] = torch.cuda.max_memory_allocated() / 1e6
    out["timing"] = timing
    # the least time of one engine call's pair table at the grid tier, n_big
    # walkers: its exps on the SFU against the table's bytes written once and
    # read once, and the contraction's FP32 flops
    pairs = jam_table_bytes(fit, n_big, "grid") / 4
    rows = 2 * fit._mge_tensors[0].shape[-1] + 1
    out["bound"] = dict(exp_ms=pairs / SFU_OPS_PER_S * 1e3,
                        table_ms=2 * 4 * pairs / HBM_BYTES_PER_S * 1e3,
                        product_ms=2 * rows * pairs / FP32_FLOPS_PER_S * 1e3)
    return out


def phase_production_recipe(device):
    """Phase 33, path K1: the production recipe through ``python -m
    mcmc_dynamics_tpu_torch.cli.run`` (auto dispatch on the grid tier), the
    recipe's 64 seeded walkers against the JAX package on both tiers, and a
    bitwise resume; returns its numbers."""
    import torch

    import mcmc_dynamics_tpu_torch as port

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg, path = k1_config(tmp)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "mcmc_dynamics_tpu_torch.cli.run",
                               str(path), "--device", torch.device(device).type],
                              cwd=REPO, capture_output=True, text=True, timeout=900)
        out["cli_s"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"cli.run exited {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
        if "likelihood tier: grid" not in proc.stderr:
            raise AssertionError("cli.run did not take the grid tier")
        prefix = cfg["prefix"]
        with np.load(prefix + "_chain.npz") as f:
            chain, lnprob = f["chain"], f["lnprob"]
        s = cfg["sampling"]
        if chain.shape != (s["n_walkers"], s["n_steps"], 9) or not (
                np.isfinite(chain).all() and np.isfinite(lnprob).all()):
            raise AssertionError(f"cli.run chain {chain.shape} not finite")
        masses = np.load(prefix + "_mass_posterior.npy")
        profile = port.utils.Table.read(prefix + "_profile.ecsv")
        binned = port.utils.Table.read(prefix + "_binned.csv", fmt="csv")
        for name, col in (("mass", masses), ("v_rot", profile.value("v_rot")),
                          ("sigma", profile.value("sigma")),
                          ("binned sigma_max", binned.value("sigma_max median"))):
            if not np.isfinite(col).all():
                raise AssertionError(f"cli.run output {name} not finite")
        out["mass"] = np.percentile(masses, [16, 50, 84]).tolist()
        out["bins"] = len(binned)
        out["lnprob_median_last"] = float(np.median(lnprob[:, -1]))

    reference = json.loads(JAM_REFERENCE.read_text())["recipe"]
    fit32 = k1_fit(port, device=device)
    fit64 = k1_fit(port, device=device, dtype=torch.float64)
    if fit32.lnprob_tier() != "grid":
        raise AssertionError(f"recipe tier {fit32.lnprob_tier()}, expected grid")
    pos = np.asarray(reference["walkers"])
    if not np.array_equal(fit64.get_initials(JAM_WALKERS), pos):
        raise AssertionError("K1: the port's initial walkers differ from the JAX "
                             "package's")
    out["checks"] = jam_checks("K1", fit32, fit64, pos, reference, need_inf=False)
    out["stars"] = fit32.n_data
    _, s_per_step = run_with_resume("K1", fit32, K1_STEPS["n_walkers"],
                                    K1_STEPS["n_steps"], K1_STEPS["n_out"],
                                    n_extra=K1_STEPS["n_extra"])
    out["ms_per_step"] = s_per_step * 1e3
    out["fit"] = fit32
    return out


def k2_mock(device):
    """Path K2's self-consistent mock: 16384 stars drawn from the recipe's
    tracer MGE, velocities drawn from the port's float64 engine at K2_TRUTH;
    returns numpy columns."""
    import torch

    from mcmc_dynamics_tpu_torch.models.jam.moments import jam_los_moments
    from mcmc_dynamics_tpu_torch.utils import get_mge, xy_offset_rad

    rng = np.random.default_rng(34)
    n = K2_RUN["n_stars"]
    cfg = json.loads(CONFIG.read_text())
    mge_lum, mge_mass = get_mge(REPO / cfg["mge"])
    li, ls, lq = mge_lum.as_arrays()
    comp = rng.choice(li.size, n, p=li * ls ** 2 * lq / np.sum(li * ls ** 2 * lq))
    x = rng.normal(size=n) * ls[comp]
    y = rng.normal(size=n) * ls[comp] * lq[comp]
    theta0 = math.atan2(K2_TRUTH["kappa_y"], K2_TRUTH["kappa_x"])
    dx = x * math.cos(theta0) - y * math.sin(theta0)         # model frame -> sky
    dy = x * math.sin(theta0) + y * math.cos(theta0)
    ra_c, dec_c = K2_FIXED["ra_center"], K2_FIXED["dec_center"]
    ra = ra_c - dx / 3600.0 / math.cos(math.radians(dec_c))
    dec = dec_c + dy / 3600.0
    # the model-frame positions the likelihood will see: the exact offsets
    ex, ey = xy_offset_rad(np.radians(ra), np.radians(dec), math.radians(ra_c),
                           math.radians(dec_c), xp=np)
    ex, ey = ex * 206264.80624709636, ey * 206264.80624709636
    mx = ex * math.cos(theta0) + ey * math.sin(theta0)
    my = -ex * math.sin(theta0) + ey * math.cos(theta0)
    median_q = float(np.median(lq))
    barq = K2_TRUTH["barq"]
    incl = math.acos(math.sqrt((median_q ** 2 - barq ** 2) / (1.0 - barq ** 2)))

    def t64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    res = jam_los_moments(t64(mx), t64(my), *(t64(a) for a in (li, ls, lq)),
                          *(t64(a) for a in mge_mass.as_arrays()),
                          d=K2_FIXED["d"], beta=K2_FIXED["beta"],
                          kappa=math.hypot(K2_TRUTH["kappa_x"], K2_TRUTH["kappa_y"]),
                          mscale=K2_TRUTH["mlr"], incl=incl, mbh=K2_TRUTH["mbh"],
                          rbh=K2_FIXED["rbh"])
    if not bool(res.valid[0]):
        raise AssertionError("K2 truth: invalid deprojection")
    vz = res.vz[0].cpu().numpy()
    sigma = np.sqrt(res.v2zz[0].cpu().numpy() - vz ** 2)
    verr = 0.5 + 1.5 * rng.random(n)
    v = vz - K2_TRUTH["delta_v"] + sigma * rng.normal(size=n) + verr * rng.normal(size=n)
    return {"ra": (ra, "deg"), "dec": (dec, "deg"), "v": (v, "km/s"),
            "verr": (verr, "km/s")}


def k2_fit(device, columns):
    from mcmc_dynamics_tpu_torch.models import Axisymmetric
    from mcmc_dynamics_tpu_torch.utils import get_mge

    cfg = json.loads(CONFIG.read_text())
    mge_lum, mge_mass = get_mge(REPO / cfg["mge"])
    params = Axisymmetric.default_parameters()
    for name, val in K2_FIXED.items():
        params[name].set(value=val, fixed=True)
    for name, (lo, hi) in dict(mlr=(0.5, 10.0), kappa_x=(-2.0, 2.0),
                               kappa_y=(-2.0, 2.0), mbh=(0.0, 1e6),
                               delta_v=(-5.0, 5.0)).items():
        params[name].set(value=K2_TRUTH[name], min=lo, max=hi, fixed=False)
    params["barq"].set(value=K2_TRUTH["barq"], fixed=False)
    return Axisymmetric(port_reader(columns), parameters=params, mge_lum=mge_lum,
                        mge_mass=mge_mass, seed=35, device=device)


def phase_jam_recovery(device):
    """Phase 34, path K2: 64 walkers x 1500 steps on the grid tier on the
    16384-star mock; every free parameter's truth inside its posterior's
    0.15-99.85 % interval; returns its numbers."""
    import torch

    fit = k2_fit(device, k2_mock(device))
    if fit.lnprob_tier() != "grid":
        raise AssertionError(f"K2 tier {fit.lnprob_tier()}, expected grid")
    free = fit.fitted_parameters
    rng = np.random.default_rng(36)
    truth = np.array([K2_TRUTH[name] for name in free])
    scale = np.array([0.05 * K2_TRUTH["mbh"] if name == "mbh" else
                      0.05 if name == "delta_v" else 0.01 for name in free])
    pos = truth + scale * rng.normal(size=(K2_RUN["n_walkers"], len(free)))
    fit(n_walkers=K2_RUN["n_walkers"], n_steps=20, pos=pos, prefix=None)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = fit(n_walkers=K2_RUN["n_walkers"], n_steps=K2_RUN["n_steps"], pos=pos,
              prefix=None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    flat = run.chain[:, K2_RUN["n_burn"]:, :].reshape(-1, len(free))
    lo, med, hi = np.percentile(flat, [0.15, 50, 99.85], axis=0)
    for name, t, a, b in zip(free, truth, lo, hi):
        if not a <= t <= b:
            raise AssertionError(f"K2: truth {name} = {t:g} outside the posterior's "
                                 f"0.15-99.85 % interval [{a:.5g}, {b:.5g}]")
    return dict(stars=fit.n_data, walkers=K2_RUN["n_walkers"], steps=K2_RUN["n_steps"],
                ms_per_step=seconds / K2_RUN["n_steps"] * 1e3,
                acceptance=float(np.mean(run.acceptance_fraction)),
                medians={n: float(m) for n, m in zip(free, med)},
                intervals={n: (float(a), float(b)) for n, a, b in zip(free, lo, hi)},
                fit=fit, pos=pos)


# ----------------------------------------------------------------------------- main
# ----------------------------------------------------------------------------- samplers
# phase 35, path L1: example/omega_cen_tempered.json through cli.run in this
# process, without its ``parallel`` block (a tp mesh of 4) and with
# ``sampling.n_temps`` the mesh's extent; the ladder's resume in L1_RESUME steps
TEMPERED_RECIPE = REPO / "example" / "omega_cen_tempered.json"
L1_RESUME = (17, 23)
L1_TIMED_STEPS = 200
# phase 36, path L2: HMC on A's fixed-centre recipe (the generic tier, plain
# torch); the JAX package's float64 medians at the same settings come from
# ``chip_smoke_reference.py L2 --write``
L2_RUN = dict(n_walkers=32, n_warmup=200, n_steps=300, n_leapfrog=10, step_size=0.05,
              seed=2)
L2_BURN = 100
SAMPLERS_REFERENCE = REPO / "chip_smoke_samplers_reference.json"
# phase 37, path L3: the emcee-compatible sampler; the correlated 3-d Gaussian
# of tests/test_torch_moves.py with test_posterior_matches_analytic_gaussian's
# snooker bounds (mean, std, covariance in units of the standard deviations)
L3_MEAN = (1.0, -2.0, 0.5)
L3_COV = ((2.0, 0.9, 0.0), (0.9, 1.0, -0.3), (0.0, -0.3, 0.5))
L3_GAUSS = dict(n_walkers=64, n_steps=3000, n_burn=1000, seed=7)
L3_TOL = (0.1, 0.1, 0.15)
L3_RUN = (300, 300)


def tempered_config(tmp):
    """The tempered recipe without its mesh, in ``tmp``: (config, path)."""
    cfg = json.loads(TEMPERED_RECIPE.read_text())
    cfg["sampling"]["n_temps"] = cfg.pop("parallel")["axes"]["tp"]
    cfg["data"]["file"] = str(REPO / cfg["data"]["file"])
    cfg["prefix"] = str(pathlib.Path(tmp) / cfg["prefix"])
    path = pathlib.Path(tmp) / "omega_cen_tempered.json"
    path.write_text(json.dumps(cfg))
    return cfg, path


class _Records(logging.Handler):
    """Keeps the records a logger emits."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def run_cli_here(argv):
    """``cli.run.main(argv)`` in this process (its kernel launches count
    here), with its log records; the root logger's handlers and level as
    they were afterwards.  Returns (records, seconds)."""
    import torch

    from mcmc_dynamics_tpu_torch.cli import run as cli_run

    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    records = _Records()
    cli_logger = logging.getLogger(cli_run.__name__)
    cli_logger.addHandler(records)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        if cli_run.main(argv) != 0:
            raise AssertionError(f"cli.run {argv} did not return 0")
        torch.cuda.synchronize()
    finally:
        cli_logger.removeHandler(records)
        for handler in root.handlers[:]:
            if handler not in handlers:
                root.removeHandler(handler)
                handler.close()
        root.setLevel(level)
    return records.records, time.perf_counter() - t0


def phase_tempered_recipe(device):
    """Phase 35, path L1: the tempered recipe through the port's CLI (the
    ladder of 4 x 32 walkers on kernel 1, 64 walkers a half-step), the cold
    chain inside the omega_cen_tempered goldens, its log-evidence logged,
    kernel 1 launched 1 + 2 x n_steps times by the CLI; then
    ``sample_tempered`` in L1_RESUME steps through ``state=`` against one
    run, bit for bit, and a timed run of L1_TIMED_STEPS (its log-evidence
    finite, its swap acceptance per pair printed)."""
    import torch

    from mcmc_dynamics_tpu_torch.ops import KERNELS

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg, path = tempered_config(tmp)
        records, out["cli_s"] = run_cli_here([str(path), "--device",
                                              torch.device(device).type, "--skip-binned"])
        out["cli_launches"] = KERNELS["model_lnlike"].launches
        with np.load(cfg["prefix"] + "_chain.npz") as f:
            chain, lnprob, coords = f["chain"], f["lnprob"], f["coords"]
    s = cfg["sampling"]
    n_temps, n_walkers, n_steps = s["n_temps"], s["n_walkers"], s["n_steps"]
    if chain.shape != (n_walkers, n_steps, 6) or coords.shape != (n_temps, n_walkers, 6):
        raise AssertionError(f"L1: cold chain {chain.shape}, ladder {coords.shape}")
    if not (np.isfinite(chain).all() and np.isfinite(lnprob).all()):
        raise AssertionError("L1: cold chain not finite")
    if out["cli_launches"] != 1 + 2 * n_steps:
        raise AssertionError(f"L1: cli.run launched kernel 1 {out['cli_launches']} "
                             f"times, expected 1 + 2 x {n_steps} (the ladder alone)")
    if not any("log-evidence" in r.getMessage() for r in records):
        raise AssertionError("L1: cli.run logged no log-evidence")
    golden = json.loads(GOLDENS.read_text())["omega_cen_tempered"]
    out["medians"] = check_goldens(chain, s["n_burn"], golden)

    fit, _ = load_recipe(device, TEMPERED_RECIPE)
    if fit.lnprob_tier() != "direct":
        raise AssertionError(f"L1 tier {fit.lnprob_tier()}, expected direct")
    kw = dict(n_temps=n_temps, beta_min=s["beta_min"], swap_every=s["swap_every"],
              move=[tuple(m) for m in s["move"]])
    pos = fit.get_initials(n_walkers)
    whole, _ = fit.sample_tempered(n_steps=sum(L1_RESUME), pos=pos, **kw)
    first, _ = fit.sample_tempered(n_steps=L1_RESUME[0], pos=pos, **kw)
    second, _ = fit.sample_tempered(n_steps=L1_RESUME[1], state=first.final_state, **kw)
    if not (np.array_equal(whole.chain, np.concatenate([first.chain, second.chain], 1))
            and torch.equal(whole.final_state.coords, second.final_state.coords)
            and torch.equal(whole.final_state.swaps_accepted,
                            second.final_state.swaps_accepted)):
        raise AssertionError(f"L1: {L1_RESUME[0]} + {L1_RESUME[1]} ladder steps through "
                             f"state= differ from {sum(L1_RESUME)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed, out["log_z"] = fit.sample_tempered(n_steps=L1_TIMED_STEPS, pos=pos, **kw)
    torch.cuda.synchronize()
    out["s_per_step"] = (time.perf_counter() - t0) / L1_TIMED_STEPS
    if not np.isfinite(out["log_z"]):
        raise AssertionError(f"L1: log-evidence {out['log_z']}")
    # swap acceptance per adjacent pair: accepted swaps over swap rounds x walkers
    out["swaps"] = (timed.final_state.swaps_accepted.cpu().numpy()
                    / (L1_TIMED_STEPS // s["swap_every"] * n_walkers)).round(4).tolist()
    out.update(stars=fit.n_data, walkers=f"{n_temps} x {n_walkers}", steps=n_steps,
               evals_per_s=n_temps * n_walkers / out["s_per_step"],
               acceptance=float(np.mean(timed.acceptance_fraction)),
               medians={k: float(v) for k, v in out["medians"].items()})
    return out


def phase_hmc(device):
    """Phase 36, path L2: ``sample_hmc`` on A's recipe (windowed warmup,
    the generic tier's autograd; no kernel), lnP finite, the medians inside
    the omega_cen_fixed goldens (the JAX package's float64 run at these
    settings lies inside them too: chip_smoke_samplers_reference.json)."""
    import torch

    fit, _ = load_recipe(device)
    reference = json.loads(SAMPLERS_REFERENCE.read_text())["L2"]
    if not reference["inside_goldens"]:
        raise AssertionError("L2: the JAX reference lies outside the goldens; hold "
                             "the port to its medians instead")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = fit.sample_hmc(**L2_RUN)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not (np.isfinite(run.lnprobability).all() and np.isfinite(run.chain).all()):
        raise AssertionError("L2: HMC chain or lnP not finite")
    golden = json.loads(GOLDENS.read_text())["omega_cen_fixed"]
    values = check_goldens(run.chain, L2_BURN, golden)
    n_warmup = L2_RUN["n_warmup"]
    steps = n_warmup + max(n_warmup // 2, 50) + L2_RUN["n_steps"]
    return dict(stars=fit.n_data, walkers=L2_RUN["n_walkers"], steps=steps,
                s_per_step=seconds / steps,
                evals_per_s=L2_RUN["n_walkers"] * L2_RUN["n_leapfrog"] * steps / seconds,
                acceptance=float(np.mean(run.acceptance_fraction)),
                step_size=float(torch.exp(run.final_state.log_step)),
                medians={k: float(v) for k, v in values.items()},
                jax_medians=reference["medians"])


def phase_emcee(device):
    """Phase 37, path L3: the emcee-compatible sampler on the card: a
    per-walker torch Gaussian through ``torch.func.vmap`` (moments in the
    bounds), A's recipe vectorized through kernel 1 (300 + 300 steps through
    an in-memory Backend equal 600 bit for bit, and equal ``fit(...)`` at the
    seed the sampler draws), and a scipy log-prob on the NumPy path."""
    import torch
    from scipy import stats

    from mcmc_dynamics_tpu_torch import default_dtype
    from mcmc_dynamics_tpu_torch.emcee_compat import EnsembleSampler, backends

    out = {}
    dtype = default_dtype(device)        # the sampler's: float32 on the card
    mean_t = torch.tensor(L3_MEAN, dtype=dtype, device=device)
    prec_t = torch.tensor(np.linalg.inv(L3_COV), dtype=dtype, device=device)

    def gauss(theta):
        d = theta - mean_t
        return -0.5 * torch.dot(d, prec_t @ d)

    g = L3_GAUSS
    sampler = EnsembleSampler(g["n_walkers"], 3, gauss, seed=g["seed"], device=device)
    if sampler.backend_kind != "torch":
        raise AssertionError(f"L3 Gaussian took the {sampler.backend_kind} path")
    p0 = np.random.default_rng(0).normal(0, 1, (g["n_walkers"], 3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler.run_mcmc(p0, g["n_steps"])
    torch.cuda.synchronize()
    out["gauss_ms"] = (time.perf_counter() - t0) / g["n_steps"] * 1e3
    flat = sampler.get_chain(discard=g["n_burn"], flat=True).astype(np.float64)
    cov = np.asarray(L3_COV)
    sd = np.sqrt(np.diag(cov))
    errs = (np.max(np.abs(flat.mean(axis=0) - L3_MEAN) / sd),
            np.max(np.abs(flat.std(axis=0) - sd) / sd),
            np.max(np.abs(np.cov(flat.T) - cov) / np.sqrt(np.outer(np.diag(cov),
                                                                  np.diag(cov)))))
    out["gauss_errs"] = [float(e) for e in errs]
    out["gauss_acceptance"] = float(sampler.acceptance_fraction.mean())
    if any(e >= tol for e, tol in zip(errs, L3_TOL)) or out["gauss_acceptance"] <= 0.15:
        raise AssertionError(f"L3 Gaussian moments {out['gauss_errs']} (bounds "
                             f"{L3_TOL}), acceptance {out['gauss_acceptance']:.3f}")

    fit, sampling = load_recipe(device)
    lnprob, n_walkers = fit.batched_lnprob(), sampling["n_walkers"]
    pos = fit.get_initials(n_walkers)
    ndim = pos.shape[1]
    backend = backends.Backend()
    first = EnsembleSampler(n_walkers, ndim, lnprob, vectorize=True, seed=5,
                            device=device, backend=backend)
    if first.backend_kind != "torch":
        raise AssertionError(f"L3 vectorized recipe took the {first.backend_kind} path")
    first.run_mcmc(pos, L3_RUN[0])
    EnsembleSampler(n_walkers, ndim, lnprob, vectorize=True, seed=99, device=device,
                    backend=backend).run_mcmc(None, L3_RUN[1])
    whole = EnsembleSampler(n_walkers, ndim, lnprob, vectorize=True, seed=5,
                            device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole.run_mcmc(pos, sum(L3_RUN))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not (np.array_equal(whole.get_chain(), backend.get_chain())
            and np.array_equal(whole.get_log_prob(), backend.get_log_prob())):
        raise AssertionError(f"L3: {L3_RUN[0]} + {L3_RUN[1]} steps through a Backend "
                             f"differ from {sum(L3_RUN)}")
    # the sampler seeds its generator with its NumPy generator's first integer
    fit_seed = int(np.random.default_rng(5).integers(0, 2 ** 31))
    ref = fit(n_walkers=n_walkers, n_steps=sum(L3_RUN), pos=pos, seed=fit_seed,
              prefix=None)
    if not np.array_equal(np.swapaxes(whole.get_chain(), 0, 1), ref.chain):
        raise AssertionError("L3: the vectorized sampler's chain differs from "
                             "fit(...) at the same seed and start")
    values = check_goldens(np.swapaxes(whole.get_chain(), 0, 1), sampling["n_burn"],
                           json.loads(GOLDENS.read_text())["omega_cen_fixed"])

    def scipy_lnprob(theta):
        return float(stats.multivariate_normal.logpdf(theta, L3_MEAN, cov))

    host = EnsembleSampler(16, 3, scipy_lnprob, seed=1, device=device)
    if host.backend_kind != "numpy":
        raise AssertionError(f"L3: a scipy log-prob took the {host.backend_kind} path")
    host.run_mcmc(np.random.default_rng(1).normal(size=(16, 3)), 20)
    if not np.isfinite(host.get_log_prob()).all():
        raise AssertionError("L3: the NumPy path's chain is not finite")
    out.update(stars=fit.n_data, walkers=n_walkers, steps=sum(L3_RUN),
               s_per_step=seconds / sum(L3_RUN),
               evals_per_s=n_walkers * sum(L3_RUN) / seconds,
               acceptance=float(whole.acceptance_fraction.mean()),
               medians={k: float(v) for k, v in values.items()})
    return out


# ----------------------------------------------------------------------------- meshes
# phases 38-41: worlds of several ranks, one process a rank, spawned from this
# script with the torchrun environment (RANK, WORLD_SIZE, LOCAL_RANK,
# MASTER_ADDR/PORT on localhost) and a time limit of their own.  On the one
# card the ranks of a world share it: the mesh's collectives go over gloo
# with host staging, and a world of one rank takes NCCL.  Each rank writes
# its numbers (and its chains) under the world's directory; a rank that
# fails ends the world, the phase and the run.
WORLD_TIMEOUT_S = 300
M1_N_OUT = 300                      # path M1 (a): the checkpoint it resumes from
M1_RESUME_EXTRA = 50
# path M2: every partial tier, on the walkers and catalogs of the paths named
# (path, kernel, tier, walkers, kernel's rows and columns for the bound,
# (module, wrapper) the plain version stands in for)
M2_CASES = (
    ("A", "model_lnlike", "direct", 64, 6, 6, ("model", "model_lnlike_batched")),
    ("D", "model_freecenter", "freecenter", 64, 8, 8,
     ("model", "model_freecenter_lnlike_batched")),
    ("E1", "constant_gb", "gb", 256, 7, 7, ("constant", "constant_gb_lnlike_batched")),
    ("F1", "model_mixture", "model_mixture", 256, 8, 9,
     ("model", "model_mixture_lnlike_batched")),
    ("F2", "model_mixture_lnb", "model_mixture", 256, 9, 7,
     ("model", "model_mixture_lnlike_batched")),
    ("G1", "double_model", "double", 64, 6, 9, ("double_model", "double_model_lnlike_batched")),
    ("G2", "double_model_gb", "double_gb", 256, 8, 12,
     ("double_model", "double_model_gb_lnlike_batched")),
    ("K2", None, "grid", 64, 0, 0, None))
M2_STEPS = 20
M2_K2_STEPS = 2
M2_SP = 4
M3_RESUME = (25, 35)
PROFILE_STEPS = 100


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _zero_counts():
    from mcmc_dynamics_tpu_torch.ops import KERNELS

    for kernel in KERNELS.values():
        kernel.launches = 0


def _counts():
    from mcmc_dynamics_tpu_torch.ops import KERNELS

    return {name: kernel.launches for name, kernel in KERNELS.items()}


def spawn_world(phase, n_ranks, device, out, profiling=False, timeout=WORLD_TIMEOUT_S):
    """Run world ``phase`` as ``n_ranks`` processes of this script (``--world
    phase device rank n out profiling``) with the torchrun environment
    (``profiling``: rank 0 traces its main path too); each rank's
    result is ``out/<phase>_<rank>.json``.  A rank that exits non-zero, or the
    time limit, kills every rank and raises with their last output."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out.mkdir(parents=True, exist_ok=True)
    procs, logs = [], []
    for rank in range(n_ranks):
        # one host thread a rank: the ranks share the host's cores
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(n_ranks), LOCAL_WORLD_SIZE=str(n_ranks),
                   RANK=str(rank), LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
        log = out / f"{phase}_{n_ranks}_{rank}.log"
        logs.append(log)
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--world", phase,
                 str(device), str(rank), str(n_ranks), str(out), str(int(profiling))],
                cwd=out, env=env, stdout=f, stderr=subprocess.STDOUT))
    t_start = time.monotonic()
    deadline = t_start + timeout
    failed = None
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs):
            failed = "a rank failed"
            break
        if time.monotonic() > deadline:
            failed = f"the world ran past {timeout} s"
            break
        time.sleep(0.1)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    if failed is None and any(p.returncode for p in procs):
        failed = "a rank failed"
    if failed:
        tails = "\n".join(f"--- rank {r} (rc {p.returncode}):\n"
                          + "\n".join(log.read_text().splitlines()[-25:])
                          for r, (p, log) in enumerate(zip(procs, logs)))
        raise AssertionError(f"world {phase} of {n_ranks} ranks: {failed}\n{tails}")
    results = [json.loads((out / f"{phase}_{r}.json").read_text()) for r in range(n_ranks)]
    results[0]["world_s"] = time.monotonic() - t_start
    return results


def world_main(argv) -> int:
    """One rank of a world: ``--world <phase> <device> <rank> <n> <dir>
    <profiling>``."""
    import torch

    phase, device, rank, n_ranks, out, profiling = argv
    out = pathlib.Path(out)
    torch.set_num_threads(1)
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            print("chip_smoke --world: no CUDA device", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:                   # a rehearsal on the CPU: nothing to wait for
        torch.cuda.synchronize = lambda device=None: None
    from mcmc_dynamics_tpu_torch.parallel import distributed

    distributed.initialize()                   # the torchrun environment
    try:
        result = WORLDS[phase](device, int(rank), int(n_ranks), out)
        if profiling == "1":
            result["profile"] = PROFILES[phase](device, int(rank), int(n_ranks))
        distributed.barrier()        # every rank done with its collectives
    finally:
        distributed.shutdown()
    (out / f"{phase}_{rank}.json").write_text(json.dumps(result))
    return 0


def m1_run(label, shape, device, out, rank):
    """Path M1 (``label``) in one rank: A's recipe on a dp x sp mesh of
    ``shape``, one timed run.  (a), dp 2 x sp 2: kernel 1 on star slices;
    the run's checkpoint at M1_N_OUT steps, resumed for M1_RESUME_EXTRA
    steps, bit for bit the run's next steps; its final lnP against the full
    catalog's kernel 1.  The chain is saved for the parent."""
    from mcmc_dynamics_tpu_torch.parallel import make_mesh

    t_start = time.perf_counter()
    mesh = make_mesh(("dp", "sp"), shape, device=device)
    fit, sampling = load_recipe(device)
    n_walkers, n_steps = sampling["n_walkers"], sampling["n_steps"]
    pos = fit.get_initials(n_walkers)
    _zero_counts()
    _sync(device)
    t0 = time.perf_counter()
    run = fit(n_walkers=n_walkers, n_steps=n_steps, n_out=sampling["n_out"], pos=pos,
              prefix=None, mesh=mesh)
    _sync(device)
    seconds = time.perf_counter() - t0
    launches = _counts()
    err = None
    if label == "a":
        prefix = str(out / "m1a")
        first = fit(n_walkers=n_walkers, n_steps=M1_N_OUT, n_out=M1_N_OUT, pos=pos,
                    prefix=prefix, mesh=mesh)
        rest = fit(state=fit.load_state(prefix + "_chain.npz"),
                   n_steps=M1_RESUME_EXTRA, prefix=None, mesh=mesh)
        if not (np.array_equal(run.chain[:, :M1_N_OUT], first.chain) and np.array_equal(
                run.chain[:, M1_N_OUT:M1_N_OUT + M1_RESUME_EXTRA], rest.chain)):
            raise AssertionError("M1 (a): checkpoint resume not bitwise")
        # the partial sums against one full-catalog kernel 1 call
        final = run.final_state
        err = compare("M1 (a) final lnP", final.log_prob,
                      fit.batched_lnprob()(final.coords), **DIRECT_TOL)
    np.save(out / f"m1{label}_{rank}.npy", run.chain)
    return dict(backend=mesh.backend, mesh=mesh.shape, launches=launches,
                ms_per_step=seconds / n_steps * 1e3, steps=n_steps,
                acceptance=float(np.mean(run.acceptance_fraction)), lnp_err=err,
                tier=fit.lnprob_tier(), wall_s=time.perf_counter() - t_start)


def world_mesh4(device, rank, n_ranks, out):
    """One rank of the world of four: paths M1 (a) and (b), M2 and M3 in
    turn (one world, so one start-up of four processes)."""
    return {"m1": {label: m1_run(label, shape, device, out, rank)
                   for label, shape in (("a", (2, 2)), ("b", (4, 1)))},
            "m2": world_m2(device, rank, n_ranks, out),
            "m3": world_m3(device, rank, n_ranks, out)}


def m2_fit(device, path):
    """Path ``path``'s model and walkers, built as its phase builds them."""
    from mcmc_dynamics_tpu_torch import models
    from mcmc_dynamics_tpu_torch.background import SingleStars

    if path == "A":
        fit, _ = load_recipe(device)
    elif path == "D":
        fit, _ = freecenter_fit(device)
    elif path == "E1":
        columns, _, _ = contaminated_catalog()
        fit = models.ConstantFitGB(port_reader(columns), parameters=contaminated_params(
            models.ConstantFitGB.default_parameters(), gb=True), seed=22, device=device)
    elif path in ("F1", "F2", "G2"):
        columns, field, _ = contaminated_catalog(**F_CATALOG)
        background = SingleStars(field, device=device) if path == "F2" else None
        fit = radial_fit(models, port_reader, path, columns, background, device=device)
    elif path == "G1":
        cfg = json.loads(RECIPE.read_text())
        fit = models.DoubleModelFit(read_catalog(cfg), seed=cfg["sampling"]["seed"],
                                    device=device, parameters=double_recipe_params(
                                        models.DoubleModelFit.default_parameters()))
    else:
        fit = k2_fit(device, k2_mock(device))
        free = fit.fitted_parameters
        truth = np.array([K2_TRUTH[name] for name in free])
        scale = np.array([0.05 * K2_TRUTH["mbh"] if name == "mbh" else
                          0.05 if name == "delta_v" else 0.01 for name in free])
        rng = np.random.default_rng(36)
        return fit, truth + scale * rng.normal(size=(K2_RUN["n_walkers"], len(free)))
    walkers = dict((c[0], c[3]) for c in M2_CASES)[path]
    return fit, fit.get_initials(walkers)


class _plain:
    """The plain version in place of a model module's kernel wrapper."""

    def __init__(self, module, wrapper):
        import importlib

        from mcmc_dynamics_tpu_torch import ops

        self.module = importlib.import_module(f"mcmc_dynamics_tpu_torch.models.{module}")
        self.wrapper = wrapper
        self.plain = getattr(ops, wrapper.replace("_batched", "_reference"))

    def __enter__(self):
        self.saved = getattr(self.module, self.wrapper)
        setattr(self.module, self.wrapper, self.plain)

    def __exit__(self, *exc):
        setattr(self.module, self.wrapper, self.saved)


def world_m2(device, rank, n_ranks, out):
    """Path M2 in one rank of a dp 1 x sp 4 mesh: for every partial tier, the
    path's model built and sampled M2_STEPS steps on the star-sharded mesh
    (the launches counted), then this rank's slice: the kernel against its
    float64 plain version, the slices' all-reduced sum (+ prior) against one
    full-catalog call, at the path's gate; rank 0 times the partial."""
    import torch

    from mcmc_dynamics_tpu_torch.parallel import make_mesh, run_ensemble_sharded
    from mcmc_dynamics_tpu_torch.parallel import distributed
    from mcmc_dynamics_tpu_torch.parallel.sharded import _star_slice
    from mcmc_dynamics_tpu_torch.sampler import make_generator

    mesh = make_mesh(("dp", "sp"), (1, M2_SP), device=device)
    result = {"backend": mesh.backend}
    for path, kernel, tier, walkers, rows_k, cols_k, wrapper in M2_CASES:
        t_start = time.perf_counter()
        _zero_counts()
        fit, pos = m2_fit(device, path)
        if fit.lnprob_tier() != tier:
            raise AssertionError(f"M2 {path}: tier {fit.lnprob_tier()}, expected {tier}")
        partial = fit._partial_tier_cached()
        if partial is None:
            raise AssertionError(f"M2 {path}: no partial tier")
        steps = M2_K2_STEPS if path == "K2" else M2_STEPS
        _sync(device)
        t0 = time.perf_counter()
        run = run_ensemble_sharded(fit, pos, make_generator(fit.seed, device), steps, mesh)
        _sync(device)
        seconds = time.perf_counter() - t0
        launches = _counts()
        if not torch.isfinite(run.final_log_prob).any():
            raise AssertionError(f"M2 {path}: no finite lnP after {steps} steps")
        local = _star_slice(fit, mesh, "sp")
        thetas = fit._to_device(pos[:walkers // 2])
        got = partial(thetas, local)
        entry = dict(launches=launches, ms_per_step=seconds / steps * 1e3, steps=steps,
                     slice_stars=int(local["mask"].sum().item()),
                     slice_rows=int(local["mask"].shape[0]), walkers=walkers // 2)
        gate = JAM_GRID_TOL if kernel is None else DIRECT_TOL
        if wrapper is not None:
            with _plain(*wrapper):
                ref = partial(thetas.double(), {k: v.double() for k, v in local.items()})
            entry["slice_err"] = compare(f"M2 {path} slice {rank}", got, ref, **gate)
        full = fit.batched_lnprob()(thetas)
        summed = fit._with_prior(lambda t: mesh.all_reduce(got, "sp"))(thetas)
        entry["sum_err"] = compare(f"M2 {path} sum of the slices", summed, full, **gate)
        if rank == 0 and kernel is not None and torch.device(device).type == "cuda":
            entry["ms"] = cuda_ms(lambda: partial(thetas, local))
            with _plain(*wrapper):
                entry["plain_ms"] = cuda_ms(lambda: partial(thetas, local), reps=10)
            flops, sfu = PAIR_COST[kernel]
            pairs = entry["walkers"] * entry["slice_stars"]
            entry["bound_ms"], entry["bound_by"] = bound_ms(
                4 * ((cols_k + 1) * entry["walkers"] + rows_k * entry["slice_rows"]),
                flops * pairs, sfu * pairs)
        distributed.barrier()
        entry["wall_s"] = time.perf_counter() - t_start
        result[path] = entry
        del fit, run, local
    return result


def world_m3(device, rank, n_ranks, out):
    """Path M3 in one rank: ``example/omega_cen_tempered.json`` through
    ``cli.run.main`` with its ``parallel: {axes: {tp: 4}}`` block (only its
    data file made absolute and its prefix moved under the world's
    directory), then ``sample_tempered`` on the same mesh in M3_RESUME steps
    through ``state=`` against one run."""
    import torch

    from mcmc_dynamics_tpu_torch.parallel import make_mesh
    from mcmc_dynamics_tpu_torch.parallel.tempered import swap_attempts

    t_start = time.perf_counter()
    cfg = json.loads(TEMPERED_RECIPE.read_text())
    cfg["data"]["file"] = str(REPO / cfg["data"]["file"])
    cfg["prefix"] = str(out / cfg["prefix"])
    path = out / f"omega_cen_tempered_{rank}.json"
    path.write_text(json.dumps(cfg))
    _zero_counts()
    records, cli_s = run_cli_here([str(path), "--device", str(device), "--skip-binned"])
    launches = _counts()
    messages = {r.msg: r.args for r in records}
    log_z = messages.get("thermodynamic-integration log-evidence: %.4f")
    s = cfg["sampling"]
    fit, _ = load_recipe(device, TEMPERED_RECIPE)
    mesh = make_mesh(("tp",), (cfg["parallel"]["axes"]["tp"],), device=device)
    kw = dict(beta_min=s["beta_min"], swap_every=s["swap_every"],
              move=[tuple(m) for m in s["move"]])
    pos = fit.get_initials(s["n_walkers"])
    _zero_counts()
    _sync(device)
    t0 = time.perf_counter()
    whole, _ = fit.sample_tempered(n_steps=sum(M3_RESUME), pos=pos, mesh=mesh, **kw)
    _sync(device)
    seconds = time.perf_counter() - t0
    first, _ = fit.sample_tempered(n_steps=M3_RESUME[0], pos=pos, mesh=mesh, **kw)
    second, _ = fit.sample_tempered(n_steps=M3_RESUME[1], state=first.final_state,
                                    mesh=mesh, **kw)
    if not (np.array_equal(whole.chain, np.concatenate([first.chain, second.chain], 1))
            and torch.equal(whole.final_state.coords, second.final_state.coords)):
        raise AssertionError(f"M3: {M3_RESUME[0]} + {M3_RESUME[1]} ladder steps "
                             f"through state= differ from {sum(M3_RESUME)}")
    return dict(backend=mesh.backend, cli_s=cli_s, cli_launches=launches,
                log_z=None if log_z is None else float(log_z[0]),
                swap_acceptance=(whole.final_state.swaps_accepted.cpu().numpy()
                                 / swap_attempts(mesh.shape["tp"], s["n_walkers"],
                                                 s["swap_every"], 0, sum(M3_RESUME))
                                 ).tolist(),
                resume_launches=_counts(), ms_per_step=seconds / sum(M3_RESUME) * 1e3,
                levels=int(mesh.shape["tp"]), walkers=s["n_walkers"], steps=s["n_steps"],
                wall_s=time.perf_counter() - t_start)


def world_m4(device, rank, n_ranks, out):
    """Path M4 in one rank: path I1 (fit_radial_bins on the omega Cen
    catalog) with its bins over dp 2; the chains saved for the parent."""
    from mcmc_dynamics_tpu_torch import pipelines
    from mcmc_dynamics_tpu_torch.parallel import make_mesh

    mesh = make_mesh(("dp",), (n_ranks,), device=device)
    columns, (ra_c, dec_c) = binned_catalog("I1")
    _zero_counts()
    _sync(device)
    t0 = time.perf_counter()
    res = pipelines.fit_radial_bins(port_reader(columns), ra_c, dec_c, device=device,
                                    mesh=mesh, **BINNED_RUN)
    _sync(device)
    seconds = time.perf_counter() - t0
    np.save(out / f"m4_{rank}.npy", res.chains)
    return dict(backend=mesh.backend, launches=_counts(), wall_s=seconds,
                bins=res.n_bins, ms_per_step=seconds / BINNED_RUN["n_steps"] * 1e3)


WORLDS = {"mesh4": world_mesh4, "m4": world_m4}


def _world_launches(label, counts, expect):
    """The launches of a world's main path (``counts``: each rank's), summed
    over its ranks; the kernels in ``expect`` must launch, every other kernel
    must not."""
    total = {}
    for rank_counts in counts:
        for name, count in rank_counts.items():
            total[name] = total.get(name, 0) + count
    for name, count in total.items():
        if (count > 0) != (name in expect):
            raise AssertionError(f"path {label} launches: {total}")
    return {name: total[name] for name in expect}


def phase_mesh_one_rank(device, path_a_chain, tmp, profiling=False):
    """Phase 38, path M1 (c): A's recipe on a mesh of one rank (this
    script: a one-rank world, NCCL on the card), path A's chain bit for
    bit."""
    from mcmc_dynamics_tpu_torch.parallel import distributed

    try:
        run = m1_run("c", (1, 1), device, tmp, 0)
        run["profile"] = profile_m1(device, 0, ((1, 1),)) if profiling else []
    finally:
        distributed.shutdown()
    if not np.array_equal(np.load(tmp / "m1c_0.npy"), path_a_chain):
        raise AssertionError("M1 (c): not path A's chain bit for bit")
    run["ranks"] = 1
    run["launches"] = _world_launches("M1 (c)", [run["launches"]], {"model_lnlike"})
    return run


def phase_mesh_four(device, path_a_chain, tmp, profiling=False):
    """Phases 38-40 in one world of four ranks sharing the card
    (world_mesh4): M1 (a) and (b), M2, M3.  Returns each path's numbers,
    checked: the ranks' chains identical, (a)'s medians in A's goldens, (b)
    path A's chain bit for bit; M2's launches; M3's (mesh_tempered)."""
    out = tmp / "mesh4"
    ranks = spawn_world("mesh4", 4, device, out, profiling)
    golden = json.loads(GOLDENS.read_text())["omega_cen_fixed"]
    n_burn = json.loads(RECIPE.read_text())["sampling"]["n_burn"]
    m1 = {}
    for label in ("a", "b"):
        chains = [np.load(out / f"m1{label}_{r}.npy") for r in range(len(ranks))]
        if not all(np.array_equal(c, chains[0]) for c in chains[1:]):
            raise AssertionError(f"M1 ({label}): the ranks' chains differ")
        entry = dict(ranks[0]["m1"][label], ranks=len(ranks))
        entry["launches"] = _world_launches(
            f"M1 ({label})", [r["m1"][label]["launches"] for r in ranks], {"model_lnlike"})
        if label == "a":
            entry["medians"] = check_goldens(chains[0], n_burn, golden)
            entry["world_s"] = ranks[0]["world_s"]
        elif not np.array_equal(chains[0], path_a_chain):
            raise AssertionError(f"M1 ({label}): not path A's chain bit for bit")
        m1[label] = entry
    m2 = {"backend": ranks[0]["m2"]["backend"]}
    for path, kernel, *_ in M2_CASES:
        expect = set() if kernel is None else {kernel.replace("_lnb", "")}
        if path == "F2":
            expect.add("background_lse")         # SingleStars at construction
        entry = dict(ranks[0]["m2"][path])
        entry["launches"] = _world_launches(
            f"M2 {path}", [r["m2"][path]["launches"] for r in ranks], expect)
        for key in ("slice_err", "sum_err"):
            if key in entry:
                entry[key] = max(r["m2"][path][key] for r in ranks)
        m2[path] = entry
    return m1, m2, mesh_tempered([r["m3"] for r in ranks], out), \
        ranks[0].get("profile") or []


def mesh_tempered(ranks, out):
    """Path M3's checks on its ranks' results (world_m3): kernel 1 1 + 2 x
    n_steps times a rank in cli.run, the cold chain in the goldens, a finite
    log-evidence, every pair swapping."""
    r0 = ranks[0]
    n_steps = r0["steps"]
    for r in ranks:
        if r["cli_launches"]["model_lnlike"] != 1 + 2 * n_steps:
            raise AssertionError(f"M3: a rank launched kernel 1 "
                                 f"{r['cli_launches']['model_lnlike']} times in cli.run, "
                                 f"expected 1 + 2 x {n_steps}")
    if r0["log_z"] is None or not math.isfinite(r0["log_z"]):
        raise AssertionError(f"M3: cli.run logged log-evidence {r0['log_z']}")
    swaps = np.asarray(r0["swap_acceptance"])
    if not (np.isfinite(swaps).all() and (swaps > 0).all()):
        raise AssertionError(f"M3: swap acceptance per pair {swaps}")
    cfg = json.loads(TEMPERED_RECIPE.read_text())
    with np.load(out / f"{cfg['prefix']}_chain.npz") as f:
        chain, coords = f["chain"], f["coords"]
    if chain.shape != (r0["walkers"], n_steps, 6) or coords.shape[0] != r0["levels"]:
        raise AssertionError(f"M3: cold chain {chain.shape}, ladder {coords.shape}")
    golden = json.loads(GOLDENS.read_text())["omega_cen_tempered"]
    medians = check_goldens(chain, cfg["sampling"]["n_burn"], golden)
    launches = _world_launches("M3", [dict(r["cli_launches"]) for r in ranks]
                               + [r["resume_launches"] for r in ranks], {"model_lnlike"})
    return dict(r0, medians=medians, launches=launches)


def phase_mesh_binned(device, path_i1_chains, tmp, profiling=False):
    """Phase 41, path M4: path I1 with its bins over a world of two ranks
    (world_m4), bit for bit path I1's chains on both."""
    out = tmp / "m4"
    ranks = spawn_world("m4", 2, device, out, profiling)
    for r in range(len(ranks)):
        if not np.array_equal(np.load(out / f"m4_{r}.npy"), path_i1_chains):
            raise AssertionError(f"M4: rank {r}'s chains are not path I1's bit for bit")
    return dict(ranks[0], launches=_world_launches("M4", [r["launches"] for r in ranks],
                                                   set()))



def _traced(label, rank, fn, n_steps, kernel_names):
    """``fn`` run by every rank; rank 0 traces it (profile_path) and returns
    its printed line."""
    import contextlib
    import io

    if rank != 0:
        fn()
        return None
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        profile_path(label, fn, n_steps, kernel_names)
    return text.getvalue().strip()


def profile_mesh4(device, rank, n_ranks):
    """--profile: PROFILE_STEPS steps of A's recipe on dp 2 x sp 2 and dp 4 x
    sp 1 and of the tempered recipe on tp 4, traced on rank 0."""
    return profile_m1(device, rank, ((2, 2), (4, 1))) + profile_m3(device, rank, n_ranks)


def profile_m1(device, rank, shapes):
    """--profile: PROFILE_STEPS steps of A's recipe on each mesh of
    ``shapes``, traced on rank 0 (of the world, or the script itself)."""
    from mcmc_dynamics_tpu_torch.parallel import make_mesh

    lines = []
    for shape in shapes:
        mesh = make_mesh(("dp", "sp"), shape, device=device)
        fit, sampling = load_recipe(device)
        pos = fit.get_initials(sampling["n_walkers"])
        kw = dict(n_walkers=sampling["n_walkers"], pos=pos, prefix=None, mesh=mesh)
        fit(n_steps=20, **kw)                                   # warm-up
        lines.append(_traced(f"M1 dp {shape[0]} x sp {shape[1]} ({mesh.backend})", rank,
                             lambda: fit(n_steps=PROFILE_STEPS, **kw), PROFILE_STEPS,
                             ["model_lnlike_kernel", "sum_chunks_kernel<1>"]))
    return lines


def profile_m3(device, rank, n_ranks):
    """--profile: PROFILE_STEPS ladder steps of the tempered recipe on tp 4,
    traced on rank 0."""
    from mcmc_dynamics_tpu_torch.parallel import make_mesh

    cfg = json.loads(TEMPERED_RECIPE.read_text())
    s = cfg["sampling"]
    fit, _ = load_recipe(device, TEMPERED_RECIPE)
    mesh = make_mesh(("tp",), (n_ranks,), device=device)
    kw = dict(n_walkers=s["n_walkers"], pos=fit.get_initials(s["n_walkers"]),
              beta_min=s["beta_min"], swap_every=s["swap_every"],
              move=[tuple(m) for m in s["move"]], mesh=mesh)
    fit.sample_tempered(n_steps=20, **kw)
    return [_traced(f"M3 tp {n_ranks} ({mesh.backend})", rank,
                    lambda: fit.sample_tempered(n_steps=PROFILE_STEPS, **kw),
                    PROFILE_STEPS, ["model_lnlike_kernel", "sum_chunks_kernel<1>"])]


def profile_m4(device, rank, n_ranks):
    """--profile: path I1's pipeline with its bins over dp 2 (set-up
    included), traced on rank 0."""
    from mcmc_dynamics_tpu_torch import pipelines
    from mcmc_dynamics_tpu_torch.parallel import make_mesh

    mesh = make_mesh(("dp",), (n_ranks,), device=device)
    columns, (ra_c, dec_c) = binned_catalog("I1")
    return [_traced(f"M4 dp {n_ranks} ({mesh.backend}, set-up included)", rank,
                    lambda: pipelines.fit_radial_bins(port_reader(columns), ra_c, dec_c,
                                                      device=device, mesh=mesh,
                                                      **BINNED_RUN),
                    BINNED_RUN["n_steps"], [])]


PROFILES = {"mesh4": profile_mesh4, "m4": profile_m4}

def main(argv=None) -> int:
    import torch

    args = sys.argv[1:] if argv is None else argv
    if args[:1] == ["--world"]:                 # one rank of phases 38-41
        return world_main(args[1:])
    profiling = "--profile" in args
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU.", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False

    from mcmc_dynamics_tpu_torch.ops import (
        CONSTANT_GB_V2, CONSTANT_MIXTURE, DOUBLE_MODEL, KERNELS, MODEL_FREECENTER,
        MODEL_GB_V2, MODEL_LNLIKE,
        background_logsumexp,
        background_logsumexp_reference,
        constant_gb_lnlike_batched, constant_gb_lnlike_reference,
        constant_gb_v2_lnlike_batched, constant_gb_v2_lnlike_reference,
        constant_mixture_lnlike_reference, double_model_gb_lnlike_batched,
        double_model_gb_lnlike_reference, double_model_lnlike_batched,
        double_model_lnlike_reference, model_freecenter_lnlike_batched,
        model_freecenter_lnlike_reference, model_gb_v2_lnlike_batched,
        model_gb_v2_lnlike_reference, model_lnlike_batched, model_lnlike_reference,
        model_mixture_lnlike_batched, model_mixture_lnlike_reference)

    def drive(label, fn, expect):
        """Run one main path with every launch count at 0 before it; the
        kernels in ``expect`` must launch, every other kernel must not."""
        for kernel in KERNELS.values():
            kernel.launches = 0
        out = fn()
        counts = {name: kernel.launches for name, kernel in KERNELS.items()}
        for name, count in counts.items():
            if (count > 0) != (name in expect):
                raise AssertionError(f"path {label} launches: {counts}")
        for name in expect:
            launches[name] += counts[name]
        out["launches"] = {name: counts[name] for name in expect}
        return out

    launches = dict.fromkeys(KERNELS, 0)
    smi = phase_environment()
    big, half = (16384, 10_000, 240), (128, 20_480, 0)
    path_shape = (32, 6284, 116)                # paths A, D and L3: 6400 stars
    ladder_shape = (64, 6284, 116)              # path L1: 4 levels x 16 walkers
    direct = pair_kernel_phase(
        2, "model_lnlike", model_lnlike_batched, model_lnlike_reference,
        direct_inputs(device), (big, path_shape, ladder_shape), DIRECT_TOL, rows_k=6,
        cols_k=6)
    batch_invariance(2, "model_lnlike", model_lnlike_batched, direct_inputs(device), big)
    mock_b, truth = mock_fit(device, n_stars=100_000, seed=5)
    tensor, b_stats = phase_tensor_kernel(device, mock_b)
    if "--chunk-sweep" in args:
        from mcmc_dynamics_tpu_torch.ops import model_tensor, model_tensor_lnlike

        ranks = b_stats.u_s.shape[1], b_stats.u_a.shape[1]
        chunk_sweep(model_tensor, "model_tensor", lambda p: model_tensor_lnlike(b_stats, p),
                    tensor_inputs(b_stats, device), ((512,), (16384,)),
                    (12, 24, 48, 96, 132, 264), attr="ROW_CHUNK",
                    count=lambda shape: model_tensor.tensor_chunks(*ranks)[1])
    del b_stats

    recipe = drive("A", lambda: phase_recipe(device), {"model_lnlike"})
    print(f"phase 4 main path A (omega Cen recipe, direct tier): "
          f"{recipe['stars']} stars, {recipe['walkers']} walkers x "
          f"{recipe['steps']} steps | {recipe['s_per_step'] * 1e3:.4f} ms/step "
          f"(650-step run) | acceptance {recipe['acceptance']:.3f} | goldens ok "
          f"{json.dumps({k: round(float(v), 4) for k, v in recipe['medians'].items()})}"
          f" | bitwise resume ok | launches {recipe['launches']}")
    path_b = drive("B", lambda: phase_table_path(device, mock_b, truth, "tensor"),
                   {"model_tensor"})
    print(f"phase 5 main path B (tensor tier): {path_b['stars']} stars, "
          f"{path_b['walkers']} walkers x {path_b['steps']} steps | table "
          f"build {path_b['setup_s']:.2f} s | {path_b['s_per_step'] * 1e3:.4f} "
          f"ms/step | "
          f"{path_b['evals_per_s']:.4g} lnprob evals/s | acceptance "
          f"{path_b['acceptance']:.3f} | medians v_sys "
          f"{path_b['medians']['v_sys']:.4f} sigma_max "
          f"{path_b['medians']['sigma_max']:.4f} (truth {truth['v_sys']}, "
          f"{truth['sigma_max']}) | launches {path_b['launches']}")

    freecenter = pair_kernel_phase(
        6, "model_freecenter", model_freecenter_lnlike_batched,
        model_freecenter_lnlike_reference, freecenter_inputs(device), (big, path_shape),
        DIRECT_TOL, rows_k=8, cols_k=8)
    batch_invariance(6, "model_freecenter", model_freecenter_lnlike_batched,
                     freecenter_inputs(device), big)
    if "--chunk-sweep" in args:
        for kernel, name, run, inputs in (
                (MODEL_LNLIKE, "model_lnlike", model_lnlike_batched,
                 direct_inputs(device)),
                (MODEL_FREECENTER, "model_freecenter", model_freecenter_lnlike_batched,
                 freecenter_inputs(device))):
            chunk_sweep(kernel, name, run, inputs, (path_shape, big),
                        (256, 512, 1024, 2048, 4096))
    mixture = pair_kernel_phase(
        7, "constant_mixture", constant_mixture_split,
        constant_mixture_lnlike_reference, constant_inputs(device, gb=False),
        ((16384, 10_000, 240), (128, 20_480, 0)), DIRECT_TOL, rows_k=7, cols_k=4)
    batch_invariance(7, "constant_mixture", constant_mixture_split,
                     constant_inputs(device, gb=False), (16384, 10_000, 240))
    if "--chunk-sweep" in args:
        chunk_sweep(CONSTANT_MIXTURE, "constant_mixture", constant_mixture_split,
                    constant_inputs(device, gb=False), (half, big),
                    (512, 1024, 2048, 4096))
    gb = pair_kernel_phase(
        8, "constant_gb", constant_gb_lnlike_batched, constant_gb_lnlike_reference,
        constant_inputs(device, gb=True), ((16384, 10_000, 240), (128, 20_480, 0)),
        DIRECT_TOL, rows_k=7, cols_k=7)
    batch_invariance(8, "constant_gb", constant_gb_lnlike_batched,
                     constant_inputs(device, gb=True), (16384, 10_000, 240))
    lse = pair_kernel_phase(
        9, "background_lse", background_logsumexp, background_logsumexp_reference,
        background_inputs(device), ((20_480, 8192, 0), (20_480, 3001, 0)),
        BACKGROUND_TOL, rows_k=1, cols_k=2, split=False)
    kde_far_and_repeat(device)

    def path_line(phase, label, out, extra=""):
        print(f"phase {phase} main path {label}: {out['stars']} stars, "
              f"{out['walkers']} walkers x {out['steps']} steps{extra} | "
              f"{out['s_per_step'] * 1e3:.4f} ms/step | {out['evals_per_s']:.4g} "
              f"lnprob evals/s | acceptance {out['acceptance']:.3f} | medians "
              f"{json.dumps({k: round(v, 5) for k, v in out['medians'].items()})} | "
              f"launches {out['launches']}")

    path_c = drive("C", lambda: phase_center_recipe(device), set())
    path_line(10, "C (omega Cen free-centre ConstantFit recipe, generic tier)",
              path_c, " | goldens ok")
    path_d = drive("D", lambda: phase_freecenter_path(device), {"model_freecenter"})
    path_line(11, "D (free-centre ModelFit on the omega Cen catalog, kernel 3)",
              path_d, " | goldens ok (ra/dec: centre bands; sigma_max: "
              "fixed-centre band) | bitwise resume ok")
    columns, field_catalog, e_truth = contaminated_catalog()
    path_e1 = drive("E1", lambda: phase_contaminated(
        device, "E1", columns, field_catalog, e_truth), {"constant_gb"})
    path_line(12, "E1 (ConstantFitGB, kernel 5)", path_e1, f" | truth {E_TRUTH}")
    path_e2 = drive("E2", lambda: phase_contaminated(
        device, "E2", columns, field_catalog, e_truth),
        {"background_lse", "constant_mixture"})
    path_line(13, "E2 (ConstantFit + SingleStars, kernels 10 and 4)", path_e2,
              f" | set-up with the KDE {path_e2['setup_s']:.3f} s")

    model_mixture = pair_kernel_phase(
        14, "model_mixture", model_mixture_lnlike_batched, model_mixture_lnlike_reference,
        radial_inputs(device, "model_mixture"), (big, half), DIRECT_TOL, rows_k=8,
        cols_k=9)
    batch_invariance(14, "model_mixture", model_mixture_lnlike_batched,
                     radial_inputs(device, "model_mixture"), big)
    mixture_lnb = pair_kernel_phase(
        15, "model_mixture_lnb", model_mixture_lnb, model_mixture_lnlike_reference,
        radial_inputs(device, "model_mixture_lnb"), (big, half), DIRECT_TOL, rows_k=9,
        cols_k=7)
    batch_invariance(15, "model_mixture_lnb", model_mixture_lnb,
                     radial_inputs(device, "model_mixture_lnb"), big)
    double = pair_kernel_phase(
        16, "double_model", double_model_lnlike_batched, double_model_lnlike_reference,
        radial_inputs(device, "double_model"), (big, (32, 6284, 0)), DIRECT_TOL,
        rows_k=6, cols_k=9)
    batch_invariance(16, "double_model", double_model_lnlike_batched,
                     radial_inputs(device, "double_model"), big)
    if "--chunk-sweep" in args:
        chunk_sweep(DOUBLE_MODEL, "double_model", double_model_lnlike_batched,
                    radial_inputs(device, "double_model"), ((32, 6284, 0), big),
                    (256, 512, 1024, 2048))
    double_gb = pair_kernel_phase(
        17, "double_model_gb", double_model_gb_lnlike_batched,
        double_model_gb_lnlike_reference, radial_inputs(device, "double_model_gb"),
        (big, half), DIRECT_TOL, rows_k=8, cols_k=12)
    batch_invariance(17, "double_model_gb", double_model_gb_lnlike_batched,
                     radial_inputs(device, "double_model_gb"), big)

    f_columns, f_field, f_truth = contaminated_catalog(**F_CATALOG)

    def radial_path(phase, path, label, expect):
        out = drive(path, lambda: phase_radial(device, path, f_columns, f_field,
                                               f_truth), expect)
        truth = dict({k: f_truth[k] for k in RADIAL_PATHS[path][3]},
                     **HELD_TO_REFERENCE.get(path, {}))
        path_line(phase, label, out, f" | set-up {out['setup_s']:.3f} s | truth {truth}")
        return out

    radial = {"F1": radial_path(18, "F1", "F1 (ModelFitGB, kernel 6)", {"model_mixture"}),
              "F2": radial_path(19, "F2", "F2 (ModelFitConstantBackground + "
                                "SingleStars, kernels 10 and 6)",
                                {"background_lse", "model_mixture"})}
    path_g1 = drive("G1", lambda: phase_double_recipe(device), {"double_model"})
    path_line(20, "G1 (DoubleModelFit on the omega Cen catalog, kernel 7)", path_g1,
              " | goldens ok (v_sys, sigma_max: fixed-centre band) | bitwise resume ok")
    radial["G2"] = radial_path(21, "G2", "G2 (DoubleModelFitGB, kernel 8)",
                               {"double_model_gb"})

    mock_h, truth_h = mock_fit(device, n_stars=100_000, seed=5, bounded=False)
    h_stats, sufficient = phase_sufficient_kernel(device, mock_h)
    if "--chunk-sweep" in args:
        from mcmc_dynamics_tpu_torch.ops import model_sufficient, model_sufficient_lnlike

        n_bins = h_stats.coeffs.shape[0]
        chunk_sweep(model_sufficient, "model_sufficient",
                    lambda p: model_sufficient_lnlike(h_stats, p),
                    sufficient_inputs(device), ((512,), (16384,)), (2, 4, 8),
                    attr="BIN_GROUP", unit="groups",
                    count=lambda shape: model_sufficient.sufficient_groups(n_bins)[1])
    sufficient_mma = phase_sufficient_mma(device, h_stats, sufficient)
    if "--chunk-sweep" in args:
        mma_sweep(device, h_stats)
    del h_stats
    gb_v2 = phase_v2(24, "constant_gb_v2", constant_gb_v2_lnlike_batched,
                     constant_gb_v2_lnlike_reference, constant_gb_lnlike_batched,
                     constant_inputs(device, gb=True), (big, half), rows_k=7, cols_k=7)
    model_v2 = phase_v2(25, "model_gb_v2", model_gb_v2_lnlike_batched,
                        model_gb_v2_lnlike_reference, model_mixture_gb,
                        model_gb_v2_inputs(device), (big, half), rows_k=8, cols_k=9)
    if "--chunk-sweep" in args:
        for kernel, name, run, inputs in (
                (CONSTANT_GB_V2, "constant_gb_v2", constant_gb_v2_lnlike_batched,
                 constant_inputs(device, gb=True)),
                (MODEL_GB_V2, "model_gb_v2", model_gb_v2_lnlike_batched,
                 model_gb_v2_inputs(device))):
            chunk_sweep(kernel, name, run, inputs, (half, big), (1024, 2048, 4096))
    path_h = drive("H", lambda: phase_table_path(device, mock_h, truth_h, "sufficient"),
                   {"model_sufficient"})
    print(f"phase 26 main path H (binned tier, default unbounded a/r_peak priors): "
          f"{path_h['stars']} stars, {path_h['walkers']} walkers x {path_h['steps']} "
          f"steps | table build {path_h['setup_s']:.2f} s | "
          f"{path_h['s_per_step'] * 1e3:.4f} ms/step | {path_h['evals_per_s']:.4g} "
          f"lnprob evals/s | acceptance {path_h['acceptance']:.3f} | medians "
          f"{json.dumps({k: round(float(v), 4) for k, v in path_h['medians'].items()})} "
          f"(truth v_sys {truth_h['v_sys']}, sigma_max {truth_h['sigma_max']}; JAX "
          f"float64 {H_REFERENCE}) | launches {path_h['launches']}")
    phase_crossover(device)

    nat = phase_native()
    print(f"phase 28 native host library: built | radial bins of the omega Cen "
          f"catalog ({nat['I1 bins']} bins) and path B's mock ({nat['I2 bins']} bins) "
          f"equal NumPy's | native {nat['I1'] * 1e3:.3f} / {nat['I2'] * 1e3:.3f} ms, "
          f"NumPy {nat['I1 numpy'] * 1e3:.3f} / {nat['I2 numpy'] * 1e3:.3f} ms | "
          f"catalog cache round trip ok")
    binned_reference = json.loads(BINNED_REFERENCE.read_text())
    binned = {}
    for phase, path, label in ((29, "I1", "omega Cen catalog"),
                               (30, "I2", "path B's 1e5-star mock")):
        out = binned[path] = drive(path, lambda: phase_binned(
            device, path, binned_reference[path]), set())
        print(f"phase {phase} main path {path} (fit_radial_bins, ConstantFit's "
              f"sufficient tables, {label}): {out['stars']} stars in {out['bins']} "
              f"bins of {out['per_bin'][0]}-{out['per_bin'][1]} stars, "
              f"{out['buckets']} size bucket(s), {BINNED_RUN['n_walkers']} walkers x "
              f"{BINNED_RUN['n_steps']} steps | set-up {out['setup_s']:.4f} s | best "
              f"of 3 {out['wall_s']:.4f} s | {out['ms_per_step']:.4f} ms/step | "
              f"{out['evals_per_s']:.4g} bin x walker lnprob evals/s (set-up "
              f"included) | moves taken {out['acceptance']:.3f} | sigma_max, v_sys "
              f"medians in the JAX bands (worst {out['worst']:.3f} of a half-band)"
              + (" | bucketed chains equal one bucket's bit for bit"
                 if path == "I2" else "") + f" | launches {out['launches']}")
    path_j = drive("J", lambda: phase_convergence(device), {"model_lnlike"})
    print(f"phase 31 main path J (omega Cen recipe, sample_to_convergence, move "
          f"{J_MOVE}, kernel 1): converged after {path_j['steps']} steps (JAX "
          f"float64: {J_JAX_STEPS}; cap {J_MAX_STEPS}) | tau {path_j['tau']} | "
          f"{path_j['seconds']:.2f} s, {path_j['ms_per_step']:.4f} ms/step | "
          f"acceptance {path_j['acceptance']:.3f} | goldens ok after discarding "
          f"{path_j['discard']} "
          f"{json.dumps({k: round(float(v), 4) for k, v in path_j['medians'].items()})}"
          f" | predict_fields 32 x 32 {path_j['predict_s']:.4f} s, finite | "
          f"benchmark_lnprob {json.dumps(path_j['bench'])} | launches "
          f"{path_j['launches']}")

    jam = drive("JAM engine", lambda: phase_jam_engine(device), set())
    for kind in JAM_KINDS:
        c = jam[kind]
        print(f"phase 32 JAM engine on the card ({JAM_MODELS[kind]}, validate set-up, "
              f"{JAM_WALKERS} walkers, {c['finite']} finite): float64 vs JAX float64 "
              f"max |d| direct {c['direct f64']:.3g} grid {c['grid f64']:.3g} | float32 "
              f"vs JAX float64 direct {c['direct f32']:.4g} grid {c['grid f32']:.4g} "
              f"(gate {JAM_F32_TOL}) | float32 grid vs direct {c['grid-direct']:.4g} "
              f"(spread {c['spread']:.4g}) | same -inf pattern")
    print(f"  JAM engine timing (Axisymmetric, free mbh): "
          f"{json.dumps(jam['timing'])} | bound at 512 walkers, grid tier: "
          f"{json.dumps(jam['bound'])} | launches {jam['launches']}")
    k1 = drive("K1", lambda: phase_production_recipe(device), set())
    c = k1["checks"]
    print(f"phase 33 main path K1 (production recipe, cli.run, AnalyticalProfiles, "
          f"{k1['stars']} stars, auto -> grid tier): cli.run {k1['cli_s']:.2f} s "
          f"(sampling, profiles, mass posterior, {k1['bins']} radial bins), mass "
          f"16/50/84 % {[f'{m:.4g}' for m in k1['mass']]} Msun | 64 seeded walkers: "
          f"float64 vs JAX max |d| direct {c['direct f64']:.3g} grid {c['grid f64']:.3g}"
          f" | float32 vs JAX direct {c['direct f32']:.4g} grid {c['grid f32']:.4g} | "
          f"grid vs direct {c['grid-direct']:.4g} (spread {c['spread']:.4g}) | "
          f"{K1_STEPS['n_walkers']} walkers: {k1['ms_per_step']:.4f} ms/step, bitwise "
          f"resume ok | launches {k1['launches']}")
    k2 = drive("K2", lambda: phase_jam_recovery(device), set())
    print(f"phase 34 main path K2 (Axisymmetric, grid tier, {k2['stars']}-star mock "
          f"from the recipe's MGE, free mlr/barq/kappa_x/kappa_y/mbh/delta_v): "
          f"{k2['walkers']} walkers x {k2['steps']} steps | {k2['ms_per_step']:.4f} "
          f"ms/step | acceptance {k2['acceptance']:.3f} | truth {K2_TRUTH} inside every "
          f"0.15-99.85 % interval {json.dumps(k2['intervals'])} | medians "
          f"{json.dumps({k: round(v, 5) for k, v in k2['medians'].items()})} | "
          f"launches {k2['launches']}")

    l1 = drive("L1", lambda: phase_tempered_recipe(device), {"model_lnlike"})
    path_line(35, "L1 (omega_cen_tempered.json without its mesh, n_temps 4, cli.run in "
              "this process, kernel 1 at 64 x 6284)", l1,
              f" | cli.run {l1['cli_s']:.2f} s, kernel 1 {l1['cli_launches']} launches "
              f"(1 + 2 x 500, the ladder alone) | goldens ok | over the timed "
              f"{L1_TIMED_STEPS} steps: log-evidence {l1['log_z']:.4f}, swap "
              f"acceptance per pair {l1['swaps']} | {L1_RESUME[0]} + {L1_RESUME[1]} steps through state= bitwise equal "
              f"{sum(L1_RESUME)} | ms/step over {L1_TIMED_STEPS} steps")
    l2 = drive("L2", lambda: phase_hmc(device), set())
    path_line(36, "L2 (sample_hmc on the omega Cen recipe, generic tier autograd, no "
              "kernel)", l2, f" (warmup {L2_RUN['n_warmup']} + "
              f"{max(L2_RUN['n_warmup'] // 2, 50)} + {L2_RUN['n_steps']}, "
              f"{L2_RUN['n_leapfrog']} leapfrog steps; evals/s counts gradient "
              f"evaluations) | step size {l2['step_size']:.4g} | goldens ok | JAX "
              f"float64 medians {json.dumps({k: round(v, 4) for k, v in l2['jax_medians'].items()})}")
    l3 = drive("L3", lambda: phase_emcee(device), {"model_lnlike"})
    path_line(37, "L3 (emcee_compat.EnsembleSampler, vectorized on the omega Cen "
              "recipe, kernel 1)", l3,
              f" | {L3_RUN[0]} + {L3_RUN[1]} steps through a Backend bitwise equal "
              f"{sum(L3_RUN)} and equal fit(...) | goldens ok | torch.func.vmap "
              f"Gaussian {L3_GAUSS['n_walkers']} x {L3_GAUSS['n_steps']}: "
              f"{l3['gauss_ms']:.4f} ms/step, acceptance {l3['gauss_acceptance']:.3f}, "
              f"|mean|, std, cov errors {[round(e, 4) for e in l3['gauss_errs']]} "
              f"(bounds {L3_TOL}) | scipy log-prob -> numpy path")

    with tempfile.TemporaryDirectory() as mesh_tmp:
        tmp = pathlib.Path(mesh_tmp)
        m1c = phase_mesh_one_rank(device, recipe["chain"], tmp, profiling)
        m1, m2, m3, profiles = phase_mesh_four(device, recipe["chain"], tmp, profiling)
        m1["c"] = m1c
        m4 = phase_mesh_binned(device, binned["I1"]["result"].chains, tmp, profiling)
    for label, run in (("a", m1["a"]), ("b", m1["b"]), ("c", m1["c"])):
        launches["model_lnlike"] += run["launches"]["model_lnlike"]
        if label == "a":
            what = (f"kernel 1 on 1571-star slices, medians in A's goldens, the "
                    f"checkpoint at {M1_N_OUT} steps resumed {M1_RESUME_EXTRA} steps "
                    f"bitwise, final lnP vs the full catalog's kernel 1 max |d| "
                    f"{run['lnp_err']:.4g} | the world of four (M1 a, b, M2, M3) "
                    f"{run['world_s']:.1f} s from spawn to exit")
        else:
            what = "bitwise equal to path A's chain"
        what += f" | {run['wall_s']:.1f} s"
        print(f"phase 38 main path M1 ({label}) (A's recipe on a mesh of {run['ranks']} "
              f"rank(s), {run['mesh']}, {run['backend']}): {run['ms_per_step']:.4f} "
              f"ms/step over {run['steps']} steps | acceptance {run['acceptance']:.3f} | "
              f"every rank's chain identical | {what} | launches {run['launches']}")
    for path, kernel, *_ in M2_CASES:
        run = m2[path]
        for name, count in run["launches"].items():
            launches[name] += count
        timing = (f" | rank 0's slice: kernel {run['ms']:.4f} ms, plain f32 "
                  f"{run['plain_ms']:.4f} ms, bound {run['bound_ms']:.4f} ms "
                  f"({run['bound_by']})" if "ms" in run else "")
        slice_err = (f"slice vs float64 plain max |d| {run['slice_err']:.4g}, "
                     if "slice_err" in run else "")
        print(f"phase 39 main path M2 {path} ({kernel or 'JAM grid, plain torch'}, "
              f"sp {M2_SP}, {m2['backend']}): {run['walkers']} walkers x "
              f"{run['slice_rows']}-row slices | {slice_err}sum of the slices vs the "
              f"full call max |d| {run['sum_err']:.4g} | {run['steps']} sharded steps "
              f"{run['ms_per_step']:.4f} ms/step{timing} | {run['wall_s']:.1f} s with "
              f"its build | launches {run['launches']}")
    launches["model_lnlike"] += m3["launches"]["model_lnlike"]
    print(f"phase 40 main path M3 (omega_cen_tempered.json as written, tp "
          f"{m3['levels']}, cli.run in {m3['levels']} ranks, {m3['backend']}): "
          f"cli.run {m3['cli_s']:.2f} s, kernel 1 1 + 2 x {m3['steps']} launches a rank "
          f"| goldens ok {json.dumps({k: round(float(v), 4) for k, v in m3['medians'].items()})}"
          f" | log-evidence {m3['log_z']:.4f} | swap acceptance per pair over "
          f"{sum(M3_RESUME)} steps {[round(x, 4) for x in m3['swap_acceptance']]}"
          f" | {M3_RESUME[0]} + {M3_RESUME[1]} steps through state= bitwise equal "
          f"{sum(M3_RESUME)} | {m3['ms_per_step']:.4f} ms/step | {m3['wall_s']:.1f} s | "
          f"launches {m3['launches']}")
    print(f"phase 41 main path M4 (path I1 with its {m4['bins']} bins over dp 2, "
          f"{m4['backend']}): {m4['wall_s']:.4f} s set-up included, "
          f"{m4['ms_per_step']:.4f} ms/step | both ranks' chains bitwise equal path I1's "
          f"| the world of two {m4['world_s']:.1f} s from spawn to exit | launches "
          f"{m4['launches']}")
    for line in m1c["profile"] + profiles + (m4.get("profile") or []):
        print(line)

    if profiling:
        fit_a, _ = load_recipe(device)
        fit_c, _ = load_recipe(device, CENTER_RECIPE, "ConstantFit")
        fit_d, _ = freecenter_fit(device)
        for label, fit, n_walkers, names in (
                ("A", fit_a, 64, ["model_lnlike_kernel", "sum_chunks_kernel<1>"]),
                ("B", mock_b, 1024, ["model_tensor_kernel", "sum_chunks_kernel<2>"]),
                ("C", fit_c, 64, []),
                ("D", fit_d, 64, ["model_freecenter_kernel", "sum_chunks_kernel<3>"]),
                ("E1", path_e1["fit"], 256,
                 ["constant_gb_kernel", "sum_chunks_kernel<5>"]),
                ("E2", path_e2["fit"], 256,
                 ["constant_mixture_kernel", "sum_chunks_kernel<4>"]),
                ("F1", radial["F1"]["fit"], 256,
                 ["model_mixture_kernel", "sum_chunks_kernel<6>"]),
                ("F2", radial["F2"]["fit"], 256,
                 ["model_mixture_kernel", "sum_chunks_kernel<6>"]),
                ("G1", path_g1["fit"], 64,
                 ["double_model_kernel", "sum_chunks_kernel<7>"]),
                ("G2", radial["G2"]["fit"], 256,
                 ["double_model_gb_kernel", "sum_chunks_kernel<8>"]),
                ("H", mock_h, 1024, ["model_sufficient_kernel", "finish_kernel"])):
            pos = fit.get_initials(n_walkers)
            fit(n_walkers=n_walkers, n_steps=20, pos=pos, prefix=None)   # warm-up
            profile_path(label, lambda: fit(n_walkers=n_walkers, n_steps=100,
                                            pos=pos, prefix=None), 100, names)
        fit_j = path_j["fit"]
        pos = fit_j.get_initials(64)
        profile_path("J", lambda: fit_j(n_walkers=64, n_steps=100, pos=pos,
                                        move=J_MOVE, prefix=None), 100,
                     ["model_lnlike_kernel", "sum_chunks_kernel<1>"])
        fit_k1 = k1["fit"]
        pos = fit_k1.get_initials(K1_STEPS["n_walkers"])
        fit_k1(n_walkers=K1_STEPS["n_walkers"], n_steps=10, pos=pos, prefix=None)
        profile_path("K1", lambda: fit_k1(n_walkers=K1_STEPS["n_walkers"], n_steps=60,
                                          pos=pos, prefix=None), 60, [])
        fit_k2 = k2["fit"]
        profile_path("K2", lambda: fit_k2(n_walkers=K2_RUN["n_walkers"], n_steps=60,
                                          pos=k2["pos"], prefix=None), 60, [])
        fit_l1, _ = load_recipe(device, TEMPERED_RECIPE)
        pos = fit_l1.get_initials(32)
        l1_kw = dict(n_temps=4, beta_min=0.01, swap_every=5, pos=pos,
                     move=[("stretch", 0.5), ("de", 0.5)])
        fit_l1.sample_tempered(n_steps=20, **l1_kw)
        profile_path("L1", lambda: fit_l1.sample_tempered(n_steps=100, **l1_kw), 100,
                     ["model_lnlike_kernel", "sum_chunks_kernel<1>"])
        profile_path("L2 (no warmup)", lambda: fit_a.sample_hmc(
            **dict(L2_RUN, n_warmup=0, n_steps=20)), 20, [])
        from mcmc_dynamics_tpu_torch.emcee_compat import EnsembleSampler

        pos = fit_a.get_initials(64)
        emcee = EnsembleSampler(64, 6, fit_a.batched_lnprob(), vectorize=True,
                                device=device)
        emcee.run_mcmc(pos, 20)
        profile_path("L3", lambda: emcee.run_mcmc(None, 100), 100,
                     ["model_lnlike_kernel", "sum_chunks_kernel<1>"])
        from mcmc_dynamics_tpu_torch import pipelines

        for path in ("I1", "I2"):
            columns, (ra_c, dec_c) = binned_catalog(path)
            profile_path(path + " (set-up included)",
                         lambda: pipelines.fit_radial_bins(
                             port_reader(columns), ra_c, dec_c, device=device,
                             **BINNED_RUN), BINNED_RUN["n_steps"], [])

    # (name, source, TPU kernel, row at the large shape (16384 walkers; the
    # KDE 20480 targets), rows at the main paths' shapes: (path, row), path
    # None for a kernel no model dispatches)
    def m2_row(path):
        """Rank 0's star slice of path M2 ``path`` as a kernel row."""
        run = m2[path]
        return dict(W=run["walkers"], N=run["slice_rows"], ms=run["ms"],
                    bound_ms=run["bound_ms"], bound_by=run["bound_by"])

    def m2_path(path):
        return (f"M2 {path} (1 of {M2_SP} star slices)", m2_row(path))

    rows = [("model_lnlike", "model_lnlike.cu", "mcmc_dynamics_tpu/ops/lnlike_kernels.py:248", direct[0], [("A", direct[1]), ("L1", direct[2]), ("L3", direct[1]), m2_path("A")]),
            ("model_tensor", "model_tensor.cu", "mcmc_dynamics_tpu/ops/model_tensor.py:487", tensor[0], [("B", tensor[1])]),
            ("model_freecenter", "model_freecenter.cu", "mcmc_dynamics_tpu/ops/lnlike_kernels.py:378", freecenter[0], [("D", freecenter[1]), m2_path("D")]),
            ("constant_mixture", "constant_mixture.cu", "mcmc_dynamics_tpu/ops/lnlike_kernels.py:148", mixture[0], [("E2", mixture[1])]),
            ("constant_gb", "constant_gb.cu", "mcmc_dynamics_tpu/ops/lnlike_kernels.py:699", gb[0], [("E1", gb[1]), m2_path("E1")]),
            ("model_mixture", "model_mixture.cu", "mcmc_dynamics_tpu/ops/lnlike_kernels.py:500", model_mixture[0], [("F1", model_mixture[1]), ("F2", mixture_lnb[1]), m2_path("F1"), m2_path("F2")]),
            ("double_model", "double_model.cu", "mcmc_dynamics_tpu/ops/lnlike_kernels.py:605", double[0], [("G1", double[1]), m2_path("G1")]),
            ("double_model_gb", "double_model_gb.cu", "mcmc_dynamics_tpu/ops/lnlike_kernels.py:807", double_gb[0], [("G2", double_gb[1]), m2_path("G2")]),
            ("model_sufficient", "model_sufficient.cu", "mcmc_dynamics_tpu/ops/model_sufficient.py:422", sufficient[0], [("H", sufficient[1])]),
            ("background_lse", "background_lse.cu", "mcmc_dynamics_tpu/ops/background_kernel.py:89", lse[0], [("E2", lse[0]), ("F2", lse[0])]),
            ("model_sufficient_mma", "model_sufficient_mma.cu", "mcmc_dynamics_tpu/ops/model_sufficient.py:544", sufficient_mma[0], [(None, sufficient_mma[1])]),
            ("constant_gb_v2", "constant_gb_v2.cu", "tools/probe_mixture.py:124", gb_v2[0], [(None, gb_v2[1])]),
            ("model_gb_v2", "model_gb_v2.cu", "tools/probe_mixture.py:231", model_v2[0], [(None, model_v2[1])])]
    kernels = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"mcmc_dynamics_tpu_torch/csrc/{source}", "replaces": replaces,
         "launches": launches[name], "max_abs_err": row["max_abs_err"],
         "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"],
         # no single PyTorch call computes any of these functions: per-pair
         # rsqrt/log/logaddexp reductions, a Chebyshev/Tucker chain, per-bin
         # Chebyshev contractions folded into a quadratic, a log-sum-exp over
         # a matrix another call would have to build first
         "library_ms": None,
         # the same kernel at its main path's shape (``ms`` and ``bound_ms``
         # above are at the large shape)
         "main_path": [{"path": path, "shape": shape_label(prow), "ms": prow["ms"],
                        "bound_ms": prow["bound_ms"], "bound_by": prow["bound_by"]}
                       for path, prow in path_rows]}
        for name, source, replaces, row, path_rows in rows]}
    loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                    or m == "mcmc_dynamics_tpu" or m.startswith("mcmc_dynamics_tpu."))
    if loaded:
        raise AssertionError(f"the port imported JAX or the JAX package: {loaded}")
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
