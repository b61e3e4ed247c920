#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``mcmc_dynamics_tpu_torch/csrc``,
checks each against its plain torch version at the shapes the main path gives
it, then samples the fixed-centre ModelFit end to end through both likelihood
tiers, and fails (non-zero exit) if any phase does:

1. environment: torch, CUDA, the card, ``nvidia-smi``, ``nvcc`` and the build;
2. kernel 1 (direct walker x star likelihood) against its float64 plain
   version at 16384 walkers x 1e4 stars and at 32 walkers x 6284 stars;
3. kernel 2 (tensor-Chebyshev tables) against its float64 plain version at
   16384 walkers on the tables of a 1e5-star mock catalog;
4. main path A, the omega Cen fixed-centre recipe (``example/``): 64 walkers x
   600 steps through kernel 1, goldens, profiles, and a bitwise resume;
5. main path B, the tensor tier: 1e5-star mock, 1024 walkers x 200 steps
   through kernel 2, recovery of the truth.

Each phase prints one line of numbers.  Before the last line come the card's
name and power limit (``nvidia-smi``) and one JSON object with every kernel's
route, source, launch count on the main path, error and times; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import json
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
GOLDENS = REPO / "example" / "goldens" / "omega_cen_goldens.json"

# the reference's validate-gate tolerances (bench.py: direct kernel, table tier)
DIRECT_TOL = dict(rtol=2e-4, atol=5e-2)
TENSOR_TOL = dict(rtol=2e-4, atol=0.5)
CANONICAL = ["v_sys", "sigma_max", "a", "v_maxx", "v_maxy", "r_peak"]


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


def direct_inputs(n_walkers, n_stars, n_pad, seed, device):
    """Random params and a star table with a masked zero padding tail; walker
    0 has sigma_max = 0 and walker 1 has a = 0 (prior-legal boundaries)."""
    import torch

    rng = np.random.default_rng(seed)
    params = np.column_stack([
        rng.uniform(-5, 5, n_walkers), rng.uniform(5, 30, n_walkers),
        rng.uniform(0.5, 10, n_walkers), rng.uniform(-10, 10, n_walkers),
        rng.uniform(-10, 10, n_walkers), rng.uniform(0.5, 10, n_walkers)])
    params[0, 1] = 0.0
    params[1, 2] = 0.0
    n = n_stars + n_pad
    dxm, dym = np.zeros(n), np.zeros(n)
    dxm[:n_stars], dym[:n_stars] = rng.normal(0, 3, (2, n_stars))
    v, verr2, mask = np.zeros(n), np.zeros(n), np.zeros(n)
    v[:n_stars] = 10 * rng.normal(size=n_stars)
    verr2[:n_stars] = rng.uniform(0.5, 2.0, n_stars) ** 2
    mask[:n_stars] = 1.0
    cols = (dxm, dym, dxm * dxm + dym * dym, v, verr2, mask)

    def on(dtype):
        return [torch.as_tensor(a, dtype=dtype, device=device)
                for a in (params,) + cols]
    return on


def phase_direct_kernel(device, shapes=((16384, 10_000, 240), (32, 6284, 116))):
    """Kernel 1 against its plain version at (walkers, stars, padding) shapes:
    the reference's canonical 16384 x 1e4 and the recipe's half-ensemble."""
    import torch

    from mcmc_dynamics_tpu_torch.ops import (model_lnlike_batched,
                                             model_lnlike_reference)

    rows = []
    for n_walkers, n_stars, n_pad in shapes:
        on = direct_inputs(n_walkers, n_stars, n_pad, seed=n_walkers, device=device)
        a32, a64 = on(torch.float32), on(torch.float64)
        got = model_lnlike_batched(*a32)
        torch.cuda.synchronize()
        ref = torch.cat([model_lnlike_reference(p, *a64[1:])
                         for p in torch.split(a64[0], 2048)])
        err = compare(f"model_lnlike W={n_walkers}", got, ref, **DIRECT_TOL)
        ms = cuda_ms(lambda: model_lnlike_batched(*a32))
        plain_ms = cuda_ms(lambda: model_lnlike_reference(*a32), reps=10)
        n = n_stars + n_pad
        print(f"phase 2 kernel model_lnlike W={n_walkers} N={n} "
              f"(masked tail {n_pad}): max_abs_err {err:.4g} vs float64 plain "
              f"(rtol {DIRECT_TOL['rtol']}, atol {DIRECT_TOL['atol']}) | kernel "
              f"{ms:.4f} ms | plain f32 {plain_ms:.4f} ms")
        rows.append(dict(W=n_walkers, N=n, max_abs_err=err, ms=ms, plain_ms=plain_ms))
    return rows


def mock_tensor_fit(device, n_stars, seed):
    """ModelFit on a mock catalog with finite a/r_peak priors enclosing the
    truth (the tensor tier's box) and near-truth initials."""
    from mcmc_dynamics_tpu_torch import make_mock_cluster
    from mcmc_dynamics_tpu_torch.models import ModelFit

    data, truth = make_mock_cluster(n_stars=n_stars, sigma_max=12.0, v_max=6.0,
                                    theta_0=0.8, r_peak=60.0, a=30.0, seed=seed)
    params = ModelFit.default_parameters()
    params["ra_center"].set(value=truth["ra_center"], fixed=True)
    params["dec_center"].set(value=truth["dec_center"], fixed=True)
    params["v_sys"].set(min=-20.0, max=20.0, initials="rng.normal(0, 0.5, size=n)")
    params["sigma_max"].set(max=60.0, initials="rng.uniform(10.8, 13.2, size=n)")
    params["v_maxx"].set(min=-30.0, max=30.0,
                         initials="rng.normal(loc=0, scale=2, size=n)")
    params["v_maxy"].set(min=-30.0, max=30.0,
                         initials="rng.normal(loc=0, scale=2, size=n)")
    params["a"].set(min=10.0, max=1000.0, initials="rng.uniform(24, 36, size=n)")
    params["r_peak"].set(min=10.0, max=1000.0, initials="rng.uniform(48, 72, size=n)")
    return ModelFit(data, parameters=params, seed=seed, device=device), truth


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


def phase_tensor_kernel(device, fit, n_walkers=16384):
    import torch

    from mcmc_dynamics_tpu_torch.ops import (model_lnlike_reference,
                                             model_tensor_lnlike)

    t0 = time.perf_counter()
    stats = fit.tensor_stats()
    build_s = time.perf_counter() - t0
    stats64 = stats.to(dtype=torch.float64)
    params = box_params(stats, n_walkers, seed=7, device=device, dtype=fit.dtype)
    got = model_tensor_lnlike(stats, params)
    torch.cuda.synchronize()
    ref = torch.cat([stats64.lnlike(p) for p in torch.split(params.double(), 4096)])
    err = compare(f"model_tensor W={n_walkers}", got, ref, **TENSOR_TOL)
    ms = cuda_ms(lambda: model_tensor_lnlike(stats, params))
    plain_ms = cuda_ms(lambda: stats.lnlike(params), reps=10)

    # the tables against the exact star sum (float64 direct plain version)
    dx, dy = fit.fixed_center_offsets()
    dx, dy = dx * (10800.0 / math.pi), dy * (10800.0 / math.pi)
    cols = [torch.as_tensor(c, dtype=torch.float64, device=device) for c in
            (dx, dy, dx * dx + dy * dy, fit.data.data.value("v", "km/s"),
             fit.data.data.value("verr", "km/s") ** 2, np.ones_like(dx))]
    probe = params[:256].double()
    exact = torch.cat([model_lnlike_reference(p, *cols) for p in torch.split(probe, 32)])
    tab_err = compare("tensor tables vs exact star sum", stats64.lnlike(probe),
                      exact, **TENSOR_TOL)
    print(f"phase 3 kernel model_tensor W={n_walkers} N={fit.n_data} table "
          f"{tuple(stats.table.shape)} ranks {tuple(stats.u_s.shape)}x"
          f"{tuple(stats.u_a.shape)} Dr {stats.n_r} (host build {build_s:.2f} s): "
          f"max_abs_err {err:.4g} vs float64 plain (rtol {TENSOR_TOL['rtol']}, "
          f"atol {TENSOR_TOL['atol']}) | tables vs exact star sum {tab_err:.4g} "
          f"| kernel {ms:.4f} ms | plain f32 {plain_ms:.4f} ms")
    return dict(W=n_walkers, max_abs_err=err, ms=ms, plain_ms=plain_ms)


def load_recipe(device):
    """The fixed-centre omega Cen recipe as ``cli/run.py`` sets it up: the
    bundled catalog (v_sys subtracted) and the config's parameter specs."""
    from mcmc_dynamics_tpu_torch import DataReader, units as u
    from mcmc_dynamics_tpu_torch.models import ModelFit

    cfg = json.loads(RECIPE.read_text())
    path = REPO / cfg["data"]["file"]
    header = path.read_text().splitlines()[0].split(",")
    table = np.loadtxt(path, delimiter=",", skiprows=1)
    col = {name: table[:, i] for i, name in enumerate(header)}
    v_sys = float(cfg["data"].get("v_sys") or 0.0)
    data = DataReader({"ra": u.Quantity(col["ra"], "deg"),
                       "dec": u.Quantity(col["dec"], "deg"),
                       "v": u.Quantity(col["v"] - v_sys, "km/s"),
                       "verr": u.Quantity(col["verr"], "km/s")})
    params = ModelFit.default_parameters()
    for name, spec in cfg["parameters"].items():
        params[name].set(**spec)
    sampling = cfg["sampling"]
    fit = ModelFit(data, parameters=params, seed=sampling["seed"], device=device)
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


def phase_recipe(device, n_steps=None, n_extra=50):
    """Main path A; returns (numbers, fit)."""
    import torch

    fit, sampling = load_recipe(device)
    if fit.lnprob_tier() != "direct":
        raise AssertionError(f"recipe tier {fit.lnprob_tier()}, expected direct")
    n_walkers = sampling["n_walkers"]
    n_steps = n_steps or sampling["n_steps"]
    n_out, n_burn = sampling["n_out"], sampling["n_burn"]
    pos = fit.get_initials(n_walkers)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = str(pathlib.Path(tmp) / "omega_cen_fixed")
        run = fit(n_walkers=n_walkers, n_steps=n_steps, n_out=n_out, pos=pos,
                  prefix=prefix)
        state = fit.load_state(prefix + "_chain.npz")
        resumed = fit(state=state, n_steps=n_extra, prefix=None)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole = fit(n_walkers=n_walkers, n_steps=n_steps + n_extra, pos=pos, prefix=None)
    whole_s = time.perf_counter() - t0
    if not (np.array_equal(whole.chain[:, :n_steps], run.chain)
            and np.array_equal(whole.chain[:, n_steps:], resumed.chain)
            and np.array_equal(whole.lnprobability[:, n_steps:],
                               resumed.lnprobability)):
        raise AssertionError("checkpoint resume is not bitwise equal to the "
                             "uninterrupted run")

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
                s_per_step=whole_s / (n_steps + n_extra),
                acceptance=acc, medians=values)


def phase_tensor_path(device, fit, truth, n_walkers=1024, n_steps=200):
    """Main path B; returns its numbers."""
    import torch

    if fit.lnprob_tier() != "tensor":
        raise AssertionError(f"tier {fit.lnprob_tier()}, expected tensor")
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


# ----------------------------------------------------------------------------- main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU.", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False

    from mcmc_dynamics_tpu_torch.ops import MODEL_LNLIKE, MODEL_TENSOR

    smi = phase_environment()
    direct = phase_direct_kernel(device)
    mock_fit, truth = mock_tensor_fit(device, n_stars=100_000, seed=5)
    tensor = phase_tensor_kernel(device, mock_fit)

    # the main path: counts from here on are its launches only
    MODEL_LNLIKE.launches = 0
    MODEL_TENSOR.launches = 0
    recipe = phase_recipe(device)
    l1_a, l2_a = MODEL_LNLIKE.launches, MODEL_TENSOR.launches
    if l1_a == 0 or l2_a != 0:
        raise AssertionError(f"path A launches: kernel 1 {l1_a}, kernel 2 {l2_a}")
    print(f"phase 4 main path A (omega Cen recipe, direct tier): "
          f"{recipe['stars']} stars, {recipe['walkers']} walkers x "
          f"{recipe['steps']} steps | {recipe['s_per_step'] * 1e3:.4f} ms/step "
          f"(650-step run) | acceptance {recipe['acceptance']:.3f} | goldens ok "
          f"{json.dumps({k: round(float(v), 4) for k, v in recipe['medians'].items()})}"
          f" | bitwise resume ok | launches kernel 1 {l1_a}, kernel 2 {l2_a}")
    path_b = phase_tensor_path(device, mock_fit, truth)
    l1_b, l2_b = MODEL_LNLIKE.launches - l1_a, MODEL_TENSOR.launches - l2_a
    if l2_b == 0 or l1_b != 0:
        raise AssertionError(f"path B launches: kernel 1 {l1_b}, kernel 2 {l2_b}")
    print(f"phase 5 main path B (tensor tier): {path_b['stars']} stars, "
          f"{path_b['walkers']} walkers x {path_b['steps']} steps | table "
          f"build {path_b['setup_s']:.2f} s | {path_b['s_per_step'] * 1e3:.4f} "
          f"ms/step | "
          f"{path_b['evals_per_s']:.4g} lnprob evals/s | acceptance "
          f"{path_b['acceptance']:.3f} | medians v_sys "
          f"{path_b['medians']['v_sys']:.4f} sigma_max "
          f"{path_b['medians']['sigma_max']:.4f} (truth {truth['v_sys']}, "
          f"{truth['sigma_max']}) | launches kernel 1 {l1_b}, kernel 2 {l2_b}")

    big = direct[0]
    kernels = {"kernels": [
        {"name": "model_lnlike", "route": "cuda",
         "source": "mcmc_dynamics_tpu_torch/csrc/model_lnlike.cu",
         "replaces": "mcmc_dynamics_tpu/ops/lnlike_kernels.py:248",
         "launches": MODEL_LNLIKE.launches, "max_abs_err": big["max_abs_err"],
         "ms": big["ms"], "plain_ms": big["plain_ms"]},
        {"name": "model_tensor", "route": "cuda",
         "source": "mcmc_dynamics_tpu_torch/csrc/model_tensor.cu",
         "replaces": "mcmc_dynamics_tpu/ops/model_tensor.py:487",
         "launches": MODEL_TENSOR.launches, "max_abs_err": tensor["max_abs_err"],
         "ms": tensor["ms"], "plain_ms": tensor["plain_ms"]},
    ]}
    if "jax" in sys.modules:
        raise AssertionError("the port imported JAX")
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
