"""The benchmark's harness: one run of one cell.

A run loads the cell's files by name (``workloads/<cell>.json``, the
configuration's ``configs/<config>.json`` and ``.py``, the catalog maker
``catalogs/<maker>.py`` and the plain reference ``reference/<config>.py``),
makes the catalog and every fit's initial walkers from the seed, builds the
program's fit, warms up the cell's own shapes, and then runs the window:
back-to-back fits through ``Runner.__call__`` until the window's seconds have
passed.  A checkpointing cell's window ends at the end of the chunk in
progress (the fit's chain is then read from its checkpoint); the others' at
the end of the fit in progress.  A traced run then measures the per-layer
metrics.  Last, with the program's state freed, the reference judges what
the window produced (``check.py``).

The metrics are read by small readers, ``metrics/<metric>.py``, from the
``run`` record this module fills; ``BENCHMARK.json`` says which metrics a
cell reports.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may load (compared whole)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "mcmc_dynamics_tpu")
# the benchmark's span around each of the program's batched lnprob calls
TIER_SPAN = "perfbench.tier_lnprob"
# fit indices of the warm-up and of the traced run's two sub-windows (the
# window's fits count from 0)
WARM_FIT, SUB_FIT, TRACED_FIT = 1 << 20, (1 << 20) + 1, (1 << 20) + 2


def load_json(path):
    return json.loads(pathlib.Path(path).read_text())


def load_module(path):
    """A file under this directory as a module of the ``perfbench`` package
    (so that its relative imports resolve), found by path: names may hold
    dots and dashes."""
    path = pathlib.Path(path).resolve()
    rel = path.relative_to(HERE).with_suffix("")
    name = "perfbench." + ".".join(
        "".join(c if c.isalnum() or c == "_" else "_" for c in part)
        for part in rel.parts)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def seed_int(seed, *path) -> int:
    """A 63-bit integer drawn from ``seed`` (any whole number) and a path of
    small integers naming what it seeds."""
    seq = np.random.SeedSequence([abs(int(seed)), int(seed < 0), *path])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Cell:
    """A cell's files, found by its name."""

    def __init__(self, name, overrides=None):
        self.name = name
        self.spec = load_json(HERE / "workloads" / f"{name}.json")
        self.config = load_json(HERE / "configs" / f"{self.spec['config']}.json")
        for key, value in (overrides or {}).items():
            target = self.config if key == "config" else self.spec
            _merge(target, value if key == "config" else {key: value})
        self.builder = load_module(HERE / "configs" / f"{self.spec['config']}.py")
        self.reference = load_module(HERE / "reference" / f"{self.spec['config']}.py")
        self.maker = load_module(HERE / "catalogs" / f"{self.spec['catalog']['maker']}.py")
        self.n_walkers = int(self.spec["walkers"])
        self.checkpoint = bool(self.spec["fit"]["checkpoint"])

    def initials(self, seed, index):
        """(walkers, fit seed) of fit ``index``: each free parameter's column
        drawn by its ``initials`` entry, ``[numpy Generator method, *args]``."""
        rng = np.random.default_rng(seed_int(seed, 1, index))
        cols = []
        for name in self.config["free"]:
            method, *args = self.spec["initials"][name]
            cols.append(getattr(rng, method)(*args, size=self.n_walkers))
        return np.column_stack(cols), seed_int(seed, 2, index)


def _merge(target, update):
    for key, value in update.items():
        if isinstance(value, dict) and isinstance(target.get(key), dict):
            _merge(target[key], value)
        else:
            target[key] = value


def bench_metrics(cell_name, kind):
    """The metrics of ``BENCHMARK.json``'s ``kind`` list that the cell reports."""
    bench = load_json(ROOT / "BENCHMARK.json")
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


class WindowClosed(Exception):
    """Raised as a chunk would start after the window's time is up."""


class Deadline:
    """``Runner.__call__``'s telemetry hook, checked as each chunk starts:
    once the window's time is up it raises :class:`WindowClosed`, so the
    window ends at the end of the chunk before (whose checkpoint is written)."""

    def __init__(self, t_end):
        self.t_end = t_end
        self.n_walkers = 0

    @contextlib.contextmanager
    def chunk(self, n_steps):
        del n_steps
        if time.perf_counter() >= self.t_end:
            raise WindowClosed
        yield


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_fit(fit, cell, seed, index, tmp, telemetry=None, fit_spec=None):
    """One fit of the cell through ``Runner.__call__``; returns its record:
    the initial walkers, the fit's seed, the chain and lnprob it produced
    (from the checkpoint where the window closed it), whether it completed,
    and the error where it raised."""
    spec = fit_spec or cell.spec["fit"]
    pos, fit_seed = cell.initials(seed, index)
    prefix = str(pathlib.Path(tmp) / f"fit{index}") if cell.checkpoint else None
    rec = dict(index=index, pos=pos, seed=fit_seed, prefix=prefix, chain=None,
               lnprob=None, completed=False, error=None, n_steps=int(spec["n_steps"]),
               t0=time.perf_counter())
    try:
        res = fit(n_walkers=cell.n_walkers, n_steps=int(spec["n_steps"]),
                  n_out=spec.get("n_out"), pos=pos, a=float(cell.spec["a"]),
                  move=cell.spec["move"], seed=fit_seed, prefix=prefix,
                  telemetry=telemetry)
        rec.update(chain=res.chain, lnprob=res.lnprobability, completed=True)
    except WindowClosed:
        path = pathlib.Path(f"{prefix}_chain.npz")
        if path.exists():
            with np.load(path) as f:
                rec.update(chain=np.asarray(f["chain"]), lnprob=np.asarray(f["lnprob"]))
    except Exception as err:  # a fit that raised: every step of it failed
        traceback.print_exc(file=sys.stderr)
        rec["error"] = repr(err)
    rec["t1"] = time.perf_counter()
    return rec


def steps_of(rec):
    return 0 if rec["chain"] is None else int(rec["chain"].shape[1])


def timed_fit(fit, cell, seed, index, tmp, fit_spec, device):
    """A fit between two synchronisations: (record, seconds)."""
    _sync(device)
    t0 = time.perf_counter()
    rec = run_fit(fit, cell, seed, index, tmp, fit_spec=fit_spec)
    _sync(device)
    return rec, time.perf_counter() - t0


def power_limit():
    """The card's name and power limit as nvidia-smi prints them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def run_cell(cell, seed, seconds, trace=False, device="cuda", control=None,
             prepare=None, t_start=None):
    """One run of ``cell``; returns the result record (``result`` is the
    last line's object).  ``control``: ``"bf16"`` puts the reference, computed
    in bfloat16, in the program's lnprob's place; ``"tf32"`` lets the
    program's float32 products run in TF32.  ``prepare(fit)`` may replace
    parts of the fit (the tests plant faults with it)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    on_card = device.type == "cuda"
    run = dict(cell=cell, seed=seed, seconds=seconds, device=device)
    tmp_dir = tempfile.TemporaryDirectory(prefix="perfbench-")
    tmp = tmp_dir.name
    try:
        # ------------------------------------------------------------ set-up
        if on_card:
            from mcmc_dynamics_tpu_torch.ops._build import build_library
            t0 = time.perf_counter()
            build_library()
            run["build_s"] = time.perf_counter() - t0
            torch.backends.cuda.matmul.allow_tf32 = control == "tf32"
            torch.backends.cudnn.allow_tf32 = control == "tf32"
        catalog = cell.maker.make(cell.spec["catalog"], seed_int(seed, 0), cell.config,
                                  device)
        fit = cell.builder.build(cell.config, catalog, device, seed_int(seed, 3))
        if list(fit.fitted_parameters) != list(cell.config["free"]):
            raise ValueError(f"the fit's free parameters {fit.fitted_parameters} are "
                             f"not the configuration's {cell.config['free']}")
        t0 = time.perf_counter()
        fit.batched_lnprob()
        _sync(device)
        run["tier_s"] = time.perf_counter() - t0
        if control == "bf16":
            ref16 = cell.reference.Reference(cell.config, catalog, device,
                                             dtype=torch.bfloat16)
            fit.batched_lnprob = lambda: (lambda thetas: ref16(thetas).to(thetas.dtype))
        if prepare is not None:
            prepare(fit)
        run_fit(fit, cell, seed, WARM_FIT, tmp, fit_spec=cell.spec["warmup"])
        _sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()

        # ------------------------------------------------------------ window
        t_window = time.perf_counter()
        run["setup_s"] = t_window - t_start
        deadline = t_window + seconds
        fits = []
        while time.perf_counter() < deadline:
            fits.append(run_fit(fit, cell, seed, len(fits), tmp,
                                Deadline(deadline) if cell.checkpoint else None))
            if fits[-1]["error"] is None and not fits[-1]["completed"]:
                break
        _sync(device)
        run["window_s"] = time.perf_counter() - t_window
        run["steps"] = sum(steps_of(r) for r in fits)
        run["fits"] = fits
        run["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated())
                                    if on_card else 0)

        # ------------------------------------------------- traced sub-window
        t0 = time.perf_counter()
        if trace:
            measure_layers(run, fit, cell, seed, tmp, device)
            # the work of one lnprob, counted from the model's shapes
            shape = cell.builder.shape(cell.config, catalog, device)
            run["work_half"] = cell.builder.work(cell.config, shape, cell.n_walkers // 2)
            run["work_step"] = cell.builder.work(cell.config, shape, cell.n_walkers)
        run["layers_s"] = time.perf_counter() - t0

        # ------------------------------------------------------------ judge
        del fit
        if on_card:
            torch.cuda.empty_cache()
        from . import check
        if on_card:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        ref = cell.reference.Reference(cell.config, catalog, device)
        run["checks"] = check.judge(cell, ref, fits, seed, device,
                                    dtype=torch.float32 if on_card else torch.float64)
        run["check_s"] = time.perf_counter() - t0
    finally:
        tmp_dir.cleanup()
    run["result"] = result_line(run, trace)
    return run


def measure_layers(run, fit, cell, seed, tmp, device):
    """The traced run's measurements: an untraced sub-window and the same
    under the profiler, with a span around each batched lnprob call (the
    trace's reduction gives each call's device time), and the checkpoint
    write's host time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import chrome_trace

    sub = cell.spec["trace_fit"]
    rec, seconds = timed_fit(fit, cell, seed, SUB_FIT, tmp, sub, device)
    run["sub_steps"] = steps_of(rec)
    run["sub_s"] = seconds

    inner = fit.batched_lnprob
    replaced = "batched_lnprob" in vars(fit)     # a control's lnprob

    def spanned():
        fn = inner()

        def call(thetas):
            with record_function(TIER_SPAN):
                return fn(thetas)
        return call

    fit.batched_lnprob = spanned
    try:
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with warnings.catch_warnings():
            # the profiler's note that it keeps only the last cycle's events
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=activities) as prof, record_function("perfbench.fit"):
                rec, traced_s = timed_fit(fit, cell, seed, TRACED_FIT, tmp, sub, device)
    finally:
        if replaced:
            fit.batched_lnprob = inner
        else:
            del fit.batched_lnprob
    path = pathlib.Path(tmp) / "trace.json"
    prof.export_chrome_trace(str(path))
    run["trace"] = chrome_trace.reduce(path, steps_of(rec))
    run["trace"]["window_s"] = traced_s
    path.unlink()

    last = next((r for r in reversed(run["fits"]) if r["chain"] is not None), None)
    if cell.checkpoint and last is not None:
        state = fit.load_state(f"{last['prefix']}_chain.npz")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fit.save_current_status_arrays(last["chain"], last["lnprob"], state,
                                           prefix=str(pathlib.Path(tmp) / "ckpt"))
            times.append(time.perf_counter() - t0)
        run["ckpt_ms"] = statistics.median(times) * 1e3


def read_metrics(run, metrics):
    """{name: {value, unit}} from each metric's reader; a reader that finds
    nothing to read returns None, and the metric is left out."""
    out = {}
    for m in metrics:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _finite(x):
    """A number the result's JSON can hold: an infinite one as 1e300."""
    x = float(x)
    return x if math.isfinite(x) else math.copysign(1e300, x)


def result_line(run, trace):
    """The run's last line, as the benchmark's contract lays it out."""
    import torch

    cell = run["cell"]
    kind = "per_layer" if trace else "end_to_end"
    attempted = failed = 0
    for rec in run["fits"]:
        if rec["error"] is not None:
            failed += cell.n_walkers * rec["n_steps"]
            attempted += cell.n_walkers * rec["n_steps"]
            continue
        if rec["chain"] is None:
            continue
        chain, lnp = rec["chain"], rec["lnprob"]
        attempted += chain.shape[0] * chain.shape[1]
        bad = (~np.all(np.isfinite(chain), axis=-1)) | np.isnan(lnp) | (lnp == np.inf)
        failed += int(bad.sum())
    checks = run["checks"]
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    on_card = run["device"].type == "cuda"
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": 1, "memory_peak_bytes": run["memory_peak_bytes"]}
    if on_card:
        device["power"] = power_limit()
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": read_metrics(run, bench_metrics(cell.name, kind)), "device": device}
    if trace and "trace" in run:
        device["busy_s"] = run["trace"]["busy_s"]
        device["window_s"] = run["trace"]["window_s"]
        out["breakdown"] = {"device_ops": run["trace"]["device_ops"],
                            "idle_gaps": run["trace"]["idle_gaps"]}
    # where a run's time went (not a metric)
    out["timings"] = {k: run[k] for k in ("setup_s", "window_s", "layers_s", "check_s")}
    out["timings"]["fit_ms_per_step"] = [
        round((r["t1"] - r["t0"]) * 1e3 / steps_of(r), 4) for r in run["fits"][:64]
        if steps_of(r)]
    out["checks"] = {name: {"value": _finite(c["value"]), "limit": c["limit"]}
                     for name, c in checks.items()}
    return out


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN_MODULES))


def main(args, t_start):
    """The command's run: 0 with the result printed, 2 without a card (or
    with too few), 3 when a forbidden module was loaded."""
    import torch

    cell = Cell(args.workload)
    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if args.readings:
        return readings(cell, args)
    run = run_cell(cell, args.seed, args.seconds, trace=bool(args.trace),
                   device="cuda", control=args.control, t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    result = run["result"]
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


def readings(cell, args):
    """The compared numbers of ``args.readings`` seeds from ``args.seed`` on,
    one line each, in one process (the limits' readings)."""
    for k in range(args.readings):
        seed = args.seed + k
        run = run_cell(cell, seed, args.seconds, device="cuda", control=args.control)
        result = run["result"]
        print(json.dumps({"seed": seed, "control": args.control,
                          "correct": result["correct"], "failed": result["failed"],
                          "steps": run["steps"], "window_s": run["window_s"],
                          "setup_s": run["setup_s"],
                          "checks": {n: c["value"] for n, c in result["checks"].items()}}),
              flush=True)
    return 3 if forbidden_modules() else 0
