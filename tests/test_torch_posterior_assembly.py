"""The contract of the port's one posterior assembly (``Runner._with_prior``),
on every batched tier the CPU reaches, in float64 and float32.

Each case holds three things:

(a) the log-posterior is -inf exactly where the prior (with the model's
    joint prior) is not finite or the tier's range guard fails, finite
    elsewhere, and never NaN.  The walkers are the tier's initials and, out
    of the prior, one a bound beyond, one with a NaN column (a NaN
    likelihood) and one 1e200 beyond a bound (a -inf or NaN likelihood);
    where ``sigma_max`` is sampled, one at 3000 km/s (inside its unbounded
    prior, outside the table tiers' range);
(b) the values are bitwise the same at walker chunks of 1, 3 and W: the
    tier's own chunk where it has one (generic, JAM, their partials), else
    the batch evaluated a chunk at a time.  The two table tiers whose plain
    versions contract through BLAS (tensor, ModelFit's sufficient) are batch
    invariant only to rounding on the CPU, so their finite values are held
    to 100 ulp there, their -inf pattern exactly;
(c) the joint prior receives (W,) values, the flat walker batch of the call
    (B x W' for the binned pipeline's buckets).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import mcmc_dynamics_tpu_torch.background as background
import mcmc_dynamics_tpu_torch.models as models
import mcmc_dynamics_tpu_torch.models.base as base
import mcmc_dynamics_tpu_torch.pipelines as pipelines
from mcmc_dynamics_tpu_torch import DataReader, units as u
from mcmc_dynamics_tpu_torch.models.base import Runner
from mcmc_dynamics_tpu_torch.ops.sufficient import chebyshev_degree
from mcmc_dynamics_tpu_torch.parallel import sharded

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

torch.set_num_threads(1)

RA_C, DEC_C = 56.345, -26.675
SMALL_ENGINE = {"n_u": 8, "n_zeta": 8, "grid_orders": [16, 4], "grid_min_stars": 100}
JAM_CELLS = {"jam": "jam_axisymmetric_bh.mock16k_w64",
             "chemo": "jam_chemo_3pop.mock1e5_w128"}

# case -> (model class, its tier, MCMC_TPU_LNPROB, free centre, background)
MODELS = {
    "generic": ("ConstantFit", "generic", None, True, None),
    "generic_joint_prior": ("DoubleModelFitGB", "generic", None, True, None),
    "direct": ("ModelFit", "direct", None, False, None),
    "freecenter": ("ModelFit", "freecenter", None, True, None),
    "tensor": ("ModelFit", "tensor", "tensor", False, None),
    "sufficient": ("ModelFit", "sufficient", "sufficient", False, None),
    "constant_sufficient": ("ConstantFit", "sufficient", None, False, None),
    "mixture": ("ConstantFit", "mixture", None, False, "pmember"),
    "gb": ("ConstantFitGB", "gb", None, False, None),
    "model_mixture": ("ModelFitGB", "model_mixture", None, False, None),
    "model_mixture_fixed": ("ModelFitConstantBackground", "model_mixture", None, False,
                            "fixed"),
    "double": ("DoubleModelFit", "double", None, False, None),
    "double_gb": ("DoubleModelFitGB", "double_gb", None, False, None),
}
# tiers whose plain likelihood goes through BLAS contractions
ROUNDING_ONLY = {"tensor", "sufficient"}
CASES = (list(MODELS)
         + ["jam_direct", "jam_grid", "chemo_direct", "chemo_grid",
            "sharded_direct", "sharded_generic", "sharded_jam_grid",
            "pipeline_sufficient", "pipeline_generic", "build_lnprob"])


def _columns(n, seed=15):
    rng = np.random.default_rng(seed)
    return {"ra": (RA_C + 0.03 * rng.normal(size=n), "deg"),
            "dec": (DEC_C + 0.03 * rng.normal(size=n), "deg"),
            "v": (5.0 * rng.normal(size=n), "km/s"),
            "verr": (0.5 + 0.5 * rng.random(n), "km/s"),
            "density": (10.0 ** rng.uniform(-1, 2, n), None),
            "pmember": (rng.uniform(0.05, 0.95, n), None)}


def _parameters(cls, free_centre):
    """``cls``'s default parameters with initials inside every prior."""
    p = cls.default_parameters()
    for coord, value in (("ra_center", RA_C), ("dec_center", DEC_C)):
        p[coord].set(value=value, fixed=not free_centre)
        if free_centre:
            p[coord].set(min=value - 0.02, max=value + 0.02,
                         initials=f"rng.uniform({value - 0.002}, {value + 0.002}, size=n)")
    if "a" in p:
        p["a"].set(min=1.0, max=600.0, initials="rng.uniform(30, 300, size=n)")
        p["r_peak"].set(min=1.0, max=600.0, initials="rng.uniform(30, 300, size=n)")
    if "r_peak_c" in p:
        p["r_peak_c"].set(initials="rng.uniform(5, 30, size=n)")
    if "f_back" in p:
        p["f_back"].set(max=1.0, initials="rng.uniform(0.2, 0.9, size=n)")
    if "sigma_back" in p:
        p["sigma_back"].set(initials="rng.uniform(10, 40, size=n)")
    return p


def _model(case, dtype, monkeypatch, n_stars=160):
    """``MODELS[case]``'s fit, in its tier, on the CPU in ``dtype``."""
    name, tier, mode, free_centre, bg = MODELS[case]
    if mode is None:
        monkeypatch.delenv("MCMC_TPU_LNPROB", raising=False)
    else:
        monkeypatch.setenv("MCMC_TPU_LNPROB", mode)
    cls = getattr(models, name)
    p = _parameters(cls, free_centre)
    cols = _columns(n_stars)
    kw = {}
    if bg == "fixed":
        p["v_back"].set(value=0.0, fixed=True)
        p["sigma_back"].set(value=50.0, fixed=True)
    if bg is not None:
        kw["background"] = background.Gaussian(20.0, 60.0)
    if bg != "pmember":
        del cols["pmember"]
    if name in ("ModelFit", "ConstantFit", "DoubleModelFit"):
        del cols["density"]
    reader = DataReader({k: (u.Quantity(v, unit) if unit else v)
                         for k, (v, unit) in cols.items()})
    fit = cls(reader, parameters=p, seed=3, device="cpu", dtype=dtype, **kw)
    assert fit.lnprob_tier() == tier
    return fit


def _jam(kind, n_stars, dtype, monkeypatch):
    """The benchmark's JAM (or chemo) configuration at small orders on a
    ``n_stars`` mock, and 8 of its cell's initial walkers."""
    cell = harness.Cell(JAM_CELLS[kind], overrides={"catalog": {"n_stars": n_stars},
                                                    "config": {"engine": SMALL_ENGINE}})
    catalog = cell.maker.make(cell.spec["catalog"], 11, cell.config, "cpu")
    monkeypatch.setattr(base, "default_dtype", lambda device: dtype)
    fit = cell.builder.build(cell.config, catalog, "cpu", 13)
    assert fit.dtype == dtype
    return fit, cell.initials(17, 0)[0][:8]


def _special_walkers(fit, pos):
    """``pos`` and the walkers of (a): a bound beyond, a NaN column, 1e200
    beyond a bound, and sigma_max at 3000 km/s where it is sampled."""
    free = fit.fitted_parameters
    k, lo, hi = next((i, fit.parameters[n].min, fit.parameters[n].max)
                     for i, n in enumerate(free)
                     if np.isfinite(fit.parameters[n].min)
                     or np.isfinite(fit.parameters[n].max))
    rows = [pos[0].copy() for _ in range(3)]
    rows[0][k] = lo - 1.0 if np.isfinite(lo) else hi + 1.0
    rows[1][0] = np.nan
    rows[2][k] = lo - 1e200 if np.isfinite(lo) else hi + 1e200
    if "sigma_max" in free:
        rows.append(pos[1].copy())
        rows[-1][free.index("sigma_max")] = 3000.0
    return np.concatenate([pos, np.stack(rows)])


def _split(fn, thetas, chunk, dim=0):
    return torch.cat([fn(t) for t in torch.split(thetas, chunk, dim=dim)], dim=dim)


def _set_chunks(fit, chunk):
    fit.lnprob_chunk = chunk
    if hasattr(fit, "jam_grid_chunk"):
        fit.jam_grid_chunk = chunk


class _OneRank:
    """A mesh of one rank on the star axis: the all-reduce is the identity."""
    shape = {"sp": 1}

    def coordinate(self, axis):
        return 0

    def all_reduce(self, t, axis):
        return t


def _pipeline(case, dtype, monkeypatch):
    """A template and one bucket of 3 bins (50, 31 and 17 stars padded to
    50), 6 walkers a bin: ConstantFit's sufficient tables, or
    DoubleModelFit's terms (a joint prior) through the generic bucket."""
    monkeypatch.delenv("MCMC_TPU_LNPROB", raising=False)
    cls = models.ConstantFit if case == "pipeline_sufficient" else models.DoubleModelFit
    p = _parameters(cls, free_centre=False)
    cols = {k: v for k, v in _columns(60).items() if k in ("ra", "dec", "v", "verr")}
    template = cls(DataReader({k: u.Quantity(v, unit) for k, (v, unit) in cols.items()}),
                   parameters=p, seed=3, device="cpu", dtype=dtype)
    rng = np.random.default_rng(5)
    n_bins, n_max = 3, 50
    dx, dy = 0.01 * rng.normal(size=(2, n_bins, n_max))
    r = np.hypot(dx, dy)
    stacked = {"v": 5.0 * rng.normal(size=(n_bins, n_max)),
               "verr": 0.5 + rng.random((n_bins, n_max)),
               "gx": dy / r, "gy": -dx / r, "dxm": dx * 3437.7, "dym": dy * 3437.7,
               "mask": (np.arange(n_max) < np.array([[50], [31], [17]])).astype(float)}
    special = _special_walkers(template, template.get_initials(2))
    pos = np.stack([template.get_initials(6) for _ in range(n_bins)])
    for i, row in enumerate(special):
        pos[i % n_bins, 2 + i // n_bins] = row
    if case == "pipeline_sufficient":
        s_max = template._sufficient_s_max()
        n_coef = chebyshev_degree(float((stacked["verr"] ** 2).min()), s_max, dtype)

        def build():
            return pipelines._sufficient_lnprob(template, stacked, n_coef, s_max,
                                                "cpu", dtype)
    else:
        def build():
            return pipelines._generic_lnprob(template, stacked, "cpu", dtype)
    return template, template._to_device(pos), build


def _subject(case, dtype, monkeypatch):
    """(fit, walkers, evaluate, in-range mask or None): ``evaluate(chunk)``
    builds the case's tier anew and runs it at walker chunks of ``chunk``."""
    if case in MODELS or case in ("sharded_direct", "sharded_generic", "build_lnprob"):
        model = {"sharded_direct": "direct", "sharded_generic": "generic",
                 "build_lnprob": "generic_joint_prior"}.get(case, case)
        fit = _model(model, dtype, monkeypatch)
        tier = MODELS[model][1]
        pos = fit.get_initials(8)
    elif case.startswith("pipeline"):
        template, thetas, build = _pipeline(case, dtype, monkeypatch)
        in_range = None
        if case == "pipeline_sufficient":
            s_max = template._sufficient_s_max()
            in_range = thetas[..., 1] * thetas[..., 1] <= s_max
        return (template, thetas,
                lambda chunk: _split(build(), thetas, chunk, dim=1), in_range)
    else:
        kind, tier = case.replace("sharded_", "").split("_")
        fit, pos = _jam(kind, 200 if tier == "grid" else 60, dtype, monkeypatch)
        assert fit.lnprob_tier() == tier
    thetas = fit._to_device(_special_walkers(fit, pos))
    # the tiers with a walker chunk of their own
    chunked = tier == "generic" or case.startswith(("jam", "chemo", "sharded_jam"))

    if case.startswith("sharded"):
        def evaluate(chunk):
            _set_chunks(fit, chunk)
            partial = fit.build_lnlike_partial_batched() or sharded.generic_partial(fit)
            fit._sharded_data_cache = None
            lnprob = sharded._star_sharded_batched(fit, _OneRank(), "sp", partial)
            return lnprob(thetas) if chunked else _split(lnprob, thetas, chunk)
    elif case == "build_lnprob":
        def evaluate(chunk):
            if chunk == 1:
                one = fit.build_lnprob()
                return torch.stack([one(t) for t in thetas])
            _set_chunks(fit, chunk)
            return Runner.build_lnprob_batched(fit)(thetas)
    else:
        def evaluate(chunk):
            _set_chunks(fit, chunk)
            lnprob = fit.build_lnprob_batched()
            return lnprob(thetas) if chunked else _split(lnprob, thetas, chunk)

    in_range = None
    if tier == "sufficient":
        in_range = thetas[:, 1] * thetas[:, 1] <= fit._sufficient_s_max()
    elif tier == "tensor":
        in_range = fit.tensor_stats().in_box(thetas * fit._internal_col_scale())
    return fit, thetas, evaluate, in_range


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", CASES)
def test_posterior_assembly_contract(case, dtype, monkeypatch):
    fit, thetas, evaluate, in_range = _subject(case, dtype, monkeypatch)
    n_walkers = thetas.shape[-2]
    flat = thetas.reshape(-1, thetas.shape[-1])

    # (a) -inf exactly where the prior or the range guard says so
    prior = fit.compiled.lnprior(flat) + fit.extra_lnprior_fn(fit.scaled_values(flat))
    want = torch.isfinite(prior).reshape(thetas.shape[:-1])
    assert not want.all() and want.any()
    if in_range is not None:
        assert (want & ~in_range).any(), "no walker meets the range guard alone"
        want = want & in_range
    got = evaluate(n_walkers)
    assert got.shape == thetas.shape[:-1] and got.dtype == dtype
    assert not torch.isnan(got).any()
    assert torch.equal(torch.isneginf(got), ~want)
    assert torch.equal(torch.isfinite(got), want)

    # (b) the same bits at walker chunks of 1, 3 and W
    for chunk in (1, 3):
        part = evaluate(chunk)
        assert torch.equal(torch.isneginf(part), ~want), chunk
        if case in ROUNDING_ONLY:
            rtol = 100 * torch.finfo(dtype).eps
            torch.testing.assert_close(part[want], got[want], rtol=rtol, atol=0)
        else:
            assert torch.equal(part, got), chunk

    # (c) the joint prior sees the call's (W,) values
    seen = []
    cls = type(fit)
    real = cls.extra_lnprior_fn

    def recording(self, p):
        seen.extend(tuple(v.shape) for v in p.values() if torch.is_tensor(v))
        return real(self, p)

    monkeypatch.setattr(cls, "extra_lnprior_fn", recording)
    again = evaluate(n_walkers)
    assert torch.equal(torch.isneginf(again), ~want)
    assert seen and set(seen) == {(flat.shape[0],)}, seen
