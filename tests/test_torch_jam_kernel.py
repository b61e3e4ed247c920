"""The JAM engine's CUDA kernel (``ops.jam_moments``, ``csrc/jam_moments.cu``)
and the tiers that bind it.

On the CPU (tiny orders: a 8 x 4 polar grid, n_u 4, n_zeta 4, 2 walkers): the
wrapper on CPU tensors is the plain engine; the batched tiers bind the kernel
engine only where ``ops.use_kernel`` holds (forced on the CPU by setting
``ops.dispatch.KERNEL_DEVICE``), and the plain one on the CPU, in float64,
under ``MCMC_TPU_DISABLE_PALLAS=1`` and in ``build_lnprob_differentiable``;
the ``jam.engine_*`` counters count each engine call by its path.
ChemoProfiles (the benchmark's ``jam_chemo_3pop`` configuration at a tiny
size: 3 populations over a 15-Gaussian tagged MGE) binds the kernel engine
once a walker chunk with every population stacked (once a population
where the tags have axis ratios of their own), and the plain engine, one
call a population, elsewhere; the wrapper's population axis on the CPU is
one plain call a population.  What the kernel's population axis
approximates, in float64 on the CPU: its LOS map centred on the summed
tracer against each population's own, the same map at one axis ratio, apart
by up to ~1e-3 of the vz field at the tags' own.

On the card (marked ``cuda``; this file imports no JAX, so it runs there with
``python3 -m pytest --noconftest -m cuda tests/test_torch_jam_kernel.py``):
the kernel against the plain engine in float64 at the benchmark's grid (128 x
12 positions, n_u 24, n_zeta 32, omega Cen's 5-Gaussian MGE) at 32 and 256
walkers, with and without a black hole, with per-walker (W, L) kappa and
(W, M) mscale, with per-walker (W, N) positions (the direct tier), with
n_zeta 20 and with a 12-Gaussian MGE.  Gate: on each field, the kernel's
largest error against float64 (over the walkers the float64 engine finds
valid) is at most 4x the plain float32 engine's own at the same inputs, both
relative to the field's largest value and relative to the largest value in
the same walker's half-octave band of projected radius (the field spans
decades in radius: an error confined to the outer positions shows there).  The black hole's x0 = C / 2 a_bh
straddles its switch at 50 on every walker: C runs from rbh^2 (6e-4 pc^2) at
the inner positions' central nodes to ~1e8 pc^2 at the outer LOS nodes.
Two calls give the same bits, each call is one launch, and the validity flags
are the plain engine's.  With a population axis (the chemo configuration's
15 tracer Gaussians over 5 mass Gaussians, 3 populations): each population
against its own float64 plain call at the same 4x gate, against a kernel
call of its own within 4x the plain float32 engine's error (the LOS map's
centre is the summed tracer's, which moves it by a rounding of the tracers'
mean axis ratio), a population axis of one bit for bit the two-dimensional
call, two calls the same bits; at the tags' own axis ratios, each
population against the plain engine centred alike; the timing of 3
populations in one call against one population and against 3 stacked on
the walker axis, and of one population in two-dimensional calls alone (a
tree without the population axis runs it too); ChemoProfiles' grid tier on
the card makes one launch a walker chunk (one a population at the tags'
own axis ratios).
"""

import json
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

import mcmc_dynamics_tpu_torch as tpkg
from mcmc_dynamics_tpu_torch import ops, profiling
from mcmc_dynamics_tpu_torch.models.jam import axisymmetric, chemo
from mcmc_dynamics_tpu_torch.models.jam.moments import jam_los_moments
from mcmc_dynamics_tpu_torch.ops import dispatch

SWITCH = dispatch.DISABLE_VARIABLE
RA_C, DEC_C = 201.697, -47.48
# omega Cen's King profile as 5 Gaussians (perfbench/configs/jam_axisymmetric_bh.json)
OMEGA_CEN = dict(i=[2588.2310694730604, 3816.4677317630703, 1884.1234579424201,
                    654.6660443882721, 174.20282006873984],
                 s=[65.97219965467515, 117.51144581401309, 208.33568235139722,
                    372.26229615684633, 724.0083142492658],
                 q=[0.83] * 5)
TINY = dict(n_u=4, n_zeta=4, jam_grid_orders=(8, 4))
ROOT = pathlib.Path(__file__).resolve().parents[1]
# the benchmark's chemo configuration: 3 populations, 15 tagged tracer
# Gaussians (one axis ratio), omega Cen's 5 mass Gaussians
CHEMO = json.loads((ROOT / "perfbench/configs/jam_chemo_3pop.json").read_text())


# ------------------------------------------------------------------- the CPU
def _counts():
    c = profiling.counters()
    return c["jam.engine_kernel"], c["jam.engine_plain"]


def _columns(n=120, seed=3):
    rng = np.random.default_rng(seed)
    r = np.abs(rng.normal(0.0, 200.0, n)) + 1.0
    phi = rng.uniform(-np.pi, np.pi, n)
    x, y = r * np.cos(phi), r * np.sin(phi)
    return {"ra": RA_C - (x / 3600.0) / math.cos(math.radians(DEC_C)),
            "dec": DEC_C + y / 3600.0, "v": 5.0 * rng.normal(size=n),
            "verr": 0.5 + 0.5 * rng.random(n)}


def _mge(n=3):
    q, table = tpkg.units.Quantity, tpkg.utils.Table
    i, s = OMEGA_CEN["i"][:n], OMEGA_CEN["s"][:n]
    lum = tpkg.utils.MgeReader(table({"n": list(range(1, n + 1)),
                                      "i": q(i, "solLum/pc2"), "s": q(s, "arcsec"),
                                      "q": [0.83] * n}), lum=True)
    mass = tpkg.utils.MgeReader(table({"n": list(range(1, n + 1)),
                                       "i": q(i, "solMass/pc2"), "s": q(s, "arcsec"),
                                       "q": [0.83] * n}), lum=False)
    return lum, mass


def _fit(dtype, model="Axisymmetric", tier="grid"):
    """A tiny fit on the CPU: 120 stars, the grid tier from 100 stars."""
    cols = _columns()
    q = tpkg.units.Quantity
    reader = tpkg.DataReader({"ra": q(cols["ra"], "deg"), "dec": q(cols["dec"], "deg"),
                              "v": q(cols["v"], "km/s"), "verr": q(cols["verr"], "km/s")})
    cls = getattr(tpkg.models, model)
    params = cls.default_parameters()
    fixed = dict(d=5.2, beta=0.0, rbh=1.0, delta_v=0.0, ra_center=RA_C, dec_center=DEC_C)
    if model == "AnalyticalProfiles":
        fixed.update(mlr_t=2.5, mlr_inf=2.5, r_mlr=100.0, r_kappa=100.0)
    for name, value in fixed.items():
        params[name].set(value=value, fixed=True)
    free = dict(barq=(0.7, 0.0, 1.0), kappa_x=(0.3, -2.0, 2.0), kappa_y=(0.1, -2.0, 2.0),
                mbh=(3e4, 0.0, 1e6))
    free["mlr_0" if model == "AnalyticalProfiles" else "mlr"] = (2.5, 0.5, 10.0)
    for name, (value, lo, hi) in free.items():
        params[name].set(value=value, min=lo, max=hi, fixed=False)
    lum, mass = _mge()
    fit = cls(reader, parameters=params, mge_lum=lum, mge_mass=mass, device="cpu",
              dtype=dtype)
    fit.n_u, fit.n_zeta = TINY["n_u"], TINY["n_zeta"]
    fit.jam_grid_orders = TINY["jam_grid_orders"]
    fit.jam_grid_min_stars = 100 if tier == "grid" else 10_000
    assert fit.lnprob_tier() == tier
    return fit


def _thetas(fit):
    """Two walkers near the fit's values (inside every prior)."""
    values = {"mlr": 2.5, "mlr_0": 2.5, "barq": 0.7, "kappa_x": 0.3, "kappa_y": 0.1,
              "mbh": 3e4}
    row = [values[n] for n in fit.fitted_parameters]
    return fit._to_device(np.array([row, [v * 1.01 for v in row]]))


@pytest.fixture
def stand_in(monkeypatch):
    """Counts the calls of the kernel engine the models' module binds (the
    stand-in runs the real wrapper: on the CPU, the plain engine)."""
    calls = []
    real = axisymmetric.jam_moments

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(axisymmetric, "jam_moments", counting)
    return calls


def test_cpu_wrapper_is_the_plain_version():
    """CPU tensors: the wrapper returns the plain engine's tensors exactly,
    counts a plain call and launches nothing."""
    rng = np.random.default_rng(1)
    t = torch.as_tensor
    x, y = t(rng.normal(0, 200, 6)), t(rng.normal(0, 200, 6))
    kw = dict(lum_i=t(OMEGA_CEN["i"][:3]), lum_s=t(OMEGA_CEN["s"][:3]),
              lum_q=t([0.83] * 3), mass_i=t(OMEGA_CEN["i"][:3]),
              mass_s=t(OMEGA_CEN["s"][:3]), mass_q=t([0.83] * 3), d=5.2, beta=0.0,
              kappa=t([[0.3], [0.2]]), mscale=t([[2.5], [2.4]]),
              incl=t([[1.0], [1.1]]), mbh=t([[3e4], [1e5]]), rbh=1.0, n_u=4, n_zeta=4)
    launches, before = ops.JAM_MOMENTS.launches, _counts()
    got = ops.jam_moments(x, y, **kw)
    want = jam_los_moments(x, y, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ops.JAM_MOMENTS.launches == launches
    assert _counts() == (before[0], before[1] + 1)


@pytest.mark.parametrize("route", ["cpu", "float64", "switch", "differentiable"])
@pytest.mark.parametrize("tier", ["grid", "direct"])
def test_plain_paths_bind_the_plain_engine(route, tier, monkeypatch, stand_in):
    """The CPU device, float64 (on a forced kernel device), the switch and
    the differentiable tier bind the plain engine: the kernel engine is
    never called, and each walker chunk adds one plain call."""
    monkeypatch.delenv(SWITCH, raising=False)
    if route != "cpu":
        monkeypatch.setattr(dispatch, "KERNEL_DEVICE", "cpu")
    if route == "switch":
        monkeypatch.setenv(SWITCH, "1")
    fit = _fit(torch.float64 if route == "float64" else torch.float32, tier=tier)
    fn = (fit.build_lnprob_differentiable() if route == "differentiable"
          else fit.batched_lnprob())
    thetas = _thetas(fit).to(fit.dtype)
    before = _counts()
    got = fn(thetas)
    assert got.shape == (2,) and torch.isfinite(got).all()
    assert stand_in == []
    assert _counts() == (before[0], before[1] + 1)


@pytest.mark.parametrize("model", ["Axisymmetric", "AnalyticalProfiles"])
@pytest.mark.parametrize("tier", ["grid", "direct"])
def test_kernel_predicate_binds_the_kernel_engine(model, tier, monkeypatch, stand_in):
    """With ``ops.use_kernel`` forced true on the CPU, the batched tier (and
    the grid tier's partial) call the kernel engine once a walker chunk, at
    the grid's positions or the stars'; the values are the plain tier's."""
    monkeypatch.delenv(SWITCH, raising=False)
    monkeypatch.setattr(dispatch, "KERNEL_DEVICE", "cpu")
    fit = _fit(torch.float32, model=model, tier=tier)
    thetas = _thetas(fit)
    got = fit.batched_lnprob()(thetas)
    # the grid's 8 x 4 points, shared by the walkers, or each walker's stars
    shape = torch.Size([32] if tier == "grid" else [2, 120])
    assert stand_in == [shape]
    if tier == "grid":
        local = fit.sharded_star_data()
        local["mask"] = torch.ones(fit.n_data, dtype=fit.dtype)
        fit._partial_tier_cached()(thetas, local)
        assert stand_in == [shape] * 2
    monkeypatch.setenv(SWITCH, "1")
    torch.testing.assert_close(fit.batched_lnprob()(thetas), got, rtol=0, atol=0)
    assert len(stand_in) == (2 if tier == "grid" else 1)


def _tags_q(tags_q):
    """The chemo configuration's tracer axis ratios with each tag's own,
    ``tags_q[tag]``, as a configuration override."""
    return {"mge_tags": {"q": [tags_q[t] for t in CHEMO["mge_tags"]["pop"]]}}


def _chemo(dtype, tier, n_stars=None, tags_q=None):
    """The benchmark's chemo cell at a tiny size on the CPU: its catalog
    maker and its builder, 120 stars (the grid tier from 100), tiny
    orders, jam_grid_chunk and lnprob_chunk 2; ``tags_q``, each spatial
    tag's own axis ratio (the configuration's one where None)."""
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    config = {"engine": {"n_u": TINY["n_u"], "n_zeta": TINY["n_zeta"],
                         "grid_orders": list(TINY["jam_grid_orders"]),
                         "grid_min_stars": 100 if tier == "grid" else 10_000}}
    if tags_q is not None:
        config.update(_tags_q(tags_q))
    cell = harness.Cell("jam_chemo_3pop.mock1e5_w128", overrides={
        "catalog": {"n_stars": n_stars or 120}, "config": config})
    catalog = cell.maker.make(cell.spec["catalog"], 3, cell.config, "cpu")
    fit = cell.builder.build(cell.config, catalog, "cpu", 5, dtype=dtype)
    fit.jam_grid_chunk = fit.lnprob_chunk = 2
    assert fit.lnprob_tier() == tier
    return fit, torch.as_tensor(cell.initials(3, 0)[0][:4], dtype=dtype)


@pytest.fixture
def chemo_stand_in(monkeypatch):
    """Counts the calls of the kernel engine ChemoProfiles binds (the
    stand-in runs the real wrapper: on the CPU, one plain call a
    population)."""
    calls = []
    real = chemo.jam_moments

    def counting(*args, **kwargs):
        calls.append(tuple(args[2].shape))
        return real(*args, **kwargs)

    monkeypatch.setattr(chemo, "jam_moments", counting)
    return calls


def _pop_counts():
    return (*_counts(), profiling.counters()["jam.populations"])


def test_chemo_keeps_its_plain_engine(monkeypatch, chemo_stand_in):
    """ChemoProfiles where ``ops.use_kernel`` fails (the CPU) and in its
    differentiable tier, on the grid and the direct tier: no kernel-engine
    call, one plain call a population a walker chunk (two chunks of two
    walkers here)."""
    monkeypatch.delenv(SWITCH, raising=False)
    for tier in ("grid", "direct"):
        fit, thetas = _chemo(torch.float64, tier)
        for fn in (fit.batched_lnprob(), fit.build_lnprob_differentiable()):
            before = _pop_counts()
            got = fn(thetas)
            assert got.shape == (4,) and torch.isfinite(got).all()
            assert chemo_stand_in == []
            assert _pop_counts() == (before[0], before[1] + 6, before[2] + 6)


@pytest.mark.parametrize("tier", ["grid", "direct"])
def test_chemo_binds_the_kernel_engine(tier, monkeypatch, chemo_stand_in):
    """With ``ops.use_kernel`` forced true on the CPU, ChemoProfiles' batched
    tier (and the grid tier's partial) call the kernel engine once a walker
    chunk with the 3 populations' intensities stacked, (3, W, L); on the CPU
    the wrapper runs the plain engine a population at a time, so the values
    are the plain tier's bit for bit."""
    monkeypatch.delenv(SWITCH, raising=False)
    monkeypatch.setattr(dispatch, "KERNEL_DEVICE", "cpu")
    fit, thetas = _chemo(torch.float32, tier)
    before = _pop_counts()
    got = fit.batched_lnprob()(thetas)
    assert chemo_stand_in == [(3, 2, 15)] * 2
    assert _pop_counts() == (before[0], before[1] + 6, before[2] + 6)
    if tier == "grid":
        local = fit.sharded_star_data()
        local["mask"] = torch.ones(fit.n_data, dtype=fit.dtype)
        fit._partial_tier_cached()(thetas, local)
        assert chemo_stand_in == [(3, 2, 15)] * 4
    monkeypatch.setenv(SWITCH, "1")
    torch.testing.assert_close(fit.batched_lnprob()(thetas), got, rtol=0, atol=0)
    assert len(chemo_stand_in) == (4 if tier == "grid" else 2)


@pytest.mark.parametrize("tier", ["grid", "direct"])
def test_chemo_binds_a_launch_a_population_at_distinct_axis_ratios(
        tier, monkeypatch, chemo_stand_in):
    """Where the spatial tags have axis ratios of their own (0.85, 0.83,
    0.8), the kernel's population axis would centre each population's LOS
    map off its own ridge (``test_shared_ridge_departure``): ChemoProfiles'
    batched tier then calls the kernel engine once a population, each call
    two-dimensional, (W, L); the values are the plain tier's bit for bit."""
    monkeypatch.delenv(SWITCH, raising=False)
    monkeypatch.setattr(dispatch, "KERNEL_DEVICE", "cpu")
    fit, thetas = _chemo(torch.float32, tier, tags_q=(0.85, 0.83, 0.8))
    before = _pop_counts()
    got = fit.batched_lnprob()(thetas)
    assert torch.isfinite(got).all()
    assert chemo_stand_in == [(2, 15)] * 6
    assert _pop_counts() == (before[0], before[1] + 6, before[2] + 6)
    monkeypatch.setenv(SWITCH, "1")
    torch.testing.assert_close(fit.batched_lnprob()(thetas), got, rtol=0, atol=0)


# each spatial tag's axis ratio, and the bound on the departure of the LOS
# map centred on the populations' summed tracer from each population's own
# (vz and v2zz, of the field's largest value), float64 at the chemo orders
RIDGE_CASES = {
    "one axis ratio": ((0.83, 0.83, 0.83), 1e-12),
    "tags 0.9 / 0.85 / 0.8": ((0.9, 0.85, 0.8), 1e-4),
    "tags 0.95 / 0.8 / 0.6": ((0.95, 0.8, 0.6), 5e-3),
}


@pytest.mark.parametrize("case", list(RIDGE_CASES))
def test_shared_ridge_departure(case):
    """What the kernel's population axis approximates, on the CPU in
    float64: the plain engine with its LOS map centred on the populations'
    summed tracer (``ridge_i``, as the kernel centres every population)
    against each population's own centre, at the chemo orders (n_u 24,
    n_zeta 32) on a 32 x 4 polar grid, 4 walkers, the chemo tagged MGE with
    each tag's axis ratio.  One axis ratio: the same map to rounding
    (measured 3e-16 of the field).  The tags' own: two quadratures of one
    integral, whose vz parts in some population by more than 10x the float32
    plain engine's own error (measured up to 3.2e-5 of the field at 0.9 /
    0.85 / 0.8, 1.2e-3 at 0.95 / 0.8 / 0.6; v2zz under 1e-7), past the card
    tests' 4x gate: so the kernel's population axis is bound only at one
    axis ratio, and ChemoProfiles launches a population at a time
    otherwise."""
    tags_q, bound = RIDGE_CASES[case]
    args = _pop_inputs(4, seed=1, tags_q=tags_q)
    args["x"], args["y"] = _grid_positions(32, 4)
    orders = dict(n_u=24, n_zeta=32)
    ridge = torch.as_tensor(args["lum_i"].sum(axis=0))
    ratios = []
    for p in range(3):
        one = _one_population(args, p)
        a64 = _to(one, torch.float64, "cpu")
        own = jam_los_moments(**a64, **orders)
        shared = jam_los_moments(**a64, **orders, ridge_i=ridge)
        f32 = jam_los_moments(**_to(one, torch.float32, "cpu"), **orders)
        ok = own.valid
        assert torch.equal(shared.valid, ok) and int(ok.sum()) == 3
        for name in ("vz", "v2zz"):
            w = getattr(own, name)[ok]
            scale = w.abs().max()
            departure = float((getattr(shared, name)[ok] - w).abs().max() / scale)
            err32 = float((getattr(f32, name)[ok].double() - w).abs().max() / scale)
            assert departure <= bound, (p, name, departure)
            if name == "vz":
                ratios.append(departure / err32)
    if len(set(tags_q)) > 1:
        assert max(ratios) > 10.0, ratios


def test_population_axis_on_the_cpu_is_one_call_a_population():
    """CPU tensors with a population axis on ``lum_i`` and ``kappa``: the
    wrapper's moments are the plain engine's of each population, stacked,
    from one plain call a population; ``kappa`` without the axis is shared."""
    rng = np.random.default_rng(2)
    t = torch.as_tensor
    L, W = 6, 3
    lum_i = t(OMEGA_CEN["i"][:3] * 2) * t(rng.uniform(0.1, 1.0, (2, W, L)))
    kw = dict(lum_s=t(OMEGA_CEN["s"][:3] * 2), lum_q=t([0.83] * L),
              mass_i=t(OMEGA_CEN["i"][:3]), mass_s=t(OMEGA_CEN["s"][:3]),
              mass_q=t([0.83] * 3), d=5.2, beta=0.0, mscale=t([[2.5], [2.4], [2.6]]),
              incl=t([[1.0], [1.1], [0.05]]), mbh=t([[3e4], [1e5], [1e4]]), rbh=1.0,
              n_u=4, n_zeta=4)
    x, y = t(rng.normal(0, 200, 5)), t(rng.normal(0, 200, 5))
    for kappa in (t(rng.uniform(0.1, 0.5, (2, W, L))), t([[0.3], [0.2], [0.1]])):
        before = _pop_counts()
        got = ops.jam_moments(x, y, lum_i=lum_i, kappa=kappa, **kw)
        assert _pop_counts() == (before[0], before[1] + 2, before[2] + 2)
        for p in range(2):
            want = jam_los_moments(x, y, lum_i=lum_i[p],
                                   kappa=kappa[p] if kappa.dim() == 3 else kappa, **kw)
            for g, w in zip(got, want):
                assert torch.equal(g[p], w)
        assert got.vz.shape == (2, W, 5) and got.valid.shape == (2, W)
        assert not bool(got.valid[0, 2]) and not bool(got.valid[1, 2])


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _grid_positions(n_r=128, n_phi=12, r_lo=0.06, r_hi=1800.0):
    """The polar grid's quarter-plane positions (as ``JamGridSpec.build``
    lays them out) between ``r_lo`` and ``r_hi`` arcsec."""
    k = np.arange(n_r)
    xi = np.cos(np.pi * (k + 0.5) / n_r)
    t = 0.5 * (math.log(r_hi) + math.log(r_lo)) + 0.5 * (math.log(r_hi) - math.log(r_lo)) * xi
    phi = 0.5 * (np.arange(n_phi) + 0.5) * math.pi / n_phi
    rr, pp = np.meshgrid(np.exp(t), phi, indexing="ij")
    return (rr * np.cos(pp)).ravel(), (rr * np.sin(pp)).ravel()


def _mge_of(n):
    """omega Cen's 5 Gaussians, or ``n`` Gaussians spread over its range."""
    if n == 5:
        return (np.array(OMEGA_CEN["i"]), np.array(OMEGA_CEN["s"]),
                np.array(OMEGA_CEN["q"]))
    s = np.geomspace(20.0, 900.0, n)
    return 3000.0 * np.exp(-0.5 * (s / 300.0) ** 2) + 50.0, s, np.linspace(0.75, 0.9, n)


def _inputs(W, n_mge=5, bh=True, per_walker=False, per_component=False, seed=0):
    """The engine's arguments as numpy (positions first) for W walkers."""
    rng = np.random.default_rng(seed)
    i, s, q = _mge_of(n_mge)
    if per_walker:
        r = np.abs(rng.normal(0.0, 300.0, (W, 2048))) + 0.5
        phi = rng.uniform(-np.pi, np.pi, (W, 2048))
        x, y = r * np.cos(phi), r * np.sin(phi)
    else:
        x, y = _grid_positions()
    barq = rng.uniform(0.65, 0.75, (W, 1))
    qmed = float(np.median(q))
    incl = np.arccos(np.sqrt(np.clip((qmed ** 2 - barq ** 2) / (1 - barq ** 2), 0, 1)))
    kap = rng.uniform(0.1, 0.5, (W, 1))
    mlr = rng.uniform(2.0, 3.0, (W, 1))
    if per_component:
        kap = kap * rng.uniform(0.5, 1.5, (W, n_mge))
        mlr = mlr * rng.uniform(0.8, 1.2, (W, n_mge))
    args = dict(x=x, y=y, lum_i=i, lum_s=s, lum_q=q, mass_i=i, mass_s=s, mass_q=q,
                d=5.2, beta=0.0, kappa=kap, mscale=mlr, incl=incl,
                mbh=rng.uniform(1e4, 1e5, (W, 1)) if bh else 0.0, rbh=1.0)
    # one walker with a failed deprojection
    args["incl"][0] = 0.05
    return args


def _to(args, dtype, device):
    return {k: (torch.as_tensor(v, dtype=dtype, device=device)
                if isinstance(v, np.ndarray) else v) for k, v in args.items()}


def _plain(args, dtype, device, orders, chunk=32):
    """The plain engine in walker chunks (its pair table is (W, T, P))."""
    a = _to(args, dtype, device)
    W = a["incl"].shape[0]
    parts = []
    for lo in range(0, W, chunk):
        sl = {k: (v[lo:lo + chunk] if torch.is_tensor(v) and v.dim() == 2
                  and v.shape[0] == W else v) for k, v in a.items()}
        parts.append(jam_los_moments(**sl, **orders))
    return [torch.cat([getattr(p, f) for p in parts]) for f in ("vz", "v2zz", "valid")]


def _band_err(got, want, x, y):
    """max |got - want| over (W, N), each relative to the largest |want| of
    its walker in its half-octave band of projected radius sqrt(x^2 + y^2)
    ((N,) positions shared by the walkers, or (W, N))."""
    W, N = want.shape
    r = torch.hypot(torch.as_tensor(x, dtype=torch.float64),
                    torch.as_tensor(y, dtype=torch.float64)).expand(W, N)
    band = torch.floor(2.0 * torch.log2(r)).long()
    band = band - band.min()
    n_band = int(band.max()) + 1
    key = (torch.arange(W)[:, None] * n_band + band).flatten().to(want.device)
    a = want.abs().flatten()
    scale = torch.zeros(W * n_band, dtype=a.dtype, device=a.device).scatter_reduce(
        0, key, a, "amax")
    return float(((got - want).abs().flatten() / scale[key]).max())


CARD_CASES = {
    "grid 32 bh": dict(W=32),
    "grid 256 bh": dict(W=256),
    "grid 32 no bh": dict(W=32, bh=False),
    "grid 32 profiles": dict(W=32, per_component=True),
    "direct 32": dict(W=32, per_walker=True),
    "grid 32 n_zeta 20": dict(W=32, n_zeta=20),
    "grid 32 mge 12": dict(W=32, n_mge=12),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_against_the_plain_engine(case, cuda_device):
    spec = dict(CARD_CASES[case])
    n_zeta = spec.pop("n_zeta", 32)
    orders = dict(n_u=24, n_zeta=n_zeta)
    args = _inputs(**spec)
    assert not torch.backends.cuda.matmul.allow_tf32
    want = _plain(args, torch.float64, cuda_device, orders)
    plain = _plain(args, torch.float32, cuda_device, orders)
    a32 = _to(args, torch.float32, cuda_device)
    launches = ops.JAM_MOMENTS.launches
    got = ops.jam_moments(**a32, **orders)
    again = ops.jam_moments(**a32, **orders)
    torch.cuda.synchronize()
    assert ops.JAM_MOMENTS.launches == launches + 2
    assert torch.equal(got.valid, plain[2]) and torch.equal(want[2], plain[2])
    assert not bool(want[2][0]) and int(want[2].sum()) == spec["W"] - 1
    ok = want[2]
    x, y = args["x"], args["y"]
    if x.ndim == 2:
        x, y = x[ok.cpu().numpy()], y[ok.cpu().numpy()]
    for k, name in enumerate(("vz", "v2zz")):
        g, p, w = getattr(got, name)[ok].double(), plain[k][ok].double(), want[k][ok]
        assert torch.isfinite(g).all()
        scale = w.abs().max()
        err_kernel = float((g - w).abs().max() / scale)
        err_plain = float((p - w).abs().max() / scale)
        assert err_kernel <= 4.0 * err_plain, (name, err_kernel, err_plain)
        band_kernel, band_plain = _band_err(g, w, x, y), _band_err(p, w, x, y)
        assert band_kernel <= 4.0 * band_plain, (name, band_kernel, band_plain)
        assert torch.equal(getattr(got, name).view(torch.int32),
                           getattr(again, name).view(torch.int32))


def _pop_inputs(W, n_pops=3, bh=False, seed=0, tags_q=None):
    """The engine's arguments as numpy for W walkers and ``n_pops``
    populations of the chemo configuration's tagged MGE: each population
    the tags weighted by one row of a random mixing matrix (columns summing
    to 1), its own per-component kappa; per-component M/L.  ``tags_q``:
    each tag's own axis ratio, the inclinations then drawn to deproject the
    flattest (barq 0.75-0.92 of its axis ratio)."""
    rng = np.random.default_rng(seed)
    tags, mass = CHEMO["mge_tags"], CHEMO["mge_mass"]
    i, s, q = (np.asarray(tags[k]) for k in ("i", "s", "q"))
    tag = np.asarray(tags["pop"])
    args = _inputs(W, bh=bh, seed=seed)
    if tags_q is not None:
        q = np.asarray(tags_q)[tag]
        barq = q.min() * rng.uniform(0.75, 0.92, (W, 1))
        args["incl"] = np.arccos(np.sqrt((q.min() ** 2 - barq ** 2) / (1 - barq ** 2)))
        args["incl"][0] = 0.05
    h = rng.uniform(0.1, 1.0, (n_pops, W, 3))
    h /= h.sum(axis=0, keepdims=True)
    args.update(lum_i=i * h[:, :, tag], lum_s=s, lum_q=q,
                mass_i=np.asarray(mass["i"]), mass_s=np.asarray(mass["s"]),
                mass_q=np.asarray(mass["q"]),
                kappa=rng.uniform(-0.5, 0.8, (n_pops, W, i.size)),
                mscale=rng.uniform(2.0, 3.0, (W, len(mass["i"]))))
    return args


def _one_population(args, p):
    return dict(args, lum_i=args["lum_i"][p], kappa=args["kappa"][p])


POP_CASES = {
    "chemo 32, 3 populations": dict(W=32),
    "chemo 32, 1 population": dict(W=32, n_pops=1),
    "chemo 256, 3 populations, bh": dict(W=256, bh=True),
    "chemo 32, tags 0.9 / 0.85 / 0.8": dict(W=32, tags_q=(0.9, 0.85, 0.8)),
    "chemo 32, tags 0.95 / 0.8 / 0.6": dict(W=32, tags_q=(0.95, 0.8, 0.6)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(POP_CASES))
def test_population_kernel_against_the_plain_engine(case, cuda_device):
    """Each population of one call against its own float64 plain call, at 4x
    the plain float32 engine's error (field and band); against a kernel call
    of its own (which centres the LOS map on its own tracer's ridge, not on
    the summed tracer's: at one axis ratio the two centres differ by a
    rounding of the mean axis ratio) within the same 4x; a population axis
    of one is the two-dimensional call bit for bit; one launch a call and
    the same bits twice.  With each tag's own axis ratio the population
    axis computes the plain engine centred on the summed tracer
    (``ridge_i``; ``test_shared_ridge_departure`` gives how far that is
    from each population's own): it is held to that, float64 against
    float32, at the same 4x, and each population's kernel call of its own
    (ChemoProfiles' binding there) to its own float64 plain call at 4x."""
    spec = dict(POP_CASES[case])
    tags_q = spec.get("tags_q")
    orders = dict(n_u=24, n_zeta=32)
    args = _pop_inputs(**spec)
    a32 = _to(args, torch.float32, cuda_device)
    launches = ops.JAM_MOMENTS.launches
    got = ops.jam_moments(**a32, **orders)
    again = ops.jam_moments(**a32, **orders)
    torch.cuda.synchronize()
    assert ops.JAM_MOMENTS.launches == launches + 2
    n_pops = args["lum_i"].shape[0]
    assert got.vz.shape == (n_pops, spec["W"], args["x"].size)
    assert torch.equal(got.valid, again.valid)
    for name in ("vz", "v2zz"):            # bits: the invalid walker's NaN too
        assert torch.equal(getattr(got, name).view(torch.int32),
                           getattr(again, name).view(torch.int32))
    x, y = args["x"], args["y"]

    def within_4x(g, pl, w, what):
        """g's error against w at most 4x pl's, of the field and the band."""
        scale = w.abs().max()
        err_plain = float((pl - w).abs().max() / scale)
        err_kernel = float((g - w).abs().max() / scale)
        assert err_kernel <= 4.0 * err_plain, (what, err_kernel, err_plain)
        assert _band_err(g, w, x, y) <= 4.0 * _band_err(pl, w, x, y), what
        return err_plain

    for p in range(n_pops):
        one = _one_population(args, p)
        want = _plain(one, torch.float64, cuda_device, orders)
        plain = _plain(one, torch.float32, cuda_device, orders)
        own = ops.jam_moments(**_to(one, torch.float32, cuda_device), **orders)
        assert torch.equal(got.valid[p], plain[2]) and torch.equal(want[2], plain[2])
        ok = want[2]
        assert not bool(ok[0]) and int(ok.sum()) == spec["W"] - 1
        if tags_q is not None:
            shared = dict(one, ridge_i=args["lum_i"].sum(axis=0))
            want_c = _plain(shared, torch.float64, cuda_device, orders)
            plain_c = _plain(shared, torch.float32, cuda_device, orders)
        for k, name in enumerate(("vz", "v2zz")):
            g = getattr(got, name)[p][ok].double()
            o = getattr(own, name)[ok].double()
            pl, w = plain[k][ok].double(), want[k][ok]
            if n_pops == 1:
                assert torch.equal(getattr(got, name)[p].view(torch.int32),
                                   getattr(own, name).view(torch.int32))
            if tags_q is not None:
                within_4x(g, plain_c[k][ok].double(), want_c[k][ok], (p, name, "shared"))
                within_4x(o, pl, w, (p, name, "own"))
                continue
            err_plain = within_4x(g, pl, w, (p, name))
            own_gap = float((g - o).abs().max() / w.abs().max())
            assert own_gap <= 4.0 * err_plain, (p, name, own_gap, err_plain)


def _kernel_ms(args, orders, n=20, repeats=5):
    """Device ms of a kernel call on ``args``: CUDA events around ``n``
    calls launched back to back behind a spin kernel (~50 ms), so the host
    has queued them all before the first starts and the events time the
    device alone; the median of ``repeats`` such runs, after two warm-up
    calls."""
    for _ in range(2):
        ops.jam_moments(**args, **orders)
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(n):
            ops.jam_moments(**args, **orders)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


@pytest.mark.cuda
def test_population_kernel_timing(cuda_device):
    """The chemo chunk's shape, 32 walkers x 1536 positions x 32 LOS nodes,
    L 15, M 5: 3 populations in one call take at most 1.5x one population's
    call (the pair table is built and contracted once); 3 populations
    stacked on the walker axis (96 walkers) are printed beside them."""
    orders = dict(n_u=24, n_zeta=32)
    args = _pop_inputs(32)
    three = _to(args, torch.float32, cuda_device)
    one = _to(_one_population(args, 0), torch.float32, cuda_device)
    stacked = _to({k: (np.concatenate(list(v)) if k in ("lum_i", "kappa") else
                       np.concatenate([v] * 3) if isinstance(v, np.ndarray) and v.ndim == 2
                       and v.shape[0] == 32 else v)
                   for k, v in args.items()}, torch.float32, cuda_device)
    ms = {"3 populations, one call": _kernel_ms(three, orders),
          "1 population": _kernel_ms(one, orders),
          "3 populations on the walker axis": _kernel_ms(stacked, orders)}
    print(json.dumps({"jam_moments_populations_ms": ms,
                      "device": torch.cuda.get_device_name(0)}))
    assert ms["3 populations, one call"] <= 1.5 * ms["1 population"], ms


def _plain_ms(args, device, orders):
    """Device ms of one plain float32 engine call on ``args``, events around
    it after a warm-up call."""
    a32 = _to(args, torch.float32, device)
    jam_los_moments(**a32, **orders)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    jam_los_moments(**a32, **orders)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


@pytest.mark.cuda
def test_one_population_kernel_timing(cuda_device):
    """The kernel at one population, two-dimensional calls alone (so that
    the same test times a tree without the population axis): 32 walkers x
    1536 positions x 32 LOS nodes, at the JAM cells' 5 Gaussians with a
    black hole and at the chemo configuration's 15 tagged Gaussians without
    one; the device ms a call printed, each under a tenth of the plain
    float32 engine's in one call."""
    orders = dict(n_u=24, n_zeta=32)
    cells = _inputs(32)
    chemo_one = _one_population(_pop_inputs(32), 0)
    out = {}
    for label, args in (("JAM cells, 5 Gaussians, bh", cells),
                        ("chemo, 15 Gaussians, one population", chemo_one)):
        a32 = _to(args, torch.float32, cuda_device)
        ms = _kernel_ms(a32, orders)
        plain_ms = _plain_ms(args, cuda_device, orders)
        out[label] = {"ms": ms, "plain_ms": plain_ms}
        assert ms < 0.1 * plain_ms, (label, ms, plain_ms)
    print(json.dumps({"jam_moments_one_population_ms": out,
                      "device": torch.cuda.get_device_name(0)}))


@pytest.mark.cuda
@pytest.mark.parametrize("tags_q", [None, (0.85, 0.83, 0.8)],
                         ids=["one axis ratio", "tags 0.85 / 0.83 / 0.8"])
def test_chemo_grid_tier_on_the_card(tags_q, cuda_device, monkeypatch):
    """ChemoProfiles' grid tier on the card (the chemo cell's orders, 2000
    stars, 64 walkers in chunks of 32): one kernel launch a walker chunk for
    its 3 populations (one a population where the tags have axis ratios of
    their own), no plain call; its lnprob against the float64 plain tier's
    within 4x the float32 plain tier's own gap."""
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    monkeypatch.delenv(SWITCH, raising=False)
    config = {"engine": {"grid_min_stars": 100}}
    if tags_q is not None:
        config.update(_tags_q(tags_q))
    cell = harness.Cell("jam_chemo_3pop.mock1e5_w128",
                        overrides={"catalog": {"n_stars": 2000}, "config": config})
    catalog = cell.maker.make(cell.spec["catalog"], 3, cell.config, cuda_device)
    thetas = cell.initials(3, 0)[0][:64]

    def lnprob(dtype, plain=False):
        fit = cell.builder.build(cell.config, catalog, cuda_device, 5, dtype=dtype)
        assert fit.lnprob_tier() == "grid"
        if plain:
            monkeypatch.setenv(SWITCH, "1")
        try:
            before = (*_counts(), profiling.counters()["jam.populations"])
            out = fit.batched_lnprob()(torch.as_tensor(thetas, dtype=dtype,
                                                       device=cuda_device))
            torch.cuda.synchronize()
            after = (*_counts(), profiling.counters()["jam.populations"])
        finally:
            monkeypatch.delenv(SWITCH, raising=False)
        return out.double(), tuple(b - a for a, b in zip(before, after))

    got, counts = lnprob(torch.float32)
    assert counts == ((2, 0, 6) if tags_q is None else (6, 0, 6))
    want, _ = lnprob(torch.float64)
    plain, plain_counts = lnprob(torch.float32, plain=True)
    assert plain_counts == (0, 6, 6)
    assert torch.isfinite(want).all()
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert float((got - want).abs().max()) <= 4.0 * float((plain - want).abs().max())
