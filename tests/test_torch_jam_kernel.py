"""The JAM engine's CUDA kernel (``ops.jam_moments``, ``csrc/jam_moments.cu``)
and the tiers that bind it.

On the CPU (tiny orders: a 8 x 4 polar grid, n_u 4, n_zeta 4, 2 walkers): the
wrapper on CPU tensors is the plain engine; the batched tiers bind the kernel
engine only where ``ops.use_kernel`` holds (forced on the CPU by setting
``ops.dispatch.KERNEL_DEVICE``), and the plain one on the CPU, in float64,
under ``MCMC_TPU_DISABLE_PALLAS=1`` and in ``build_lnprob_differentiable``;
the ``jam.engine_*`` counters count each engine call by its path.

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
are the plain engine's.
"""

import math

import numpy as np
import pytest
import torch

import mcmc_dynamics_tpu_torch as tpkg
from mcmc_dynamics_tpu_torch import ops, profiling
from mcmc_dynamics_tpu_torch.models.jam import axisymmetric
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


def test_chemo_keeps_its_plain_engine():
    """ChemoProfiles reroutes the moments (one engine call a population): no
    tier of it binds the kernel engine, whatever the predicate says."""
    chemo = tpkg.models.ChemoProfiles.__new__(tpkg.models.ChemoProfiles)
    for tier in ("grid", "direct", "grid partial"):
        assert not chemo._jam_kernel(tier)


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
