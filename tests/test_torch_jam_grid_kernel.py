"""The JAM grid's star reconstruction as a CUDA kernel
(``ops.jam_grid_reconstruct``, ``csrc/jam_grid.cu``) and the grid tiers that
bind it.

On the CPU: the wrapper on CPU tensors is the plain reconstruction, bit for
bit the tail ``models/jam/grid.py:jam_grid_moments`` had before the kernel;
the grid tiers of Axisymmetric and ChemoProfiles and the grid partial bind
the kernel's wrapper only where ``ops.use_kernel`` holds (forced on the CPU
by setting ``ops.dispatch.KERNEL_DEVICE``), and the plain version on the CPU,
in float64 and under ``MCMC_TPU_DISABLE_PALLAS=1``; ``jam.recon_kernel`` and
``jam.recon_plain`` count each call by its path; the launcher's argument
(strides, shapes, theta0 as a number or a tensor) and what it refuses; the
kernel's order of work (passes of ``kK`` harmonics, their partial sums
added) emulated in float64 against the plain version.

On the card (marked ``cuda``; this file imports no JAX, so it runs there with
``python3 -m pytest --noconftest -m cuda tests/test_torch_jam_grid_kernel.py``):
the kernel against the float64 plain reconstruction on the coefficients the
grid tiers build on the card: the JAM cells' 32 walkers x 16384 stars with a
theta0 a walker, the chemo cell's 96 walker-populations at 2e4 stars with
theta0 0, a ragged star count and walker count, a star slice as the sharded
partial passes it, orders 40 x 16 (a ragged radial chunk, two harmonic
passes) and 36 x 7 (harmonics in no float4), and column-major operands (the
kernel's 4-byte copies).  Gate: each field's largest error against float64, relative to the
field's largest value and to each walker's, at most 4x the plain float32
reconstruction's own at the same inputs; two calls the same bits; one launch
a call.  The grid tiers on the card: one kernel launch a walker chunk, the
lnprob against the float64 tier's within 4x the float32 plain tier's gap.
The kernel's device time beside the plain float32 path's, behind a spin.
"""

import json
import math
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

import mcmc_dynamics_tpu_torch as tpkg
from mcmc_dynamics_tpu_torch import ops, profiling
from mcmc_dynamics_tpu_torch.models.jam import grid
from mcmc_dynamics_tpu_torch.models.jam.grid import JamGridSpec
from mcmc_dynamics_tpu_torch.ops import dispatch, jam_grid_kernel

SWITCH = dispatch.DISABLE_VARIABLE
ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "mcmc_dynamics_tpu_torch" / "csrc" / "jam_grid.cu"
TINY = dict(n_u=4, n_zeta=4, grid_orders=[8, 4])
JAM_CELL = "jam_axisymmetric_bh.mock16k_w64"
CHEMO_CELL = "jam_chemo_3pop.mock1e5_w128"
ERR_RATIO = 4.0


def _counts():
    c = profiling.counters()
    return c["jam.recon_kernel"], c["jam.recon_plain"]


def _spec(n_stars=300, n_r=20, n_phi=6, dtype=torch.float64, seed=0):
    rng = np.random.default_rng(seed)
    r = np.abs(rng.normal(0.0, 200.0, n_stars)) + 0.5
    phi = rng.uniform(-np.pi, np.pi, n_stars)
    return JamGridSpec.build(r * np.cos(phi), r * np.sin(phi), n_r=n_r, n_phi=n_phi,
                             dtype=dtype)


def _coefficients(W, n_r, n_phi, dtype=torch.float64, seed=1):
    """Coefficients of a smooth rotation fraction and log dispersion: falling
    with the order and the harmonic, log v2 about 5."""
    rng = np.random.default_rng(seed)
    fall = 1.0 / (1.0 + np.arange(n_r))[:, None] / (1.0 + np.arange(n_phi))[None, :]
    c1 = 0.3 * rng.normal(size=(W, n_r, n_phi)) * fall
    c2 = 0.5 * rng.normal(size=(W, n_r, n_phi)) * fall
    c2[:, 0, 0] += 5.0
    return (torch.as_tensor(c1, dtype=dtype), torch.as_tensor(c2, dtype=dtype))


def _old_tail(spec, c1, c2, theta0, floor):
    """The tail of ``jam_grid_moments`` before the kernel, as it was."""
    theta0 = torch.as_tensor(theta0, dtype=c1.dtype, device=c1.device).reshape(-1, 1, 1)
    co, so = torch.cos(spec.mult_odd * theta0), torch.sin(spec.mult_odd * theta0)
    ce, se = torch.cos(spec.mult_even * theta0), torch.sin(spec.mult_even * theta0)
    h1 = torch.matmul(spec.t_star, c1)
    h2 = torch.matmul(spec.t_star, c2)
    w = torch.sum(h1 * (spec.cos_odd * co + spec.sin_odd * so), dim=-1)
    v2f = torch.exp(torch.sum(h2 * (spec.cos_even * ce + spec.sin_even * se), dim=-1))
    vz = w * torch.sqrt(v2f)
    return vz, v2f - floor


# ------------------------------------------------------------------- the CPU
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("theta0", ["walkers", "column", "number"])
def test_cpu_wrapper_is_the_old_tail(dtype, theta0):
    """CPU tensors: the wrapper's (vz, v2zz) are the old tail's bit for bit;
    it counts one plain call and launches nothing."""
    spec = _spec(dtype=dtype)
    c1, c2 = (c.to(dtype) for c in _coefficients(5, spec.n_r, spec.n_phi))
    th = {"walkers": torch.linspace(-3.0, 3.0, 5, dtype=dtype),
          "column": torch.linspace(-1.0, 2.0, 5, dtype=dtype)[:, None],
          "number": 0.7}[theta0]
    launches, before = ops.JAM_GRID_RECONSTRUCT.launches, _counts()
    got = ops.jam_grid_reconstruct(spec, c1, c2, th, 1e-3)
    want = _old_tail(spec, c1, c2, th, 1e-3)
    for g, w in zip(got, want):
        assert g.shape == (5, 300) and torch.equal(g, w)
    assert ops.JAM_GRID_RECONSTRUCT.launches == launches
    assert _counts() == (before[0], before[1] + 1)


def test_grid_moments_are_the_old_ones():
    """``jam_grid_moments`` on the CPU: the engine's grid values through the
    transform and the plain reconstruction, bit for bit the old function's
    (the transform unchanged, the tail moved)."""
    spec = _spec(n_r=8, n_phi=4)
    rng = np.random.default_rng(5)
    G = spec.x_grid.numel()
    vz_g = torch.as_tensor(rng.normal(0.0, 3.0, (3, G)))
    v2_g = torch.as_tensor(rng.uniform(50.0, 150.0, (3, G)))
    valid = torch.tensor([True, False, True])
    theta0 = torch.as_tensor(rng.uniform(-2.0, 2.0, (3, 1)))
    floor = 0.25
    got = grid.jam_grid_moments(spec, lambda x, y: (vz_g, v2_g, valid), theta0, floor)
    v2_safe = (torch.clamp(v2_g, min=0.0) + floor).reshape(3, 8, 4)
    wg = vz_g.reshape(3, 8, 4) * torch.rsqrt(v2_safe)
    c1 = torch.matmul(spec.dct_r, torch.matmul(wg, spec.dct_odd.T))
    c2 = torch.matmul(spec.dct_r, torch.matmul(torch.log(v2_safe), spec.dct_even.T))
    want = _old_tail(spec, c1, c2, theta0, floor)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] is valid


def _kernel_constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, name
    return int(m.group(1))


def _emulated(spec, c1, c2, theta0, floor):
    """The kernel's order of work in float64: passes of ``kK`` harmonics over
    every radial order, each pass's harmonic sums added to the last, then
    exp and sqrt."""
    kK = _kernel_constant("kK")
    W, n_r, n_phi = c1.shape
    th = torch.as_tensor(theta0, dtype=c1.dtype).reshape(-1, 1, 1)
    sums = [torch.zeros(W, spec.t_star.shape[0], dtype=c1.dtype) for _ in range(2)]
    sets = ((c1, spec.cos_odd, spec.sin_odd, spec.mult_odd),
            (c2, spec.cos_even, spec.sin_even, spec.mult_even))
    for k0 in range(0, n_phi, kK):
        ks = slice(k0, min(k0 + kK, n_phi))
        for h, (c, cs, sn, mult) in enumerate(sets):
            acc = torch.einsum("nd,wdk->wnk", spec.t_star, c[:, :, ks])
            co, so = torch.cos(mult[ks] * th), torch.sin(mult[ks] * th)
            sums[h] = sums[h] + torch.sum(acc * (cs[:, ks] * co + sn[:, ks] * so), dim=-1)
    v2f = torch.exp(sums[1])
    return sums[0] * torch.sqrt(v2f), v2f - floor


@pytest.mark.parametrize("n_r, n_phi", [(20, 6), (40, 12), (37, 16), (16, 25)])
def test_kernel_order_of_work(n_r, n_phi):
    """Passes of ``kK`` harmonics (one at n_phi <= 12, two at 16, three at
    25), ragged radial orders: the same function as the plain version, in
    float64 within 1e-12 of each field's largest value."""
    spec = _spec(n_r=n_r, n_phi=n_phi)
    c1, c2 = _coefficients(4, n_r, n_phi)
    theta0 = torch.linspace(-2.5, 2.5, 4)[:, None]
    got = _emulated(spec, c1, c2, theta0, 1e-3)
    want = jam_grid_kernel.jam_grid_reconstruct_plain(spec, c1, c2, theta0, 1e-3)
    for g, w in zip(got, want):
        assert float((g - w).abs().max() / w.abs().max()) < 1e-12


def test_launcher_argument():
    """The launcher's argument as ``_pack`` lays it out (on the CPU, the
    kernel's device forced there): each tensor's pointer and strides (0
    along an axis of one), theta0's value where it is a number, a star slice
    through its strides, the shapes; float64 and mismatched shapes refused."""
    cpu = torch.device("cpu")
    spec = JamGridSpec(*(v.to(torch.float32) if torch.is_tensor(v) else v
                         for v in _spec(n_stars=50)))
    c1, c2 = (c.to(torch.float32) for c in _coefficients(3, spec.n_r, spec.n_phi))
    packed, (vz, v2zz), kept = jam_grid_kernel._pack(cpu, spec, c1, c2, 0.5, 1e-3)
    f = {name: packed.f[i] for i, name in enumerate(jam_grid_kernel._FIELDS)}
    assert (packed.W, packed.N, packed.n_r, packed.n_phi) == (3, 50, 20, 6)
    assert packed.floor == pytest.approx(1e-3)
    assert vz.shape == v2zz.shape == (3, 50)
    assert f["theta0"].ptr is None and f["theta0"].value == pytest.approx(0.5)
    assert (f["c1"].s0, f["c1"].s1, f["c1"].s2) == (120, 6, 1)
    assert (f["t_star"].ptr, f["t_star"].s0, f["t_star"].s1) == (
        spec.t_star.data_ptr(), 20, 1)
    assert (f["mult_odd"].s0, f["cos_even"].s0, f["cos_even"].s1) == (1, 6, 1)
    # a star slice, as the sharded partial tier passes it
    part = spec._replace(**{n: getattr(spec, n)[10:30] for n in jam_grid_kernel._STARS})
    packed, _, _ = jam_grid_kernel._pack(cpu, part, c1, c2, torch.zeros(3, 1), 1e-3)
    t = packed.f[jam_grid_kernel._FIELDS.index("t_star")]
    assert packed.N == 20 and t.ptr == spec.t_star.data_ptr() + 10 * 20 * 4
    th = packed.f[jam_grid_kernel._FIELDS.index("theta0")]
    assert th.ptr is not None and th.s0 == 1
    one = jam_grid_kernel._pack(cpu, spec, c1, c2, torch.zeros(1), 1e-3)[0]
    assert one.f[jam_grid_kernel._FIELDS.index("theta0")].s0 == 0
    with pytest.raises(TypeError, match="float32"):
        jam_grid_kernel._pack(cpu, spec, c1.double(), c2, 0.0, 1e-3)
    with pytest.raises(ValueError, match="theta0"):
        jam_grid_kernel._pack(cpu, spec, c1, c2, torch.zeros(2), 1e-3)
    with pytest.raises(ValueError, match="t_star"):
        jam_grid_kernel._pack(cpu, spec._replace(t_star=spec.t_star[:, :5]), c1, c2,
                              0.0, 1e-3)


def _build(cell, catalog, device, dtype):
    """The cell's fit in ``dtype`` by its own builder (Axisymmetric's builder
    takes no dtype: the class is handed it)."""
    if cell.spec["config"] == "jam_chemo_3pop":
        return cell.builder.build(cell.config, catalog, device, 5, dtype=dtype)
    real = tpkg.Axisymmetric

    class InDtype(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, dtype=dtype, **kwargs)

    tpkg.Axisymmetric = InDtype
    try:
        return cell.builder.build(cell.config, catalog, device, 5)
    finally:
        tpkg.Axisymmetric = real


def _cell(name, n_stars, dtype):
    """A benchmark cell's fit on the CPU at a test's size: its catalog maker
    and builder, ``n_stars`` stars, tiny orders, the grid tier, walker chunks
    of 2; four of its initial walkers."""
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    cell = harness.Cell(name, overrides={
        "catalog": {"n_stars": n_stars},
        "config": {"engine": dict(TINY, grid_min_stars=100)}})
    catalog = cell.maker.make(cell.spec["catalog"], 3, cell.config, "cpu")
    fit = _build(cell, catalog, "cpu", dtype)
    fit.jam_grid_chunk = 2
    assert fit.lnprob_tier() == "grid" and fit.dtype == dtype
    return fit, torch.as_tensor(cell.initials(3, 0)[0][:4], dtype=dtype)


@pytest.fixture
def stand_in(monkeypatch):
    """Counts the calls of the kernel's wrapper that ``jam_grid_moments``
    binds (the stand-in runs the real wrapper: on the CPU, the plain
    version), by the coefficients' shape."""
    calls = []
    real = grid.jam_grid_reconstruct

    def counting(spec, c1, *args):
        calls.append(tuple(c1.shape))
        return real(spec, c1, *args)

    monkeypatch.setattr(grid, "jam_grid_reconstruct", counting)
    return calls


MODELS = {"Axisymmetric": JAM_CELL, "ChemoProfiles": CHEMO_CELL}


@pytest.mark.parametrize("route", ["cpu", "float64", "switch"])
@pytest.mark.parametrize("model", list(MODELS))
def test_plain_paths_bind_the_plain_reconstruction(route, model, monkeypatch, stand_in):
    """The CPU device, float64 (on a forced kernel device) and the switch
    bind the plain reconstruction in the grid tier and the grid partial:
    the kernel's wrapper is never called, and each walker chunk adds one
    plain call."""
    monkeypatch.delenv(SWITCH, raising=False)
    if route != "cpu":
        monkeypatch.setattr(dispatch, "KERNEL_DEVICE", "cpu")
    if route == "switch":
        monkeypatch.setenv(SWITCH, "1")
    fit, thetas = _cell(MODELS[model], 120,
                        torch.float64 if route == "float64" else torch.float32)
    before = _counts()
    got = fit.batched_lnprob()(thetas)
    assert got.shape == (4,) and torch.isfinite(got).all()
    local = fit.sharded_star_data()
    local["mask"] = torch.ones(fit.n_data, dtype=fit.dtype)
    fit._partial_tier_cached()(thetas, local)
    assert stand_in == []
    assert _counts() == (before[0], before[1] + 4)


@pytest.mark.parametrize("model", list(MODELS))
def test_kernel_predicate_binds_the_reconstruction_kernel(model, monkeypatch, stand_in):
    """With ``ops.use_kernel`` forced true on the CPU, the grid tier and the
    grid partial call the kernel's wrapper once a walker chunk, on the
    chunk's walkers (walker-populations for ChemoProfiles); on the CPU it
    runs the plain version, so the values are the switch's bit for bit."""
    monkeypatch.delenv(SWITCH, raising=False)
    monkeypatch.setattr(dispatch, "KERNEL_DEVICE", "cpu")
    fit, thetas = _cell(MODELS[model], 120, torch.float32)
    got = fit.batched_lnprob()(thetas)
    rows = 2 * (3 if model == "ChemoProfiles" else 1)
    shape = (rows, *TINY["grid_orders"])
    assert stand_in == [shape] * 2
    local = fit.sharded_star_data()
    local["mask"] = torch.ones(fit.n_data, dtype=fit.dtype)
    fit._partial_tier_cached()(thetas, local)
    assert stand_in == [shape] * 4
    monkeypatch.setenv(SWITCH, "1")
    torch.testing.assert_close(fit.batched_lnprob()(thetas), got, rtol=0, atol=0)
    assert len(stand_in) == 4


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _capture(name, n_walkers, overrides=None, seed=7):
    """The arguments a benchmark cell's grid tier hands the reconstruction
    for one walker chunk of ``n_walkers`` of the cell's initials, built on
    the card in float32: (spec, c1, c2, theta0, floor)."""
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    cell = harness.Cell(name, overrides=overrides)
    catalog = cell.maker.make(cell.spec["catalog"], seed, cell.config, "cuda")
    fit = cell.builder.build(cell.config, catalog, "cuda", seed)
    assert fit.lnprob_tier() == "grid" and fit.dtype == torch.float32
    seen, real = [], grid.jam_grid_reconstruct

    def capture(*args):
        seen.append(args)
        return real(*args)

    fit.jam_grid_chunk = n_walkers
    grid.jam_grid_reconstruct = capture
    try:
        thetas = cell.initials(seed, 0)[0][:n_walkers]
        fit.batched_lnprob()(torch.as_tensor(thetas, dtype=torch.float32, device="cuda"))
    finally:
        grid.jam_grid_reconstruct = real
    assert len(seen) == 1
    return seen[0]


def _double(spec):
    return spec._replace(**{k: v.double() for k, v in spec._asdict().items()
                            if torch.is_tensor(v)})


def _errors(got, plain, want):
    """Each field's largest error against float64 (over the stars where it
    is finite), relative to the field's largest value and to each walker's:
    the kernel's and the plain float32 version's."""
    out = {}
    for name, g, p, w in zip(("vz", "v2zz"), got, plain, want):
        ok = torch.isfinite(w)
        assert bool(torch.isfinite(g[ok]).all()) and bool(torch.isfinite(p[ok]).all())
        g, p = g.double().where(ok, w), p.double().where(ok, w)
        scale = w.where(ok, 0.0).abs()
        walker = scale.amax(dim=1, keepdim=True).clamp(min=1e-300)
        out[name] = dict(field=float((g - w).abs().max() / scale.max()),
                         field_plain=float((p - w).abs().max() / scale.max()),
                         walker=float(((g - w).abs() / walker).max()),
                         walker_plain=float(((p - w).abs() / walker).max()))
    return out


CARD_CASES = {
    "JAM cells 32 x 16384": dict(name=JAM_CELL, n_walkers=32),
    "chemo 96 x 20000": dict(name=CHEMO_CELL, n_walkers=32,
                             overrides={"catalog": {"n_stars": 20000}}),
    "ragged 29 x 16307": dict(name=JAM_CELL, n_walkers=32, walkers=29, stars=16307),
    "star slice 1000-9001": dict(name=JAM_CELL, n_walkers=32, star_slice=(1000, 9001)),
    "orders 40 x 16": dict(name=JAM_CELL, n_walkers=32, overrides={
        "config": {"engine": {"grid_orders": [40, 16]}}}),
    "orders 36 x 7": dict(name=JAM_CELL, n_walkers=32, overrides={
        "config": {"engine": {"grid_orders": [36, 7]}}}),
    "strided (4-byte copies)": dict(name=JAM_CELL, n_walkers=32, strided=True),
}


def _column_major(t):
    """``t``'s values with its last two axes' strides swapped: the layout the
    kernel's 16-byte copies do not take."""
    return t.transpose(-1, -2).contiguous().transpose(-1, -2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_against_the_plain_reconstruction(case, cuda_device):
    spec = dict(CARD_CASES[case])
    assert not torch.backends.cuda.matmul.allow_tf32
    gspec, c1, c2, theta0, floor = _capture(spec["name"], spec["n_walkers"],
                                            spec.get("overrides"))
    if "walkers" in spec:
        W = spec["walkers"]
        c1, c2 = c1[:W], c2[:W]
        theta0 = theta0[:W] if torch.is_tensor(theta0) else theta0
    if "stars" in spec:
        gspec = gspec._replace(**{n: getattr(gspec, n)[:spec["stars"]]
                                  for n in jam_grid_kernel._STARS})
    if "star_slice" in spec:
        lo, hi = spec["star_slice"]
        gspec = gspec._replace(**{n: getattr(gspec, n)[lo:hi]
                                  for n in jam_grid_kernel._STARS})
    if spec.get("strided"):
        gspec = gspec._replace(**{n: _column_major(getattr(gspec, n))
                                  for n in jam_grid_kernel._STARS})
        c1, c2 = _column_major(c1), _column_major(c2)
        assert gspec.t_star.stride() == (1, gspec.t_star.shape[0])
    if spec["name"] == JAM_CELL:
        assert torch.is_tensor(theta0) and float(theta0.std()) > 0.0
    else:
        assert theta0 == 0.0
    th64 = theta0.double() if torch.is_tensor(theta0) else theta0
    want = jam_grid_kernel.jam_grid_reconstruct_plain(_double(gspec), c1.double(),
                                                      c2.double(), th64, floor)
    plain = jam_grid_kernel.jam_grid_reconstruct_plain(gspec, c1, c2, theta0, floor)
    launches, before = ops.JAM_GRID_RECONSTRUCT.launches, _counts()
    got = ops.jam_grid_reconstruct(gspec, c1, c2, theta0, floor)
    again = ops.jam_grid_reconstruct(gspec, c1, c2, theta0, floor)
    torch.cuda.synchronize()
    assert ops.JAM_GRID_RECONSTRUCT.launches == launches + 2
    assert _counts() == (before[0] + 2, before[1])
    assert got[0].shape == (c1.shape[0], gspec.t_star.shape[0])
    for g, a in zip(got, again):
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))
    errs = _errors(got, plain, want)
    print(json.dumps({"case": case, "errors": errs}))
    for name, e in errs.items():
        for m in ("field", "walker"):
            assert e[m] <= ERR_RATIO * e[m + "_plain"], (name, m, e)


@pytest.mark.cuda
@pytest.mark.parametrize("model", list(MODELS))
def test_grid_tiers_launch_the_kernel(model, cuda_device, monkeypatch):
    """The grid tier on the card (the cell's orders, 4096 stars, 64 walkers
    in chunks of 32): one reconstruction launch a walker chunk, no plain
    call; the lnprob against the float64 tier's within 4x the float32 plain
    tier's (the switch) own gap."""
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    monkeypatch.delenv(SWITCH, raising=False)
    cell = harness.Cell(MODELS[model], overrides={"catalog": {"n_stars": 4096}})
    catalog = cell.maker.make(cell.spec["catalog"], 3, cell.config, cuda_device)
    thetas = cell.initials(3, 0)[0][:64]

    def lnprob(dtype, plain=False):
        fit = _build(cell, catalog, cuda_device, dtype)
        assert fit.lnprob_tier() == "grid" and fit.dtype == dtype
        if plain:
            monkeypatch.setenv(SWITCH, "1")
        try:
            before = _counts()
            out = fit.batched_lnprob()(torch.as_tensor(thetas, dtype=dtype,
                                                       device=cuda_device))
            torch.cuda.synchronize()
            after = _counts()
        finally:
            monkeypatch.delenv(SWITCH, raising=False)
        return out.double(), (after[0] - before[0], after[1] - before[1])

    got, counts = lnprob(torch.float32)
    assert counts == (2, 0)
    want, _ = lnprob(torch.float64)
    plain, plain_counts = lnprob(torch.float32, plain=True)
    assert plain_counts == (0, 2)
    assert torch.isfinite(want).all()
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert float((got - want).abs().max()) <= ERR_RATIO * float((plain - want).abs().max())


def _device_ms(fn, n=20, repeats=5):
    """Device ms of a call of ``fn``: CUDA events around ``n`` calls launched
    back to back behind a spin kernel (~50 ms), so that the events time the
    device alone; the median of ``repeats`` such runs, after two warm-up
    calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


@pytest.mark.cuda
def test_reconstruction_kernel_timing(cuda_device):
    """The kernel at the chemo cell's chunk (96 walker-populations x 1e5
    stars) and the JAM cells' (32 x 16384), n_r 128, n_phi 12: its device ms
    beside the plain float32 reconstruction's and the bound from
    ``configs/*.py:work``'s count (4 N n_r n_phi operations a walker at 67
    TFLOP/s) printed; the kernel under half the plain path's time."""
    out = {}
    for label, W, N in (("chemo chunk", 96, 100_000), ("JAM cells chunk", 32, 16384)):
        spec = _spec(n_stars=N, n_r=128, n_phi=12, dtype=torch.float32, seed=2)
        spec = spec._replace(**{k: v.to(cuda_device) for k, v in spec._asdict().items()
                                if torch.is_tensor(v)})
        c1, c2 = (c.to(torch.float32).to(cuda_device) for c in _coefficients(W, 128, 12))
        theta0 = torch.linspace(-1.0, 1.0, W, device=cuda_device)[:, None]
        ms = _device_ms(lambda: ops.jam_grid_reconstruct(spec, c1, c2, theta0, 1e-3))
        plain_ms = _device_ms(lambda: jam_grid_kernel.jam_grid_reconstruct_plain(
            spec, c1, c2, theta0, 1e-3), n=5, repeats=3)
        bound_ms = 4.0 * W * N * 128 * 12 / 67e12 * 1e3
        out[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          roofline=100.0 * bound_ms / ms)
        assert ms < 0.5 * plain_ms, (label, ms, plain_ms)
        assert math.isfinite(ms)
    print(json.dumps({"jam_grid_reconstruct_ms": out,
                      "device": torch.cuda.get_device_name(0)}))
