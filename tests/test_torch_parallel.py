"""The port's multi-device samplers (``mcmc_dynamics_tpu_torch/parallel/``)
against the JAX package's and against the port's single-device runs.

The port runs one process (rank) a device, so the multi-rank checks spawn
worlds of 2-4 CPU ranks over gloo: each rank is this file run as
``python tests/test_torch_parallel.py --worker <scenario> <rank> <world>
<dir>`` (it never loads ``tests/conftest.py``, so never JAX), meets the others
through a rendezvous file in ``<dir>`` and writes its results to
``<dir>/<scenario>_<rank>.npz``.  A world has its own time limit
(``WORLD_TIMEOUT_S``); a rank that raises exits non-zero, the others are
killed at once and the test fails with the ranks' output.  The JAX side runs
in the pytest process on conftest's 8-device virtual mesh.

Gates (float64 on the CPU): the star-sharded lnprob at rel 1e-12 of the JAX
package's and of the port's unsharded lnprob; every partial tier on every
padded slice at rel 1e-10 of the JAX kernel (Pallas in interpret mode, the
JAM grid through the JAX model's terms); a run sharded over walkers alone,
checkpoint resume, the chunked tempered ladder and the sharded binned fit bit
for bit; every rank's chain identical; posterior medians and the evidence
within the bands of ``tests/test_parallel.py`` and ``tests/test_tempered.py``.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
RA_C, DEC_C = 56.345, -26.675
WORLD_TIMEOUT_S = 120
MOVES = {"stretch": "stretch", "de": "de", "snooker": "snooker",
         "mixture": (("stretch", 0.5), ("de", 0.3), ("snooker", 0.2))}
TEMPERED = dict(n_walkers=16, swap_every=2, beta_min=1e-3)
TEMPERED_RESUME = (25, 35)
TEMPERED_LONG = dict(n_walkers=32, n_steps=800)
DPSP_STEPS = 300


# ------------------------------------------------------------------ catalogs
def _columns(n, seed):
    rng = np.random.default_rng(seed)
    return {"ra": (RA_C + 0.03 * rng.normal(size=n), "deg"),
            "dec": (DEC_C + 0.03 * rng.normal(size=n), "deg"),
            "v": (5.0 * rng.normal(size=n), "km/s"),
            "verr": (0.5 + 0.5 * rng.random(n), "km/s")}


def _edit(p, cls_name):
    """The parameters both packages use: the centre fixed, initials inside
    the posterior's reach (a and r_peak in arcsec)."""
    p["ra_center"].set(value=RA_C, fixed=True)
    p["dec_center"].set(value=DEC_C, fixed=True)
    if cls_name == "ModelFit":
        p["sigma_max"].set(initials="rng.uniform(3, 7, size=n)")
        p["a"].set(initials="rng.uniform(60, 200, size=n)")
        p["r_peak"].set(initials="rng.uniform(60, 200, size=n)")
    else:
        p["sigma_max"].set(max=100.0)
    return p


def _fit(pkg_name, cls_name, n, seed, fit_seed=3):
    """``cls_name`` of the port (``"port"``, on the CPU) or of the JAX
    package (``"jax"``) on the catalog ``_columns(n, seed)``."""
    if pkg_name == "port":
        from mcmc_dynamics_tpu_torch import DataReader, models, units
        kw = {"device": "cpu"}
    else:
        from mcmc_dynamics_tpu import models, units
        from mcmc_dynamics_tpu.utils import DataReader
        kw = {}
    cls = getattr(models, cls_name)
    data = DataReader({k: units.Quantity(*c) for k, c in _columns(n, seed).items()})
    return cls(data, parameters=_edit(cls.default_parameters(), cls_name),
               seed=fit_seed, **kw)


def _sp_thetas():
    """ConstantFit walkers (v_sys, sigma_max, v_maxx, v_maxy); the last one
    outside the prior (sigma_max < 0)."""
    return np.array([[1.0, 6.0, 2.0, -1.0], [0.3, 5.0, 0.1, 0.4],
                     [-0.5, 4.5, -1.0, 0.0], [0.0, -3.0, 0.0, 0.0]])


# ------------------------------------------------------------------ the workers
def _world_mesh4(rank, out):
    """Four ranks: the star-sharded lnprob (sp 4), walker-only runs (dp 4)
    against the single-device sampler for every move, a dp 2 x sp 2 run,
    the Runner API on both meshes (checkpoints, resume, convergence) and the
    tempered ladder (tp 4)."""
    from mcmc_dynamics_tpu_torch.parallel import (make_mesh, run_ensemble_sharded,
                                                  star_sharded_lnprob)
    from mcmc_dynamics_tpu_torch.parallel.tempered import swap_attempts
    from mcmc_dynamics_tpu_torch.sampler import init_state, make_generator, run_ensemble

    res = {}
    cfit = _fit("port", "ConstantFit", 333, 0)
    sp4 = make_mesh(("sp",), (4,), device="cpu")
    lnprob_sp = star_sharded_lnprob(cfit, sp4)
    res["sp_lnp"] = lnprob_sp(_sp_thetas()).numpy()
    res["sp_lnp_one"] = np.array([float(lnprob_sp(_sp_thetas()[0]))])
    res["sp_unsharded"] = np.array([float(cfit.lnprob(t)) for t in _sp_thetas()])

    fit = _fit("port", "ModelFit", 200, 1)
    assert fit.lnprob_tier() == "direct"
    dp4 = make_mesh(("dp", "sp"), (4, 1), device="cpu")
    pos = fit.get_initials(32)
    lnprob = fit.batched_lnprob()
    for label, move in MOVES.items():
        got = run_ensemble_sharded(fit, pos, make_generator(7, "cpu"), 15, dp4, move=move)
        ref = run_ensemble(lnprob, init_state(lnprob, fit._to_device(pos),
                                              make_generator(7, "cpu")), 15, move=move)
        for a, b in ((got.chain, ref.chain), (got.log_prob, ref.log_prob),
                     (got.final_coords, ref.final.coords),
                     (got.accepted, ref.final.accepted)):
            assert torch.equal(a, b), f"dp 4 x sp 1, move {label}: not bitwise"
        res[f"dp4_{label}"] = got.chain.numpy()
    try:
        run_ensemble_sharded(fit, pos[:30], make_generator(7, "cpu"), 1, dp4)
        res["walker_count_error"] = np.array([0])
    except ValueError as err:
        res["walker_count_error"] = np.array(["multiple of 2*dp" in str(err)])

    dpsp = make_mesh(("dp", "sp"), (2, 2), device="cpu")
    assert fit._partial_tier_cached() is not None
    run = run_ensemble_sharded(fit, fit.get_initials(64), make_generator(3, "cpu"),
                               DPSP_STEPS, dpsp)
    res["dpsp_chain"] = run.chain.numpy()
    res["dpsp_lnp"] = run.log_prob.numpy()
    res["dpsp_acceptance"] = run.acceptance_fraction.numpy()
    res["dpsp_lnprob_last"] = lnprob(run.chain[:, -1]).numpy()

    # the Runner API: gathered chunks (prefix None) and shard checkpoints
    pos16 = fit.get_initials(16)
    kw = dict(n_walkers=16, pos=pos16, seed=5, n_burn=0)
    gathered = fit(n_steps=12, n_out=6, prefix=None, mesh=dpsp, **kw)
    ckpt = str(out / "ck")
    sharded = fit(n_steps=12, n_out=6, prefix=ckpt, mesh=dpsp, **kw)
    assert np.array_equal(gathered.chain, sharded.chain)
    assert np.array_equal(fit.read_chain(ckpt + "_chain.npz"), sharded.chain)
    res["runner_chain"] = sharded.chain
    res["runner_acceptance"] = sharded.acceptance_fraction
    try:
        fit(n_steps=4, thin=2, prefix=None, mesh=dpsp, **kw)
        res["thin_rejected"] = np.array([False])
    except NotImplementedError:
        res["thin_rejected"] = np.array([True])
    whole = fit(n_steps=18, n_out=6, prefix=None, mesh=dpsp, **kw)
    resumed = fit(n_steps=6, n_burn=0, state=fit.load_state(ckpt + "_chain.npz"),
                  prefix=None, mesh=dpsp)
    assert np.array_equal(resumed.chain, whole.chain[:, 12:]), "sharded resume"
    assert torch.equal(resumed.final_state.coords, whole.final_state.coords)
    assert np.array_equal(resumed.final_state.accepted.numpy(),
                          whole.final_state.accepted.numpy())
    # walkers alone: the single-device run, and a single-device checkpoint
    # resumed on the mesh (the generator state is the whole of the draws)
    single = fit(n_steps=18, prefix=None, **kw)
    on_dp4 = fit(n_steps=18, n_out=9, prefix=None, mesh=dp4, **kw)
    assert np.array_equal(single.chain, on_dp4.chain), "dp 4: fit(...) not bitwise"
    assert np.array_equal(single.acceptance_fraction, on_dp4.acceptance_fraction)
    fit(n_steps=12, n_out=12, prefix=str(out / "single"), **kw)
    across = fit(n_steps=6, n_burn=0, state=fit.load_state(str(out / "single_chain.npz")),
                 prefix=None, mesh=dp4)
    assert np.array_equal(across.chain, single.chain[:, 12:]), "resume across extents"
    conv_kw = dict(n_walkers=16, pos=pos16, seed=5, max_steps=100, check_every=50)
    conv = fit.sample_to_convergence(mesh=dp4, **conv_kw)
    conv_single = fit.sample_to_convergence(**conv_kw)
    assert np.array_equal(conv.chain, conv_single.chain)
    assert np.array_equal(conv.tau, conv_single.tau)
    res["conv_chain"] = conv.chain
    best = fit.compute_bestfit_values(sharded.chain, n_burn=6)
    res["bestfit"] = np.array([best.value(n)[0] for n in fit.fitted_parameters])

    # the tempered ladder, one temperature a rank
    tfit = _fit("port", "ConstantFit", 150, 4, fit_seed=0)
    tp4 = make_mesh(("tp",), (4,), device="cpu")
    tpos = tfit.get_initials(TEMPERED["n_walkers"])
    tkw = dict(pos=tpos, seed=3, **TEMPERED)
    whole, lnz = tfit.sample_tempered(n_steps=sum(TEMPERED_RESUME), mesh=tp4, **tkw)
    first, _ = tfit.sample_tempered(n_steps=TEMPERED_RESUME[0], mesh=tp4, **tkw)
    second, _ = tfit.sample_tempered(n_steps=TEMPERED_RESUME[1], mesh=tp4,
                                     state=first.final_state, **tkw)
    assert np.array_equal(whole.chain, np.concatenate([first.chain, second.chain], 1))
    assert torch.equal(whole.final_state.coords, second.final_state.coords)
    assert torch.equal(whole.final_state.swaps_accepted,
                       second.final_state.swaps_accepted)
    res["tempered_chain"] = whole.chain
    res["tempered_swaps"] = whole.final_state.swaps_accepted.numpy() / swap_attempts(
        4, TEMPERED["n_walkers"], TEMPERED["swap_every"], 0, sum(TEMPERED_RESUME))
    res["tempered_levels"] = whole.final_state.coords.numpy()
    try:
        tfit.sample_tempered(n_steps=2, mesh=dp4, **tkw)
        res["no_tp_rejected"] = np.array([False])
    except ValueError as err:
        res["no_tp_rejected"] = np.array(["'tp'" in str(err)])
    long, lnz_long = tfit.sample_tempered(mesh=tp4, seed=1, beta_min=1e-3,
                                          swap_every=5, **TEMPERED_LONG)
    res["tempered_long"] = long.chain
    res["tempered_long_lnp"] = long.lnprobability
    res["tempered_lnz"] = np.array([lnz_long])
    np.savez(out / f"mesh4_{rank}.npz", **res)


def _world_two(rank, out):
    """Two ranks: the checkpoint probe, the shard checkpoint against the
    gathered run, and the binned fit with its bins over dp 2."""
    from mcmc_dynamics_tpu_torch import units as u
    from mcmc_dynamics_tpu_torch.parallel import distributed as pdist
    from mcmc_dynamics_tpu_torch.parallel import make_mesh
    from mcmc_dynamics_tpu_torch.pipelines import fit_radial_bins
    from mcmc_dynamics_tpu_torch.utils import DataReader

    res = {"shared": np.array([pdist.checkpoint_dir_is_shared(str(out / "probe"))]),
           "primary": np.array([pdist.is_primary()])}
    dp2 = make_mesh(("dp",), (2,), device="cpu")
    fit = _fit("port", "ConstantFit", 120, 6)
    kw = dict(n_walkers=8, pos=fit.get_initials(8), seed=2, n_burn=0)
    gathered = fit(n_steps=10, n_out=5, prefix=None, mesh=dp2, **kw)
    sharded = fit(n_steps=10, n_out=5, prefix=str(out / "shard"), mesh=dp2, **kw)
    assert not list(out.glob("shard_chain.shard*")), "shard files left behind"
    with np.load(out / "shard_chain.npz") as f:
        assert np.array_equal(f["chain"], gathered.chain)
        assert np.array_equal(f["lnprob"], gathered.lnprobability)
        assert np.array_equal(f["coords"], gathered.final_state.coords.numpy())
    res["shard_chain"] = sharded.chain

    columns = _columns(180, 8)
    bin_kw = dict(nstars=60, dlogr=0.01, n_walkers=8, n_steps=40, seed=4, device="cpu")

    def binned(mesh):
        data = DataReader({k: u.Quantity(*c) for k, c in columns.items()})
        return fit_radial_bins(data, u.Quantity(RA_C, "deg"), u.Quantity(DEC_C, "deg"),
                               mesh=mesh, **bin_kw)

    got, want = binned(dp2), binned(None)
    assert got.n_bins == 3, got.n_bins
    assert np.array_equal(got.chains, want.chains), "bins over dp 2: not bitwise"
    assert np.array_equal(got.log_probs, want.log_probs)
    res["bins_chains"] = got.chains
    np.savez(out / f"two_{rank}.npz", **res)


def _cli_config(out, prefix, axes, sampling, model="constant"):
    return {"prefix": str(out / prefix),
            "data": {"file": str(out / "catalog.csv"), "format": "csv"},
            "model": model,
            "parameters": {"ra_center": {"value": RA_C, "fixed": True},
                           "dec_center": {"value": DEC_C, "fixed": True},
                           "sigma_max": {"max": 100.0}},
            "sampling": dict({"n_walkers": 8, "n_steps": 20, "n_out": 10,
                              "n_burn": 5, "seed": 1}, **sampling),
            "parallel": {"axes": axes,
                         "distributed": {"coordinator": f"file://{out}/rendezvous_cli",
                                         "num_processes": 2, "process_id": None}}}


def _world_cli(rank, out):
    """Two ranks running ``cli.run`` with a ``distributed`` block: dp 2 (the
    ensemble) and tp 2 (the tempered ladder), then the configs it refuses."""
    from mcmc_dynamics_tpu_torch.cli.run import main

    def run(name, cfg, *extra):
        cfg["parallel"]["distributed"]["process_id"] = rank
        path = out / f"{name}_{rank}.json"
        path.write_text(json.dumps(cfg))
        return main([str(path), "--skip-binned", "--skip-profiles", "--device", "cpu",
                     *extra])

    assert run("dp", _cli_config(out, "cli_dp", {"dp": 2}, {})) == 0
    assert run("tp", _cli_config(out, "cli_tp", {"tp": 2},
                                 {"sampler": "tempered", "n_temps": 2, "beta_min": 0.1,
                                  "swap_every": 2})) == 0
    refused = []
    for axes, sampling, words in (({"dp": 4}, {}, "needs 4 ranks"),
                                  ({"dp": 2}, {"sampler": "hmc"}, "does not take"),
                                  ({"dp": 2}, {"sampler": "tempered"}, "'tp' axis")):
        try:
            run("bad", _cli_config(out, "cli_bad", axes, sampling))
            refused.append(False)
        except ValueError as err:
            refused.append(words in str(err))
    np.savez(out / f"cli_{rank}.npz", refused=np.array(refused))


_WORLDS = {"mesh4": _world_mesh4, "two": _world_two, "cli": _world_cli}


def _worker(argv):
    """Entry of one rank: ``--worker <scenario> <rank> <world> <dir>``."""
    scenario, rank, world, out = argv[0], int(argv[1]), int(argv[2]), pathlib.Path(argv[3])
    torch.set_num_threads(1)
    from mcmc_dynamics_tpu_torch.parallel import distributed as pdist

    if scenario != "cli":      # the CLI joins the world through its config
        pdist.initialize(f"file://{out}/rendezvous", num_processes=world,
                         process_id=rank, timeout_s=WORLD_TIMEOUT_S)
    try:
        _WORLDS[scenario](rank, out)
        pdist.barrier()          # every rank done with its collectives
    finally:
        pdist.shutdown()


def _spawn(scenario, n, out):
    """Run the world ``scenario`` of ``n`` ranks; fail on a rank's error or
    the time limit (killing every rank), with the ranks' output."""
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=str(REPO) + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    logs = [(out / f"{scenario}_{r}.out", out / f"{scenario}_{r}.err") for r in range(n)]
    procs = []
    for r, (o, e) in enumerate(logs):
        with open(o, "w") as fo, open(e, "w") as fe:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--worker", scenario, str(r), str(n), str(out)],
                cwd=out, env=env, stdout=fo, stderr=fe))
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    failed = None
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs):
            failed = "a rank failed"
            break
        if time.monotonic() > deadline:
            failed = f"the world ran past {WORLD_TIMEOUT_S} s"
            break
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    if failed is None and any(p.returncode for p in procs):
        failed = "a rank failed"
    if failed:
        report = "\n".join(f"--- rank {r} (rc {p.returncode}):\n{e.read_text()[-3000:]}"
                           for r, (p, (_o, e)) in enumerate(zip(procs, logs)))
        pytest.fail(f"world {scenario!r}: {failed}\n{report}")
    return [dict(np.load(out / f"{scenario}_{r}.npz", allow_pickle=False))
            for r in range(n)]


def _same_on_every_rank(ranks):
    for r, res in enumerate(ranks[1:], 1):
        for key, value in ranks[0].items():
            np.testing.assert_array_equal(res[key], value, err_msg=f"rank {r}: {key}")


@pytest.fixture(scope="module")
def mesh4(tmp_path_factory):
    return _spawn("mesh4", 4, tmp_path_factory.mktemp("mesh4"))


# ------------------------------------------------------------------ in-process
def test_no_process_group_is_single_process():
    import torch.distributed as dist

    from mcmc_dynamics_tpu_torch.parallel import distributed as pdist

    assert not dist.is_initialized()
    assert pdist.is_primary() and not pdist.is_distributed()
    pdist.barrier()
    assert isinstance(pdist.fetch(torch.ones(3)), np.ndarray)
    assert pdist.initialize() is False and not dist.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        pdist.initialize(num_processes=2)


def test_cuda_mesh_without_a_card_raises():
    from mcmc_dynamics_tpu_torch.parallel import make_mesh

    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh(("dp",), (1,), device="cuda")


def test_factorize_devices_matches_jax():
    from mcmc_dynamics_tpu.parallel.mesh import factorize_devices as jax_factorize
    from mcmc_dynamics_tpu_torch.parallel import factorize_devices

    for n, axes in ((8, 3), (12, 3), (7, 2), (8, 2), (4, 1), (16, 2), (6, 3)):
        assert factorize_devices(n, axes) == jax_factorize(n, axes)
    assert factorize_devices(8, 3) == (2, 2, 2)
    assert factorize_devices(12, 3) == (3, 2, 2)
    assert factorize_devices(7, 2) == (7, 1)


def test_pad_star_axis_matches_jax():
    """tests/test_parallel.py's case, and a padded catalog with a mask: the
    same columns and mask as the JAX package's."""
    import jax.numpy as jnp

    from mcmc_dynamics_tpu.parallel import pad_star_axis as jax_pad
    from mcmc_dynamics_tpu_torch.parallel import pad_star_axis

    padded = pad_star_axis({"v": torch.arange(10.0), "verr": torch.ones(10)}, 8)
    assert padded["v"].shape == (16,)
    assert float(padded["mask"].sum()) == 10.0
    rng = np.random.default_rng(0)
    data = {"v": rng.normal(size=13), "b": rng.normal(size=(13, 3)),
            "mask": (rng.random(13) > 0.3).astype(float)}
    got = pad_star_axis({k: torch.as_tensor(v) for k, v in data.items()}, 4)
    want = jax_pad({k: jnp.asarray(v) for k, v in data.items()}, 4)
    for k in data:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ------------------------------------------------------------------ partial tiers
def _partial_cases():
    return ["ModelFit", "ModelFit free centre", "ModelFitGB", "ModelFitConstantBackground",
            "ConstantFitGB", "DoubleModelFit", "DoubleModelFitGB", "Axisymmetric grid"]


def _partial_pair(case):
    """(JAX fit, port fit, walkers) of one partial tier's model."""
    if case == "Axisymmetric grid":
        from test_torch_jam_models import axisymmetric_params, build, catalog, draws
        jfit, tfit = build("Axisymmetric", axisymmetric_params(), catalog(n=301),
                           min_stars=100)
        # walker 0 outside the barq prior, walkers 1-2 with stars at
        # v2zz <= vz^2 (-inf on the slices that hold them)
        return jfit, tfit, draws(tfit.fitted_parameters, 8, seed=8)
    if case.startswith(("ModelFit", "ConstantFitGB")) and case not in (
            "ModelFitGB", "ModelFitConstantBackground"):
        from test_torch_mixtures import _pair, _thetas
        free = ("ra_center", "dec_center") if case.endswith("free centre") else ()
        jfit, tfit = _pair(case.split()[0], n_stars=241, free=free)
    else:
        from test_torch_model_mixtures import _pair, _thetas
        jfit, tfit = _pair(case, n_stars=233)
    return jfit, tfit, _thetas(tfit, 12, 4)


def _r_peak_zero(fit, thetas):
    """Walkers with a rotation peak radius at its prior's bound 0: the JAX
    package's forms give 0/0 = NaN there, the port's the limit (no
    rotation), finite (ROADMAP.md section 3)."""
    names = fit.fitted_parameters
    zero = np.zeros(len(thetas), bool)
    for name in ("r_peak", "r_peak_c"):
        if name in names:
            zero |= thetas[:, names.index(name)] == 0.0
    return zero


def _assert_against_jax(got, want, inside, zero):
    """Same finite pattern and rel 1e-10 on the walkers inside the prior,
    except the JAX package's NaN at r_peak = 0, where the port is finite."""
    assert not np.isnan(got[inside]).any()
    np.testing.assert_array_equal(np.isnan(want) & inside, zero & inside)
    both = inside & ~zero
    np.testing.assert_array_equal(np.isfinite(got[both]), np.isfinite(want[both]))
    ok = both & np.isfinite(want)
    assert ok.any()
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-10)


@pytest.mark.parametrize("case", _partial_cases())
def test_partial_tier_matches_jax_on_every_slice(case, monkeypatch):
    """Each partial tier on each of 4 padded star slices against the JAX
    package's (its Pallas kernels in interpret mode; the JAM grid through the
    JAX model's terms) at rel 1e-10, on the walkers inside the prior; the
    slices' sum plus the prior against the JAX package's full lnprob at rel
    1e-10 with the same -inf pattern (walkers at r_peak = 0 aside, where the
    JAX package gives NaN and the port the finite limit)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from mcmc_dynamics_tpu.parallel import pad_star_axis as jax_pad
    from mcmc_dynamics_tpu_torch.parallel import pad_star_axis

    jfit, tfit, thetas = _partial_pair(case)
    want_full = np.asarray(jfit.build_lnprob_batched()(jnp.asarray(thetas)))
    partial = tfit.build_lnlike_partial_batched()
    assert partial is not None, case
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jax_partial = jfit.build_lnlike_partial_batched()
    assert jax_partial is not None, case
    tdata = pad_star_axis(tfit.sharded_star_data(), 4)
    jdata = jax_pad(jfit.prepare_data(dict(jfit._data_arrays)), 4)
    n = tdata["mask"].shape[0] // 4
    inside = np.isfinite(tfit.compiled.lnprior(torch.as_tensor(thetas)).numpy())
    zero = _r_peak_zero(tfit, thetas)
    total = 0.0
    for c in range(4):
        tl = {k: v[c * n:(c + 1) * n] for k, v in tdata.items()}
        jl = {k: v[c * n:(c + 1) * n] for k, v in jdata.items()}
        got = partial(torch.as_tensor(thetas), tl).numpy()
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax_partial(jnp.asarray(thetas), jl))
        _assert_against_jax(got, want, inside, zero)
        total = total + got
    summed = tfit._with_prior(lambda t: torch.as_tensor(total))(
        torch.as_tensor(thetas)).numpy()
    assert not inside.all() and not np.isfinite(summed[~inside]).any()
    assert not np.isfinite(want_full[~inside]).any()
    _assert_against_jax(summed, want_full, inside, zero)


# ------------------------------------------------------------------ four ranks
def test_star_sharded_lnprob_matches_jax(mesh4):
    """sp 4 over 333 stars (padded to 336): rel 1e-12 of the JAX package's
    star_sharded_lnprob and of the port's unsharded lnprob; the walker out
    of the prior is -inf."""
    import jax
    import jax.numpy as jnp

    from mcmc_dynamics_tpu.parallel import make_mesh, star_sharded_lnprob

    res = mesh4[0]
    jfit = _fit("jax", "ConstantFit", 333, 0)
    sharded = star_sharded_lnprob(jfit, make_mesh(("sp",), (4,), devices=jax.devices()[:4]))
    want = np.array([float(sharded(jnp.asarray(t))) for t in _sp_thetas()])
    assert np.isneginf(want[-1]) and np.isneginf(res["sp_lnp"][-1])
    np.testing.assert_allclose(res["sp_lnp"][:-1], want[:-1], rtol=1e-12)
    np.testing.assert_allclose(res["sp_lnp"][:-1], res["sp_unsharded"][:-1], rtol=1e-12)
    assert res["sp_lnp_one"][0] == res["sp_lnp"][0]


def test_every_rank_holds_the_same_results(mesh4):
    """The ranks of a dp row hold the same walkers and take the same
    decisions: every result is the same bits on all four ranks."""
    _same_on_every_rank(mesh4)


def test_walker_sharded_runs(mesh4):
    """dp 4 x sp 1 equals the single-device run bit for bit for every move
    (asserted in the ranks; the four moves' chains differ); the walker-count
    check; dp 2 x sp 2: the recorded lnP equals the lnprob of the last
    coordinates at rel 1e-10, and the medians sit in tests/test_parallel.py's
    band around the JAX package's sharded run."""
    import jax

    from mcmc_dynamics_tpu.parallel import make_mesh, run_ensemble_sharded

    res = mesh4[0]
    chains = [res[f"dp4_{m}"] for m in MOVES]
    assert all(not np.array_equal(chains[0], c) for c in chains[1:])
    assert res["walker_count_error"][0]
    np.testing.assert_allclose(res["dpsp_lnp"][:, -1], res["dpsp_lnprob_last"], rtol=1e-10)
    acc = res["dpsp_acceptance"]
    assert np.all(acc > 0.1) and np.all(acc < 0.95)

    jfit = _fit("jax", "ModelFit", 200, 1)
    mesh = make_mesh(("dp", "sp"), (2, 2), devices=jax.devices()[:4])
    ref = np.asarray(run_ensemble_sharded(jfit, jfit.get_initials(64), jax.random.PRNGKey(0),
                                          n_steps=DPSP_STEPS, mesh=mesh).chain)
    k = ref.shape[-1]
    burn = DPSP_STEPS // 2
    got_med = np.median(res["dpsp_chain"][:, burn:, :].reshape(-1, k), axis=0)
    exp_med = np.median(ref[:, burn:, :].reshape(-1, k), axis=0)
    sd = ref[:, burn:, :].reshape(-1, k).std(axis=0)
    assert np.all(np.abs(got_med - exp_med) < 3 * sd / np.sqrt(50) + 0.3), (got_med, exp_med)


def test_runner_on_a_mesh(mesh4):
    """Runner.__call__(mesh=) with per-chunk checkpoints (shard files on the
    shared directory) equals the gathered run and read_chain, resumes bit for
    bit on dp 2 x sp 2 and across dp extents, rejects thin, and
    sample_to_convergence(mesh=) equals the single-device one (asserted in
    the ranks); the best-fit values are finite and the acceptance is the
    whole run's."""
    res = mesh4[0]
    assert res["thin_rejected"][0]
    assert res["runner_chain"].shape == (16, 12, 6)
    assert np.isfinite(res["bestfit"]).all()
    assert np.all(res["runner_acceptance"] >= 0) and res["runner_acceptance"].mean() > 0
    assert res["conv_chain"].shape[1] in (50, 100)


def test_tempered_ladder_on_a_mesh(mesh4):
    """tp 4: 25 + 35 steps through state= equal 60 (asserted in the ranks),
    a mesh without tp is refused, every pair swaps, and the cold chain and
    the evidence agree with the JAX package's single-device ladder within
    tests/test_tempered.py's bands."""
    res = mesh4[0]
    assert res["no_tp_rejected"][0]
    assert np.all(res["tempered_swaps"] > 0), res["tempered_swaps"]
    levels = res["tempered_levels"]
    assert not np.array_equal(levels[0], levels[1])

    jfit = _fit("jax", "ConstantFit", 150, 4, fit_seed=0)
    ref, lnz_ref = jfit.sample_tempered(n_temps=4, seed=1, beta_min=1e-3, swap_every=5,
                                        **TEMPERED_LONG)
    chain = res["tempered_long"]
    assert np.isfinite(res["tempered_long_lnp"]).all()
    for col in (0, 1):
        m_s = float(np.median(chain[:, 300:, col]))
        m_1 = float(np.median(ref.chain[:, 300:, col]))
        sd = float(np.std(ref.chain[:, 300:, col]))
        assert abs(m_s - m_1) < 0.5 * sd + 0.2, (col, m_s, m_1)
    lnz = float(res["tempered_lnz"][0])
    assert abs(lnz - lnz_ref) < 0.05 * abs(lnz_ref), (lnz, lnz_ref)


# ------------------------------------------------------------------ two ranks
def test_two_ranks_checkpoints_and_bins(tmp_path):
    """Two ranks: the checkpoint directory is shared, the shard checkpoint
    equals the gathered run bit for bit and leaves no shard file, the binned
    fit with its 3 bins over dp 2 (one bin of padding) equals the unsharded
    fit bit for bit (asserted in the ranks), and its medians agree with the
    JAX package's binned fit within tests/test_pipelines.py's spread."""
    from mcmc_dynamics_tpu import units as ju
    from mcmc_dynamics_tpu.pipelines import fit_radial_bins
    from mcmc_dynamics_tpu.utils import DataReader

    ranks = _spawn("two", 2, tmp_path)
    _same_on_every_rank([{k: v for k, v in r.items() if k != "primary"} for r in ranks])
    assert ranks[0]["shared"][0] and ranks[0]["primary"][0] and not ranks[1]["primary"][0]
    got = ranks[0]["bins_chains"]
    data = DataReader({k: ju.Quantity(*c) for k, c in _columns(180, 8).items()})
    want = fit_radial_bins(data, ju.Quantity(RA_C, "deg"), ju.Quantity(DEC_C, "deg"),
                           nstars=60, dlogr=0.01, n_walkers=8, n_steps=40, seed=4).chains
    want = np.asarray(want)
    assert want.shape == got.shape
    for b in range(got.shape[0]):
        m_got = np.median(got[b, :, 20:, 1])
        m_want = np.median(want[b, :, 20:, 1])
        sd = np.std(want[b, :, 20:, 1])
        assert abs(m_got - m_want) < 2.0 * sd + 0.3, (b, m_got, m_want)


def test_cli_parallel_block(tmp_path):
    """cli.run in two ranks with a distributed block: dp 2 gives the
    single-device command's chain bit for bit, tp 2 runs the ladder and
    logs the evidence, and a mesh larger than the world, hmc on a mesh and
    a tempered run without a tp axis are refused."""
    from mcmc_dynamics_tpu_torch.cli.run import main

    rng = np.random.default_rng(3)
    n = 120
    ra = RA_C + 0.02 * rng.normal(size=n)
    dec = DEC_C + 0.02 * rng.normal(size=n)
    v = 6.0 * rng.normal(size=n) + 2.0
    verr = 0.5 + 0.5 * rng.random(n)
    rows = "\n".join(",".join(repr(float(x)) for x in row)
                     for row in zip(ra, dec, v, verr))
    (tmp_path / "catalog.csv").write_text("ra,dec,v,verr\n" + rows + "\n")
    ranks = _spawn("cli", 2, tmp_path)
    assert all(r["refused"].all() for r in ranks), [r["refused"] for r in ranks]

    cfg = _cli_config(tmp_path, "cli_single", {}, {})
    del cfg["parallel"]
    path = tmp_path / "single.json"
    path.write_text(json.dumps(cfg))
    assert main([str(path), "--skip-binned", "--skip-profiles", "--device", "cpu"]) == 0
    with np.load(tmp_path / "cli_single_chain.npz") as a, \
            np.load(tmp_path / "cli_dp_chain.npz") as b:
        for key in ("chain", "lnprob", "coords", "log_prob", "accepted", "key"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    with np.load(tmp_path / "cli_tp_chain.npz") as f:
        assert f["chain"].shape == (8, 20, 4) and f["coords"].shape == (2, 8, 4)
        assert np.isfinite(f["lnprob"]).all()
    # the rank's logging was configured by its first command (basicConfig)
    assert "log-evidence" in (tmp_path / "cli_dp.log").read_text()
    assert not (tmp_path / "cli_bad_chain.npz").exists()


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2:])
