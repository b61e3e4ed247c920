"""``python -m mcmc_dynamics_tpu_torch.cli.run`` on a reduced copy of the
production recipe (``example/omega_cen_config.json``: AnalyticalProfiles on the
omega Cen catalog) and ``cli.cluster_elongation``, on the CPU."""

import json
import pathlib

import numpy as np
import pytest
import torch

from mcmc_dynamics_tpu_torch.cli import cluster_elongation, run

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def reduced_recipe(tmp_path, n_stars=400, sampling=None, **changes):
    """The recipe on ``n_stars`` stars of its catalog, with the quadrature at
    n_u 16, n_zeta 24, a few steps and a small binned section; ``sampling``
    updates the sampling block."""
    cfg = json.loads((REPO / "example" / "omega_cen_config.json").read_text())
    lines = (REPO / cfg["data"]["file"]).read_text().splitlines()
    keep = np.sort(np.random.default_rng(0).choice(len(lines) - 1, n_stars,
                                                   replace=False)) + 1
    (tmp_path / "catalog.csv").write_text(
        "\n".join([lines[0]] + [lines[i] for i in keep]) + "\n")
    cfg["data"]["file"] = str(tmp_path / "catalog.csv")
    cfg["mge"] = str(REPO / cfg["mge"])
    cfg["prefix"] = str(tmp_path / "run")
    cfg["model_options"] = {"n_u": 16, "n_zeta": 24}
    cfg["sampling"].update(n_walkers=16, n_steps=4, n_burn=2, n_out=2)
    cfg["binned"].update(nstars=150, n_walkers=8, n_steps=6)
    cfg["profiles"].update(n_samples=6, n_theta=4)
    cfg["sampling"].update(sampling or {})
    cfg.update(changes)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    return path


def test_production_recipe_end_to_end(tmp_path, capsys, monkeypatch):
    rc = run.main([str(reduced_recipe(tmp_path)), "--device", "cpu"])
    assert rc == 0
    with np.load(tmp_path / "run_chain.npz") as f:
        assert f["chain"].shape == (16, 4, 9)
        assert np.isfinite(f["chain"]).all() and np.isfinite(f["lnprob"]).all()
    masses = np.load(tmp_path / "run_mass_posterior.npy")
    assert masses.shape == (1000,) and np.isfinite(masses).all() and (masses > 0).all()
    from mcmc_dynamics_tpu_torch.utils import Table
    profile = Table.read(tmp_path / "run_profile.ecsv")
    assert len(profile) == 200
    for name in ("v_rot", "sigma", "sigma_upper_1s"):
        assert np.isfinite(profile.value(name)).all()
    binned = Table.read(tmp_path / "run_binned.csv", fmt="csv")
    assert np.isfinite(binned.value("sigma_max median")).all()
    best = capsys.readouterr().out.splitlines()
    header = next(i for i, line in enumerate(best) if line.startswith("value,"))
    assert best[header].split(",")[1:] == ["mlr_0", "mlr_t", "mlr_inf", "r_mlr",
                                           "barq", "kappa_x", "kappa_y", "r_kappa",
                                           "delta_v"]
    for name in ("chains", "corner", "overlay"):
        assert (tmp_path / f"run_{name}.png").stat().st_size > 1000
    # a restart from the checkpoint's last step (its figures not drawn again)
    monkeypatch.setattr(run, "_plot", lambda *args, **kwargs: None)
    rc = run.main([str(reduced_recipe(tmp_path)), "--device", "cpu", "--chain",
                   str(tmp_path / "run_chain.npz"), "--skip-binned",
                   "--skip-profiles"])
    assert rc == 0


@pytest.mark.parametrize("change, match", [
    ({"parallel": {"axes": {"dp": 4}}}, "needs 4 ranks"),
])
def test_unported_blocks_raise(tmp_path, change, match):
    """A mesh larger than the world (one process here) is refused."""
    with pytest.raises(ValueError, match=match):
        run.main([str(reduced_recipe(tmp_path, **change)), "--device", "cpu"])


@pytest.mark.parametrize("sampling", [
    dict(sampler="tempered", n_steps=3, n_temps=2, beta_min=0.1, swap_every=2),
    dict(sampler="hmc", n_steps=3, n_warmup=2, n_leapfrog=2, step_size=0.01),
])
def test_tempered_and_hmc_samplers(tmp_path, caplog, sampling):
    """``sampling.sampler`` = tempered / hmc on the reduced recipe: the
    checkpoint (the cold chain for the ladder), the mass posterior and the
    log's evidence line."""
    path = reduced_recipe(tmp_path, sampling=sampling)
    with caplog.at_level("INFO", logger="mcmc_dynamics_tpu_torch.cli.run"):
        assert run.main([str(path), "--device", "cpu", "--skip-binned",
                         "--skip-profiles"]) == 0
    with np.load(tmp_path / "run_chain.npz") as f:
        assert f["chain"].shape == (16, 3, 9)
        assert np.isfinite(f["chain"]).all() and np.isfinite(f["lnprob"]).all()
        assert str(f["key_impl"]) == "torch"
        if sampling["sampler"] == "tempered":
            assert f["coords"].shape == (2, 16, 9)
    assert np.isfinite(np.load(tmp_path / "run_mass_posterior.npy")).all()
    if sampling["sampler"] == "tempered":
        assert "thermodynamic-integration log-evidence" in caplog.text


def test_auto_steps_need_the_ensemble_sampler(tmp_path):
    path = reduced_recipe(tmp_path, sampling=dict(sampler="hmc", n_steps="auto"))
    with pytest.raises(ValueError, match="ensemble"):
        run.main([str(path), "--device", "cpu"])


def tempered_recipe_copy(tmp_path, n_steps):
    """``example/omega_cen_tempered.json`` without its ``parallel`` block (a
    device mesh), with ``sampling.n_temps`` the mesh's extent, 4, and
    ``n_steps`` steps."""
    cfg = json.loads((REPO / "example" / "omega_cen_tempered.json").read_text())
    tp = cfg.pop("parallel")["axes"]["tp"]
    cfg["sampling"].update(n_temps=tp, n_steps=n_steps, n_burn=n_steps // 2)
    cfg["data"]["file"] = str(REPO / cfg["data"]["file"])
    cfg["prefix"] = str(tmp_path / "tempered")
    path = tmp_path / "tempered.json"
    path.write_text(json.dumps(cfg))
    return path


def test_tempered_recipe_without_its_mesh(tmp_path):
    assert run.main([str(tempered_recipe_copy(tmp_path, 3)), "--device", "cpu",
                     "--skip-binned"]) == 0
    with np.load(tmp_path / "tempered_chain.npz") as f:
        assert f["chain"].shape == (32, 3, 6) and f["coords"].shape == (4, 32, 6)
        assert np.isfinite(f["lnprob"]).all()


def test_cluster_elongation_on_the_cpu(tmp_path, capsys):
    rng = np.random.default_rng(1)
    a = np.abs(rng.normal(0.0, 3.0, 500))
    t = rng.uniform(0.0, 2.0 * np.pi, 500)
    rows = [f"{x:.6f},{y:.6f}" for x, y in zip(a * np.cos(t), 0.6 * a * np.sin(t))]
    catalog = tmp_path / "xy.csv"
    catalog.write_text("x,y\n" + "\n".join(rows) + "\n")
    out = tmp_path / "elongation.png"
    assert cluster_elongation.main([str(catalog), "--radii", "0", "2", "5",
                                    "--bootstrap", "--seed", "3", "-o", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    header = next(i for i, line in enumerate(lines) if line.startswith("r_min,"))
    rows = np.array([line.split(",") for line in lines[header + 1:header + 3]], float)
    assert rows.shape == (2, 9) and np.isfinite(rows).all()
    assert np.all(np.abs(rows[:, 4] - np.sqrt(1 - 0.6 ** 2)) < 0.2)     # e
    assert out.stat().st_size > 1000
