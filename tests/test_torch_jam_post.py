"""The JAM models' post-processing against the JAX package's, on one fixed
chain, float64 on the CPU: ``create_profiles`` (with its per-draw CSV),
``predict_fields``, ``compute_mass_posterior`` and ``calculate_mlr_profile``
for Axisymmetric (free black hole; an MGE grid with a free centre),
AnalyticalProfiles and a two-population ChemoProfiles.  Gate: rtol 1e-9.
"""

import numpy as np
import torch

from test_torch_jam_models import (DEC_C, RA_C, _grid_files, axisymmetric_params,
                                   build, catalog, chemo_kwargs, chemo_params,
                                   draws, profiles_params)

torch.set_num_threads(1)

RTOL = 1e-9
RADII = np.geomspace(0.5, 300.0, 24)


def fixed_chain(free, seed, **ranges):
    """An (8 walkers, 10 steps, K) chain of seeded in-prior draws."""
    pos = draws(free, 80, seed, **ranges)
    pos[0] = pos[5]                 # draws() puts walkers 0-2 off the posterior
    pos[1:3] = pos[6:8]
    return pos.reshape(8, 10, -1)


def assert_tables(got, want, columns):
    for name in columns:
        np.testing.assert_allclose(np.asarray(got.value(name), np.float64),
                                   np.asarray(want.value(name), np.float64),
                                   rtol=RTOL, atol=1e-12, err_msg=name)


PROFILE_COLUMNS = ["r"] + [f"{k}{s}" for k in ("v_rot", "sigma")
                           for s in ("", "_lower_1s", "_upper_1s", "_lower_3s",
                                     "_upper_3s")]


def test_axisymmetric_post_processing(tmp_path):
    jfit, tfit = build("Axisymmetric", axisymmetric_params(), catalog(n=100))
    chain = fixed_chain(tfit.fitted_parameters, seed=21)
    kw = dict(n_burn=4, n_samples=12, radii=RADII, n_theta=6)
    want = jfit.create_profiles(chain, **kw)
    tfit.predictive_chunk = 5        # three chunks
    got = tfit.create_profiles(chain, filename=str(tmp_path / "prof.ecsv"),
                               save_samples=True, **kw)
    assert_tables(got, want, PROFILE_COLUMNS)
    samples = np.loadtxt(tmp_path / "prof_allsamples.csv", delimiter=",", skiprows=1)
    assert samples.shape == (12 * RADII.size * 6, 4) and np.isfinite(samples).all()
    assert (tmp_path / "prof.ecsv").exists()

    rng = np.random.default_rng(22)
    ra = RA_C + rng.uniform(-0.01, 0.01, 30)
    dec = DEC_C + rng.uniform(-0.01, 0.01, 30)
    want = jfit.predict_fields(chain, 4, ra, dec, n_samples=20, seed=3)
    got = tfit.predict_fields(chain, 4, ra, dec, n_samples=20, seed=3)
    assert_tables(got, want, ["ra", "dec", "v_los", "v_los_lower_1s",
                              "v_los_upper_1s", "sigma_los", "sigma_los_lower_1s",
                              "sigma_los_upper_1s"])

    np.testing.assert_allclose(tfit.compute_mass_posterior(chain, 4, n_samples=50),
                               jfit.compute_mass_posterior(chain, 4, n_samples=50),
                               rtol=RTOL)
    mlr = np.array([2.0, 1.5])
    for a, b in zip(tfit.calculate_mlr_profile(mlr), jfit.calculate_mlr_profile(mlr)):
        np.testing.assert_allclose(np.asarray(getattr(a, "value", a)),
                                   np.asarray(getattr(b, "value", b)), rtol=RTOL)


def test_mge_grid_mass_posterior_and_profiles(tmp_path):
    """With an MGE grid and a free centre, every draw takes the MGE of the
    grid point nearest its centre."""
    params = axisymmetric_params(free_mbh=False)
    params["ra_center"].set(value=RA_C, min=RA_C - 0.01, max=RA_C + 0.01, fixed=False)
    params["dec_center"].set(value=DEC_C, fixed=True)
    jfit, tfit = build("Axisymmetric", params, catalog(n=80, seed=3),
                       kwargs_of=_grid_files(tmp_path))
    chain = fixed_chain(tfit.fitted_parameters, seed=23)
    np.testing.assert_allclose(tfit.compute_mass_posterior(chain, 2, n_samples=40),
                               jfit.compute_mass_posterior(chain, 2, n_samples=40),
                               rtol=RTOL)
    kw = dict(n_burn=2, n_samples=10, radii=RADII[::2], n_theta=4)
    assert_tables(tfit.create_profiles(chain, **kw), jfit.create_profiles(chain, **kw),
                  PROFILE_COLUMNS)


def test_analytical_profiles_post_processing():
    jfit, tfit = build("AnalyticalProfiles", profiles_params(), catalog(n=80, seed=4))
    chain = fixed_chain(tfit.fitted_parameters, seed=24)
    kw = dict(n_burn=2, n_samples=10, radii=RADII[::2], n_theta=4)
    assert_tables(tfit.create_profiles(chain, **kw), jfit.create_profiles(chain, **kw),
                  PROFILE_COLUMNS)
    np.testing.assert_allclose(tfit.compute_mass_posterior(chain, 2, n_samples=40),
                               jfit.compute_mass_posterior(chain, 2, n_samples=40),
                               rtol=RTOL)


def test_chemo_post_processing(tmp_path):
    jfit, tfit = build("ChemoProfiles", chemo_params(), catalog(n=80, seed=5, feh=True),
                       kwargs_of=chemo_kwargs)
    rng = np.random.default_rng(25)
    free = tfit.fitted_parameters
    ranges = {"barq": (0.58, 0.7), "kappa_max_a": (0.2, 0.6),
              "mu_feh_a": (-0.6, -0.4), "h_aa": (0.7, 0.95)}
    chain = np.stack([rng.uniform(*ranges[n], (6, 8)) for n in free], axis=-1)
    kw = dict(n_burn=2, n_samples=8, radii=RADII[::3], n_theta=4)
    got = tfit.create_profiles(chain, filename=str(tmp_path / "chemo.ecsv"), **kw)
    want = jfit.create_profiles(chain, **kw)
    assert sorted(got) == sorted(want) == [0, 1]
    for pop in got:
        assert_tables(got[pop], want[pop], PROFILE_COLUMNS)
        assert (tmp_path / f"chemo_pop{pop}.ecsv").exists()
    ra = RA_C + np.linspace(-0.01, 0.01, 12)
    dec = np.full(12, DEC_C + 0.002)
    got = tfit.predict_fields(chain, 2, ra, dec, n_samples=10, seed=1)
    want = jfit.predict_fields(chain, 2, ra, dec, n_samples=10, seed=1)
    for pop in want:
        assert_tables(got[pop], want[pop], ["v_los", "sigma_los", "sigma_los_upper_1s"])
    np.testing.assert_allclose(tfit.compute_mass_posterior(chain, 2, n_samples=20),
                               jfit.compute_mass_posterior(chain, 2, n_samples=20),
                               rtol=RTOL)
