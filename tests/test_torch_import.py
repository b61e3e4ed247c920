"""The port imports neither JAX nor anything of the JAX package.

``tests/conftest.py`` imports JAX into every test process, so the check runs in
a fresh interpreter: it builds a fixed-centre and a free-centre ModelFit, a
ModelFit on 16384 stars in the binned (``sufficient``) tier, a
ConstantFitGB, a SingleStars background, ModelFitGB,
ModelFitConstantBackground, DoubleModelFit and DoubleModelFitGB on the CPU,
evaluates the restructured mixtures of ``ops.probe_mixture``, imports
``pipelines``, ``native``, ``profiling``, ``sampler.diagnostics`` and
``cli.run_tests``, samples with a DE/snooker mixture, fits two radial bins
with ``fit_radial_bins`` and bins radii (natively where g++ builds the
library), builds the JAM models Axisymmetric and AnalyticalProfiles (on the
direct and the grid tier) and a two-population ChemoProfiles and evaluates
their lnprob, imports ``cli.run`` and ``cli.cluster_elongation``, runs a
short tempered ladder, an HMC run and an ``EnsembleSampler`` on its torch and
its NumPy path with an in-memory ``Backend``, imports ``parallel``, builds a
one-rank CPU mesh and samples on it, and then looks for ``jax`` and
for ``mcmc_dynamics_tpu`` and its submodules in ``sys.modules`` (and checks
that nothing imported matplotlib, pandas or h5py: the port needs none of them
unless it draws a figure or writes an HDF5 chain).
"""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

_SCRIPT = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import mcmc_dynamics_tpu_torch as port
from mcmc_dynamics_tpu_torch import convert, ops, sampler
from mcmc_dynamics_tpu_torch.background import SingleStars
from mcmc_dynamics_tpu_torch.models import (
    ConstantFit, ConstantFitGB, DoubleModelFit, DoubleModelFitGB, ModelFit,
    ModelFitConstantBackground, ModelFitGB)

data, truth = port.make_mock_cluster(n_stars=300, seed=1)
params = ModelFit.default_parameters()
params["ra_center"].set(value=truth["ra_center"], fixed=True)
params["dec_center"].set(value=truth["dec_center"], fixed=True)
fit = ModelFit(data, parameters=params, seed=2, device="cpu")
lnp = fit.batched_lnprob()(torch.as_tensor(fit.get_initials(4)))
assert lnp.shape == (4,), lnp.shape

free = ModelFit(data, seed=2, device="cpu")
assert free.lnprob_tier() == "freecenter", free.lnprob_tier()
pos = free.get_initials(4)
pos[:, 6:] = truth["ra_center"], truth["dec_center"]
assert free.batched_lnprob()(torch.as_tensor(pos)).shape == (4,)

big_data, big_truth = port.make_mock_cluster(n_stars=16384, seed=3)
big_params = ModelFit.default_parameters()
big_params["ra_center"].set(value=big_truth["ra_center"], fixed=True)
big_params["dec_center"].set(value=big_truth["dec_center"], fixed=True)
big = ModelFit(big_data, parameters=big_params, seed=2, device="cpu")
assert big.lnprob_tier() == "sufficient", big.lnprob_tier()
assert torch.isfinite(big.batched_lnprob()(torch.as_tensor(big.get_initials(4)))).all()

from mcmc_dynamics_tpu_torch.ops import probe_mixture
ones = torch.ones(8, dtype=torch.float64)
v2_params = torch.tensor([[0.0, 10.0, 0.0, 0.0, 30.0, 40.0, 1.0]], dtype=torch.float64)
v2 = probe_mixture.constant_gb_v2_lnlike_batched(v2_params, ones, ones, ones, ones,
                                                 ones, 0 * ones, ones)
assert torch.isfinite(v2).all()

table = data.data
table["density"] = np.full(300, 2.0)
table["pmember"] = np.full(300, 0.6)
gb_params = ConstantFitGB.default_parameters()
gb_params["ra_center"].set(value=truth["ra_center"], fixed=True)
gb_params["dec_center"].set(value=truth["dec_center"], fixed=True)
gb = ConstantFitGB(data, parameters=gb_params, device="cpu")
assert gb.lnprob_tier() == "gb"
assert torch.isfinite(gb.batched_lnprob()(torch.as_tensor(gb.get_initials(4)))).all()

background = SingleStars(np.random.default_rng(0).normal(30, 40, 200), device="cpu")
mix = ConstantFit(data, parameters=ConstantFit.default_parameters(), device="cpu",
                  background=background)
assert mix._host_arrays["lnlike_background"].shape == (300,)

for cls, tier, kw in ((ModelFitGB, "model_mixture", {}),
                      (ModelFitConstantBackground, "model_mixture",
                       {"background": port.Gaussian(30.0, 40.0)}),
                      (DoubleModelFit, "double", {}),
                      (DoubleModelFitGB, "double_gb", {})):
    p = cls.default_parameters()
    for name, value in (("ra_center", truth["ra_center"]),
                        ("dec_center", truth["dec_center"]),
                        ("v_back", 30.0), ("sigma_back", 40.0)):
        if name in p and (name.endswith("center") or cls is ModelFitConstantBackground):
            p[name].set(value=value, fixed=True)
    for name in ("a", "r_peak"):
        p[name].set(initials="rng.uniform(60, 120, size=n)")
    if "r_peak_c" in p:
        p["r_peak_c"].set(initials="rng.uniform(10, 50, size=n)")
    model = cls(data, parameters=p, device="cpu", **kw)
    assert model.lnprob_tier() == tier, (cls, model.lnprob_tier())
    lnp = model.batched_lnprob()(torch.as_tensor(model.get_initials(4)))
    assert torch.isfinite(lnp).all(), (cls, lnp)

from mcmc_dynamics_tpu_torch import native, pipelines, profiling
from mcmc_dynamics_tpu_torch.cli import run_tests
from mcmc_dynamics_tpu_torch.sampler import diagnostics
mixed = fit(n_walkers=8, n_steps=3, prefix=None, move=(("de", 0.8), ("snooker", 0.2)))
assert mixed.chain.shape == (8, 3, 6), mixed.chain.shape
assert diagnostics.autocorr_time(mixed.chain).shape == (6,)
binned = pipelines.fit_radial_bins(data, truth["ra_center"], truth["dec_center"],
                                   nstars=150, dlogr=0.05, n_walkers=8, n_steps=3,
                                   device="cpu")
assert binned.n_bins == 2 and binned.chains.shape == (2, 8, 3, 4), binned.chains.shape
assert port.utils.RadialProfile(np.arange(1.0, 101.0))(50, 0.1).max() == 1
native.native_available()

from mcmc_dynamics_tpu_torch.cli import cluster_elongation, run
from mcmc_dynamics_tpu_torch.models import (AnalyticalProfiles, Axisymmetric,
                                            ChemoProfiles)
from mcmc_dynamics_tpu_torch.utils import MgeReader, Table, get_mge
mge_lum, mge_mass = get_mge("example/data/mge.ecsv")
table = data.data
table["feh"] = np.where(np.arange(300) % 2, -0.5, 0.2)
table["feherr"] = np.full(300, 0.05)
for cls in (Axisymmetric, AnalyticalProfiles):
    p = cls.default_parameters()
    for name, value in (("d", 5.2), ("beta", 0.0), ("mbh", 0.0), ("rbh", 1.0),
                        ("ra_center", truth["ra_center"]),
                        ("dec_center", truth["dec_center"])):
        p[name].set(value=value, fixed=True)
    model = cls(data, parameters=p, mge_lum=mge_lum, mge_mass=mge_mass, device="cpu")
    model.n_u, model.n_zeta = 8, 8
    pos = torch.as_tensor(model.get_initials(4))
    for min_stars, tier in ((4096, "direct"), (100, "grid")):
        model.jam_grid_min_stars = min_stars
        assert model.lnprob_tier() == tier, (cls, model.lnprob_tier())
        assert model.batched_lnprob()(pos).shape == (4,)
tagged = MgeReader(Table({"i": [5000.0, 800.0], "s": [10.0, 40.0], "q": [0.9, 0.9],
                          "pop": [0, 1]}), lum=True)
cp = ChemoProfiles.default_parameters(2)
for name, value in (("d", 5.2), ("ra_center", truth["ra_center"]),
                    ("dec_center", truth["dec_center"])):
    cp[name].set(value=value, fixed=True)
chemo = ChemoProfiles(data, mge_mass=MgeReader(Table({"i": [5000.0, 800.0],
                                                     "s": [10.0, 40.0],
                                                     "q": [0.9, 0.9]})),
                      mge_lum=tagged, parameters=cp, n_pops=2, device="cpu")
chemo.n_u, chemo.n_zeta = 8, 8
assert chemo.batched_lnprob()(torch.as_tensor(chemo.get_initials(4))).shape == (4,)

from mcmc_dynamics_tpu_torch import emcee_backends, emcee_compat
from mcmc_dynamics_tpu_torch.sampler import hmc, tempered
ladder, lnz = fit.sample_tempered(n_walkers=8, n_steps=3, n_temps=3, beta_min=0.1,
                                  swap_every=1)
assert ladder.chain.shape == (8, 3, 6) and ladder.final_state.coords.shape == (3, 8, 6)
gradient = fit.sample_hmc(n_walkers=4, n_steps=2, n_warmup=1, n_leapfrog=2)
assert gradient.chain.shape == (4, 2, 6), gradient.chain.shape
for log_prob, kind in ((lambda t: -0.5 * torch.sum(t * t), "torch"),
                       (lambda t: -0.5 * float(np.sum(np.asarray(t) ** 2)), "numpy")):
    es = emcee_compat.EnsembleSampler(8, 2, log_prob, device="cpu",
                                      backend=emcee_backends.Backend())
    assert es.backend_kind == kind, es.backend_kind
    es.run_mcmc(np.random.default_rng(0).normal(size=(8, 2)), 3)
    assert es.get_chain().shape == (3, 8, 2)
from mcmc_dynamics_tpu_torch import parallel
mesh = parallel.make_mesh(("dp", "sp"), (1, 1), device="cpu")
assert mesh.backend == "gloo" and mesh.shape == {"dp": 1, "sp": 1}, mesh
sharded = parallel.run_ensemble_sharded(fit, fit.get_initials(4), sampler.make_generator(0, "cpu"),
                                        n_steps=2, mesh=mesh)
assert sharded.chain.shape == (4, 2, 6), sharded.chain.shape
parallel.distributed.shutdown()
assert "h5py" not in sys.modules
assert "matplotlib" not in sys.modules
assert "pandas" not in sys.modules

assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
loaded = sorted(m for m in sys.modules
                if m == "mcmc_dynamics_tpu" or m.startswith("mcmc_dynamics_tpu."))
assert not loaded, loaded
print("ok")
"""


def test_port_imports_and_builds_without_jax():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
