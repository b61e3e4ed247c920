"""The port never imports JAX.

``tests/conftest.py`` imports JAX into every test process, so the check runs in
a fresh interpreter.
"""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

_SCRIPT = """
import sys
import torch
torch.set_num_threads(1)
import mcmc_dynamics_tpu_torch as port
from mcmc_dynamics_tpu_torch import convert, ops, sampler
from mcmc_dynamics_tpu_torch.models import ModelFit

data, truth = port.make_mock_cluster(n_stars=300, seed=1)
params = ModelFit.default_parameters()
params["ra_center"].set(value=truth["ra_center"], fixed=True)
params["dec_center"].set(value=truth["dec_center"], fixed=True)
fit = ModelFit(data, parameters=params, seed=2, device="cpu")
lnp = fit.batched_lnprob()(torch.as_tensor(fit.get_initials(4)))
assert lnp.shape == (4,), lnp.shape
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("ok")
"""


def test_port_imports_and_builds_without_jax():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
