"""``python -m mcmc_dynamics_tpu_torch.cli.run_tests``, the port of the JAX
package's mock-data recovery harness, on the CPU at a small size."""

import numpy as np
import torch

from mcmc_dynamics_tpu_torch.cli import run_tests

torch.set_num_threads(1)


def test_mock_recovery_harness_on_the_cpu(tmp_path, capsys):
    """The batched binned ConstantFit and the global ModelFit on a 300-star
    mock pass the harness's recovery assertions, print the binned summary as
    CSV and draw recovery.png."""
    rc = run_tests.main(["-n", "300", "--n-steps", "80", "--seed", "1",
                         "--device", "cpu", "-o", str(tmp_path)])
    assert rc == 0
    assert (tmp_path / "recovery.png").stat().st_size > 1000
    assert (tmp_path / "model_profile.ecsv").exists()
    lines = capsys.readouterr().out.splitlines()
    header = next(i for i, line in enumerate(lines) if line.startswith("r mean,"))
    columns = lines[header].split(",")
    assert "sigma_max median" in columns and "theta_0 median" in columns
    row = np.array(lines[header + 1].split(","), dtype=float)
    assert np.isfinite(row).all()
