"""Command-line entry points of the port (``python -m mcmc_dynamics_tpu_torch.cli.<name>``)."""
