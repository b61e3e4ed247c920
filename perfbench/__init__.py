"""The benchmark of ``mcmc_dynamics_tpu_torch`` (the PyTorch/CUDA port): see
``README.md`` beside this file."""
