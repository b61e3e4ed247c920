"""Multiple GPUs: device meshes over ``torch.distributed``, one rank a device,
and the walker-, star-, temperature- and bin-sharded samplers (counterpart of
``mcmc_dynamics_tpu/parallel/``)."""

from .distributed import (barrier, fetch, global_mesh, initialize,
                          is_distributed, is_primary, to_global)
from .mesh import Mesh, factorize_devices, make_mesh
from .sharded import (ShardedResult, pad_star_axis, run_ensemble_sharded,
                      star_sharded_lnprob)
from .tempered import run_tempered_sharded

__all__ = [
    "make_mesh", "factorize_devices",
    "pad_star_axis", "star_sharded_lnprob", "run_ensemble_sharded", "ShardedResult",
    "run_tempered_sharded",
    "initialize", "is_distributed", "is_primary", "global_mesh", "to_global",
    "fetch", "barrier",
    "Mesh",
]
