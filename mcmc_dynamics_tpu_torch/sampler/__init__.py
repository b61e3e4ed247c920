from .stretch import (EnsembleResult, EnsembleState, init_state, make_generator,
                      propose_stretch, run_ensemble, stretch_step)

__all__ = ["EnsembleResult", "EnsembleState", "init_state", "make_generator",
           "propose_stretch", "run_ensemble", "stretch_step"]
