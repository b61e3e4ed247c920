from .diagnostics import (AutocorrError, autocorr_time, effective_sample_size,
                          gelman_rubin)
from .stretch import (EnsembleResult, EnsembleState, draw_half, init_state,
                      make_generator, normalize_move, propose_de, propose_mixture,
                      propose_snooker, propose_stretch, run_ensemble, stretch_step)

__all__ = ["EnsembleResult", "EnsembleState", "draw_half", "init_state",
           "make_generator", "normalize_move", "propose_de", "propose_mixture",
           "propose_snooker", "propose_stretch", "run_ensemble", "stretch_step",
           "AutocorrError", "autocorr_time", "effective_sample_size",
           "gelman_rubin"]
