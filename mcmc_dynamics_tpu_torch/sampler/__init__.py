from .diagnostics import (AutocorrError, autocorr_time, effective_sample_size,
                          gelman_rubin)
from .hmc import HMCResult, HMCState, hmc_step, init_hmc, run_hmc, value_and_grad
from .stretch import (EnsembleResult, EnsembleState, draw_half, draw_step,
                      half_update, init_state, make_generator, normalize_move,
                      propose_de, propose_mixture, propose_snooker, propose_stretch,
                      run_ensemble, stretch_step)
from .tempered import (TemperedResult, TemperedState, init_tempered, log_evidence,
                       make_beta_ladder, run_tempered, tempered_step)

__all__ = ["EnsembleResult", "EnsembleState", "draw_half", "draw_step",
           "half_update", "init_state",
           "make_generator", "normalize_move", "propose_de", "propose_mixture",
           "propose_snooker", "propose_stretch", "run_ensemble", "stretch_step",
           "AutocorrError", "autocorr_time", "effective_sample_size",
           "gelman_rubin",
           "TemperedState", "TemperedResult", "init_tempered", "tempered_step",
           "run_tempered", "make_beta_ladder", "log_evidence",
           "HMCState", "HMCResult", "value_and_grad", "init_hmc", "hmc_step",
           "run_hmc"]
