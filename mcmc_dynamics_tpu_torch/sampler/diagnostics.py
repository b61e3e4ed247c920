"""Convergence diagnostics for ensemble chains (host-side NumPy).

A copy of ``mcmc_dynamics_tpu/sampler/diagnostics.py``: the integrated
autocorrelation time (Goodman & Weare 2010 / the emcee estimator with Sokal
windowing), the split-R-hat potential scale-reduction factor and the effective
sample size.  Chains reach it as NumPy arrays on the host, so it gives the
same bits as the JAX package's copy.
"""

from __future__ import annotations

import numpy as np

__all__ = ["autocorr_time", "gelman_rubin", "effective_sample_size",
           "AutocorrError"]


class AutocorrError(Exception):
    """The chain is too short for a reliable autocorrelation estimate
    (< 50 integrated autocorrelation times; the emcee v3 convention).
    The unreliable estimate is attached as ``.tau``."""

    def __init__(self, tau, message):
        self.tau = tau
        super().__init__(message)


def _acf_1d(x: np.ndarray) -> np.ndarray:
    """Normalised autocorrelation function via FFT."""
    n = len(x)
    x = x - x.mean()
    f = np.fft.rfft(x, n=2 * n)
    acf = np.fft.irfft(f * np.conjugate(f))[:n].real
    if acf[0] == 0:
        return np.zeros(n)
    return acf / acf[0]


def autocorr_time(chain: np.ndarray, c: float = 5.0) -> np.ndarray:
    """Integrated autocorrelation time per parameter.

    ``chain``: (n_walkers, n_steps, n_params). Averages the per-walker ACF (the
    Goodman-Weare prescription) and applies Sokal's automatic windowing with
    window factor ``c``.
    """
    chain = np.asarray(chain)
    if chain.ndim == 2:
        chain = chain[:, :, None]
    n_walkers, n_steps, n_params = chain.shape
    taus = np.empty(n_params)
    for k in range(n_params):
        f = np.zeros(n_steps)
        for w in range(n_walkers):
            f += _acf_1d(chain[w, :, k])
        f /= n_walkers
        taus_cumulative = 2.0 * np.cumsum(f) - 1.0
        window = _auto_window(taus_cumulative, c)
        taus[k] = taus_cumulative[window]
    return taus


def _auto_window(taus: np.ndarray, c: float) -> int:
    m = np.arange(len(taus)) < c * taus
    if np.any(m):
        return int(np.argmin(m))
    return len(taus) - 1


def gelman_rubin(chain: np.ndarray) -> np.ndarray:
    """Split-R-hat per parameter from (n_walkers, n_steps, n_params) chains."""
    chain = np.asarray(chain)
    if chain.ndim == 2:
        chain = chain[:, :, None]
    w, s, k = chain.shape
    half = s // 2
    # split each walker chain in two -> 2w sequences of length half
    seqs = np.concatenate([chain[:, :half], chain[:, half:2 * half]], axis=0)
    m, n = seqs.shape[0], seqs.shape[1]
    means = seqs.mean(axis=1)                      # (m, k)
    variances = seqs.var(axis=1, ddof=1)           # (m, k)
    between = n * means.var(axis=0, ddof=1)        # (k,)
    within = variances.mean(axis=0)                # (k,)
    var_est = (n - 1) / n * within + between / n
    return np.sqrt(var_est / within)


def effective_sample_size(chain: np.ndarray) -> np.ndarray:
    """ESS per parameter: total samples divided by the autocorrelation time."""
    chain = np.asarray(chain)
    if chain.ndim == 2:
        chain = chain[:, :, None]
    w, s, _ = chain.shape
    return w * s / np.maximum(autocorr_time(chain), 1.0)
