"""Parallel-tempered ensemble sampling (replica exchange) and the
thermodynamic-integration evidence, in torch.

Counterpart of ``mcmc_dynamics_tpu/sampler/tempered.py``.  K tempered
ensembles advance together on the sampler's leading batch axis
(``sampler/stretch.py``): one half-step draws every level's uniforms in one
call, proposes for all K levels at once and evaluates the K x W/2 proposals
in one call of the batched lnprob.  Level k targets ``beta_k * lnP(theta)``
(hard bounds stay -inf at every temperature); the acceptance tempers only the
likelihood term, ``ln alpha = ln_bias + beta_k (lnP' - lnP)``.  Adjacent
levels then exchange walkers with the replica-swap acceptance

    ln alpha = (beta_k - beta_{k+1}) (lnP_{k+1} - lnP_k),

pairs k = 0 ... K-2 in order, each pair seeing the previous pair's swap, on
every ``swap_every``-th step of the carried global step count (so a resumed
run keeps the schedule of an uninterrupted one).  The run-averaged lnP of
each level gives ``ln Z = int_0^1 E_beta[lnP] dbeta`` by the trapezoid rule.

The JAX package splits its key per level; here one ``torch.Generator``
draws for all levels at once, so the two streams differ.  Every step takes
its draws as arguments (:func:`tempered_step`): fed the JAX package's draws,
one torch step equals one JAX step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .stretch import draw_step, normalize_move, propose_mixture

__all__ = ["TemperedState", "TemperedResult", "make_beta_ladder",
           "init_tempered", "tempered_step", "run_tempered", "log_evidence",
           "swap_accept"]


@dataclass
class TemperedState:
    """The ladder: ``coords`` (K, W, P), the untempered ``log_prob`` (K, W),
    the ``generator`` every level draws from, ``accepted`` (K, W) and
    ``swaps_accepted`` (K-1,) cumulative counts (int32) and ``step``, the
    number of steps taken."""

    coords: torch.Tensor
    log_prob: torch.Tensor
    generator: torch.Generator
    accepted: torch.Tensor
    swaps_accepted: torch.Tensor
    step: int


@dataclass
class TemperedResult:
    """``chain`` (W, S, P) and ``log_prob`` (W, S) of the cold (beta = 1)
    level, ``mean_lnp_by_beta`` (K,) the run-averaged lnP of each level (for
    the evidence), the resumable ``final`` state, ``acceptance_fraction``
    (K, W) and ``swap_acceptance`` (K-1,)."""

    chain: torch.Tensor
    log_prob: torch.Tensor
    mean_lnp_by_beta: torch.Tensor
    final: TemperedState
    acceptance_fraction: torch.Tensor
    swap_acceptance: torch.Tensor


def make_beta_ladder(n_temps: int, beta_min: float = 1e-3) -> np.ndarray:
    """Geometric inverse-temperature ladder from 1 down to ``beta_min``."""
    if n_temps == 1:
        return np.array([1.0])
    return np.geomspace(1.0, beta_min, n_temps)


def _ladder_lnprob(batched_lnprob: Callable, coords: torch.Tensor) -> torch.Tensor:
    """lnP of a (K, n, P) block in one call of the batched lnprob."""
    n_temps, n, ndim = coords.shape
    return batched_lnprob(coords.reshape(n_temps * n, ndim)).reshape(n_temps, n)


def init_tempered(batched_lnprob: Callable, coords: torch.Tensor,
                  generator: torch.Generator, n_temps: int,
                  beta_min: float = 1e-3):
    """Replicate (W, P) starting positions across the ladder and evaluate lnP
    (one call of ``batched_lnprob`` on K x W walkers).  Returns the state and
    the ladder's betas (K,) on the walkers' device."""
    stacked = coords.expand((n_temps,) + tuple(coords.shape)).contiguous()
    betas = torch.as_tensor(make_beta_ladder(n_temps, beta_min), dtype=coords.dtype,
                            device=coords.device)
    state = TemperedState(
        coords=stacked, log_prob=_ladder_lnprob(batched_lnprob, stacked),
        generator=generator,
        accepted=torch.zeros(stacked.shape[:2], dtype=torch.int32,
                             device=coords.device),
        swaps_accepted=torch.zeros(n_temps - 1, dtype=torch.int32,
                                   device=coords.device),
        step=0)
    return state, betas


def _tempered_half(batched_lnprob, moves, active, active_lnp, pool, beta, un, eps,
                   a):
    """Half-update of every level: the shared move machinery proposes for
    (K, n, P) walkers against their level's pool, and the acceptance tempers
    only the likelihood term, ``ln_bias + beta dlnP`` with beta (K, 1)."""
    proposals, ln_bias, ln_u = propose_mixture(moves, active, pool, un, eps, a=a)
    new_lnp = _ladder_lnprob(batched_lnprob, proposals)
    ln_accept = ln_bias + beta * (new_lnp - active_lnp)
    # a NaN lnprob never wins; -inf - -inf is NaN here too, and rejects
    accept = (ln_u < ln_accept) & torch.isfinite(new_lnp)
    return (torch.where(accept[..., None], proposals, active),
            torch.where(accept, new_lnp, active_lnp), accept)


def swap_accept(ln_u, beta_lo, beta_hi, lnp_lo, lnp_hi):
    """The replica-swap decision of the pair (lo, hi) of adjacent levels:
    ``ln u < (beta_lo - beta_hi)(lnP_hi - lnP_lo)``.  Both lnP -inf give NaN,
    the comparison is False and nothing swaps.  The single-device sweep and
    the temperature-sharded ladder (``parallel/tempered.py``) both decide
    through it."""
    return ln_u < (beta_lo - beta_hi) * (lnp_hi - lnp_lo)


def _swap(coords, lnp, betas, u):
    """Replica exchange between adjacent levels, walker-aligned, pairs
    k = 0 ... K-2 in order.  Returns (coords, lnp, swaps (K-1,))."""
    levels, lnps, counts = list(coords.unbind(0)), list(lnp.unbind(0)), []
    ln_u = torch.log(u)
    for k in range(len(levels) - 1):
        sw = swap_accept(ln_u[k], betas[k], betas[k + 1], lnps[k], lnps[k + 1])
        ck, ck1, pk, pk1 = levels[k], levels[k + 1], lnps[k], lnps[k + 1]
        levels[k] = torch.where(sw[:, None], ck1, ck)
        levels[k + 1] = torch.where(sw[:, None], ck, ck1)
        lnps[k] = torch.where(sw, pk1, pk)
        lnps[k + 1] = torch.where(sw, pk, pk1)
        counts.append(torch.sum(sw, dtype=torch.int32))
    return torch.stack(levels), torch.stack(lnps), torch.stack(counts)


def tempered_step(batched_lnprob: Callable, state: TemperedState, betas: torch.Tensor,
                  a: float = 2.0, swap_every: int = 1, move="stretch",
                  draws: Optional[Sequence] = None) -> TemperedState:
    """One ladder step: every level's first half moves against its second,
    then the second against the updated first; then, on a swap step
    (``step % swap_every == swap_every - 1``), the replica exchange.

    ``draws``: ``(half0, half1, u_swap)``, each half as :func:`draw_half`
    gives it with ``lead=(K,)`` (``(un, eps)`` or a bare ``un``), and
    ``u_swap`` (K-1, W) uniforms (None off a swap step); drawn from
    ``state.generator`` when not given, the swap uniforms only on a swap
    step.
    """
    moves = normalize_move(move)
    coords = state.coords
    n_temps, n_walkers, ndim = coords.shape
    half = n_walkers // 2
    swap = n_temps > 1 and state.step % swap_every == swap_every - 1
    if draws is None:
        draws = draw_step(moves, state.generator, n_walkers, ndim, coords.dtype,
                          coords.device, (n_temps,))
        draws.append(torch.rand((n_temps - 1, n_walkers), generator=state.generator,
                                dtype=coords.dtype, device=coords.device)
                     if swap else None)
    halves = [d if isinstance(d, (tuple, list)) else (d, None) for d in draws[:2]]
    beta = betas[:, None]
    c0, c1 = coords[:, :half], coords[:, half:]
    p0, p1 = state.log_prob[:, :half], state.log_prob[:, half:]
    c0, p0, acc0 = _tempered_half(batched_lnprob, moves, c0, p0, c1, beta,
                                  *halves[0], a)
    c1, p1, acc1 = _tempered_half(batched_lnprob, moves, c1, p1, c0, beta,
                                  *halves[1], a)
    coords = torch.cat([c0, c1], dim=1)
    lnp = torch.cat([p0, p1], dim=1)
    swaps = state.swaps_accepted
    if swap:
        coords, lnp, counts = _swap(coords, lnp, betas, draws[2])
        swaps = swaps + counts
    return TemperedState(
        coords=coords, log_prob=lnp, generator=state.generator,
        accepted=state.accepted + torch.cat([acc0, acc1], dim=1).to(torch.int32),
        swaps_accepted=swaps, step=state.step + 1)


def run_tempered(batched_lnprob: Callable, state: TemperedState, betas,
                 n_steps: int, a: float = 2.0, swap_every: int = 1,
                 store_chain: bool = True, move="stretch") -> TemperedResult:
    """Advance the ladder ``n_steps`` steps.

    ``batched_lnprob`` maps (N, P) -> (N,); each half-step calls it once on
    K x W/2 walkers.  ``move`` takes the specs of :func:`run_ensemble` (a
    name or a weighted mixture).  The generator of ``state`` is advanced in
    place: ``state`` and the returned ``final`` share it.
    """
    moves = normalize_move(move)
    n_temps, n_walkers, ndim = state.coords.shape
    if n_walkers % 2:
        raise ValueError("Number of walkers must be even.")
    dtype, device = state.coords.dtype, state.coords.device
    betas = torch.as_tensor(betas, dtype=dtype, device=device)
    n_rec = int(n_steps) if store_chain else 0
    chain = torch.empty((n_rec, n_walkers, ndim), dtype=dtype, device=device)
    lnp = torch.empty((n_rec, n_walkers), dtype=state.log_prob.dtype, device=device)
    lnp_by_beta = torch.empty((int(n_steps), n_temps), dtype=state.log_prob.dtype,
                              device=device)
    final = state
    for s in range(int(n_steps)):
        final = tempered_step(batched_lnprob, final, betas, a=a,
                              swap_every=swap_every, move=moves)
        if store_chain:
            chain[s] = final.coords[0]
            lnp[s] = final.log_prob[0]
        lnp_by_beta[s] = torch.mean(final.log_prob, dim=1)

    n_done = max(final.step - state.step, 1)
    return TemperedResult(
        chain=chain.movedim(0, 1), log_prob=lnp.movedim(0, 1),
        mean_lnp_by_beta=torch.mean(lnp_by_beta, dim=0),
        final=final,
        acceptance_fraction=(final.accepted - state.accepted).to(dtype) / n_done,
        # max(..., 1): n_steps < swap_every means zero swap rounds — an
        # acceptance of 0, not 0/0 = NaN
        swap_acceptance=(final.swaps_accepted - state.swaps_accepted).to(dtype)
        / max(n_done // max(swap_every, 1) * n_walkers, 1))


def log_evidence(betas, mean_lnp_by_beta) -> float:
    """Thermodynamic-integration log-evidence: the trapezoid over the
    ladder, sorted by beta.  ``mean_lnp_by_beta`` are the run-averaged
    untempered log-posteriors of the levels."""
    betas = np.asarray(torch.as_tensor(betas).cpu(), np.float64)
    means = np.asarray(torch.as_tensor(mean_lnp_by_beta).cpu(), np.float64)
    order = np.argsort(betas)
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return float(trapezoid(means[order], betas[order]))
