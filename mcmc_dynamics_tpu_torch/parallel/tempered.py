"""Temperature-sharded parallel tempering: one temperature a rank along ``tp``.

Counterpart of ``mcmc_dynamics_tpu/parallel/tempered.py``.  Each rank of the
``tp`` axis holds ONE level's whole ensemble and advances it through the
model's batched tier (the single-device code path, on W/2 walkers a
half-step).  Adjacent levels exchange walkers in alternating even/odd phases
(phase 0 pairs (0,1)(2,3)..., phase 1 pairs (1,2)(3,4)...), the phase
counted in swap rounds of the carried global step, so a resumed run keeps an
uninterrupted run's sequence.  This is the JAX package's sharded scheme; the
single-device sampler sweeps the pairs in order, which is another chain.

Draws are replicated, as in ``parallel/sharded.py``: every rank advances the
same generator and draws what the single-device ladder draws (each half-step
for all K levels, the (K-1, W) swap uniforms on a swap step) and keeps its
level's share, so both ranks of a pair take the same uniform, ``u[lo]``.  The
exchange is one all-gather over ``tp`` of every level's (coords, lnP)
(K x W x (P + 1) numbers) on a swap step; every rank then decides every active
pair through the single-device sampler's :func:`~..sampler.tempered.swap_accept`
and keeps its own level.  Level k targets ``beta_k * lnP`` and the run-mean of
each level's untempered lnP feeds the same ``log_evidence``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sampler.stretch import draw_step, normalize_move
from ..sampler.tempered import (TemperedResult, TemperedState, _tempered_half,
                                make_beta_ladder, swap_accept)
from .mesh import Mesh

__all__ = ["run_tempered_sharded", "swap_attempts"]


def swap_attempts(n_temps: int, n_walkers: int, swap_every: int, step0: int,
                  n_steps: int) -> np.ndarray:
    """The swaps each adjacent pair attempts in the steps [step0, step0 +
    n_steps) of the even/odd scheme: pair (k, k+1) is active on the swap
    rounds whose parity is k % 2, one attempt a walker; (K-1,), at least 1."""
    se = max(int(swap_every), 1)
    first = int(step0) + ((se - 1 - int(step0)) % se)
    rounds = range(first, int(step0) + int(n_steps), se)
    n_even = sum(1 for g in rounds if (g // se) % 2 == 0)
    pair = np.arange(n_temps - 1)
    return np.maximum(np.where(pair % 2 == 0, n_even, len(rounds) - n_even)
                      * n_walkers, 1)


def run_tempered_sharded(runner, coords, generator: torch.Generator, n_steps: int,
                         mesh: Mesh, temp_axis: str = "tp", beta_min: float = 1e-3,
                         a: float = 2.0, swap_every: int = 1, move="stretch",
                         step0: int = 0, log_prob0=None) -> TemperedResult:
    """Advance a temperature-sharded ladder ``n_steps`` steps.

    ``coords``: (W, P) starting positions (every level starts there), or
    (K, W, P), a prior run's ``final.coords``, to resume; pass its
    ``log_prob`` (K, W) as ``log_prob0`` to carry the in-run lnP (computed
    when not given) and its ``step`` as ``step0`` (the swap phases follow
    the global step).  ``generator``: the same state on every rank, advanced
    in place.  The ladder has the mesh's ``temp_axis`` extent.  The result
    is whole on every rank: the cold chain (W, S, P), every level's final
    state, acceptance and run-mean lnP, and the swap acceptance per pair.
    """
    if temp_axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {temp_axis!r} (axes: {mesh.shape})")
    n_temps = mesh.shape[temp_axis]
    if n_temps < 2:
        raise ValueError("Need at least 2 temperatures (mesh axis size >= 2).")
    coords = torch.as_tensor(coords, dtype=runner.dtype, device=runner.device)
    resumed = coords.dim() == 3
    if resumed and coords.shape[0] != n_temps:
        raise ValueError(
            f"Resuming a tempered ladder requires the same tp extent: state "
            f"carries {coords.shape[0]} temperatures, mesh has tp={n_temps}.")
    n_walkers, ndim = coords.shape[-2:]
    if n_walkers % 2:
        raise ValueError("Number of walkers must be even.")
    half = n_walkers // 2
    k = mesh.coordinate(temp_axis)
    dtype, device = coords.dtype, coords.device
    moves = normalize_move(move)
    lnprob = runner.batched_lnprob()
    betas = torch.as_tensor(make_beta_ladder(n_temps, beta_min), dtype=dtype,
                            device=device)
    beta = betas[k:k + 1, None]                                  # (1, 1)

    c = (coords[k] if resumed else coords).clone()
    if resumed and log_prob0 is not None:
        lnp = torch.as_tensor(log_prob0, dtype=dtype, device=device)[k].clone()
        if lnp.shape != (n_walkers,):
            raise ValueError(f"log_prob0 must be (n_temps, n_walkers) = "
                             f"{(n_temps, n_walkers)}.")
    else:
        lnp = lnprob(c)

    cold = k == 0
    chain = torch.empty((n_steps if cold else 0, n_walkers, ndim), dtype=dtype,
                        device=device)
    lnp_cold = torch.empty((n_steps if cold else 0, n_walkers), dtype=dtype,
                           device=device)
    lnp_sum = torch.zeros((), dtype=dtype, device=device)
    acc = torch.zeros(n_walkers, dtype=torch.int32, device=device)
    swaps = torch.zeros(n_temps - 1, dtype=torch.int32, device=device)
    se = max(int(swap_every), 1)
    for s in range(int(n_steps)):
        g = int(step0) + s
        (un0, eps0), (un1, eps1) = draw_step(moves, generator, n_walkers, ndim,
                                             dtype, device, (n_temps,))
        # this level's share as a one-level ladder (1, n, P)
        c0, p0, a0 = _tempered_half(lnprob, moves, c[None, :half], lnp[None, :half],
                                    c[None, half:], beta, un0[k:k + 1],
                                    None if eps0 is None else eps0[k:k + 1], a)
        c1, p1, a1 = _tempered_half(lnprob, moves, c[None, half:], lnp[None, half:],
                                    c0, beta, un1[k:k + 1],
                                    None if eps1 is None else eps1[k:k + 1], a)
        c = torch.cat([c0[0], c1[0]])
        lnp = torch.cat([p0[0], p1[0]])
        acc += torch.cat([a0[0], a1[0]]).to(torch.int32)
        if g % se == se - 1:
            u = torch.rand((n_temps - 1, n_walkers), generator=generator,
                           dtype=dtype, device=device)
            c, lnp, counts = _phase_swap(mesh, temp_axis, c, lnp, betas, torch.log(u),
                                         (g // se) % 2)
            swaps += counts
        if cold:
            chain[s], lnp_cold[s] = c, lnp
        lnp_sum += torch.mean(lnp)

    # the result whole on every rank: the cold chain from coordinate 0, every
    # level's state and run-mean lnP gathered in level order
    chain = mesh.broadcast(chain if cold else
                           torch.empty((n_steps, n_walkers, ndim), dtype=dtype,
                                       device=device), temp_axis)
    lnp_cold = mesh.broadcast(lnp_cold if cold else
                              torch.empty((n_steps, n_walkers), dtype=dtype,
                                          device=device), temp_axis)
    final_c = mesh.all_gather(c[None], temp_axis)
    final_p = mesh.all_gather(lnp[None], temp_axis)
    acc_all = mesh.all_gather(acc[None], temp_axis)
    mean_lnp = mesh.all_gather((lnp_sum / max(int(n_steps), 1))[None], temp_axis)

    attempts = swap_attempts(n_temps, n_walkers, se, step0, n_steps)
    final = TemperedState(coords=final_c, log_prob=final_p, generator=generator,
                          accepted=acc_all, swaps_accepted=swaps,
                          step=int(step0) + int(n_steps))
    return TemperedResult(
        chain=chain.movedim(0, 1), log_prob=lnp_cold.movedim(0, 1),
        mean_lnp_by_beta=mean_lnp, final=final,
        acceptance_fraction=acc_all.to(dtype) / max(int(n_steps), 1),
        swap_acceptance=swaps.to(dtype) / torch.as_tensor(attempts, dtype=dtype,
                                                          device=device))


def _phase_swap(mesh: Mesh, temp_axis: str, c, lnp, betas, ln_u, phase: int):
    """One swap round of ``phase``: every level's (coords, lnP) gathered over
    ``tp``, each active pair (lo, lo + 1), lo = phase, phase + 2, ...,
    decided by :func:`swap_accept` with ``ln_u[lo]``, this rank's level
    replaced by its partner's where its pair swaps.  Returns (coords, lnP,
    accepted swaps per pair (K-1,)), the counts the same on every rank."""
    n_temps = betas.shape[0]
    k = mesh.coordinate(temp_axis)
    both = mesh.all_gather(torch.cat([c, lnp[:, None]], dim=1)[None], temp_axis)
    levels, lnps = both[..., :-1], both[..., -1]
    counts = torch.zeros(n_temps - 1, dtype=torch.int32, device=c.device)
    for lo in range(phase, n_temps - 1, 2):
        sw = swap_accept(ln_u[lo], betas[lo], betas[lo + 1], lnps[lo], lnps[lo + 1])
        counts[lo] = torch.sum(sw, dtype=torch.int32)
        if k in (lo, lo + 1):
            partner = lo + 1 if k == lo else lo
            c = torch.where(sw[:, None], levels[partner], c)
            lnp = torch.where(sw, lnps[partner], lnp)
    return c, lnp, counts
