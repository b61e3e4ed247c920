"""Affine-invariant ensemble sampler (stretch move) in torch.

Counterpart of ``mcmc_dynamics_tpu/sampler/stretch.py``: the ensemble is split
into two halves and each half proposes against the other (Goodman & Weare
2010; Foreman-Mackey et al. 2013), with stretch factors
``z = ((a-1) u + 1)^2 / a`` and ``ln alpha = (K-1) ln z + lnP(y) - lnP(x)``.

The reference threads a ``jax.random`` key through a ``lax.scan``; here a
``torch.Generator`` on the walkers' device is advanced by a Python loop.  The
two streams differ, so :func:`propose_stretch` takes its uniforms as an
argument: fed the uniforms the JAX step draws, one torch step equals one JAX
step.  A checkpoint keeps the generator state, so a resumed run continues
bit for bit.

Only the stretch move is ported so far; the DE and snooker moves and move
mixtures are listed in ROADMAP.md (queue 1, item 5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

__all__ = ["EnsembleState", "EnsembleResult", "init_state", "make_generator",
           "propose_stretch", "stretch_step", "run_ensemble", "check_move"]


@dataclass
class EnsembleState:
    """Walker ensemble state: ``coords`` (W, K), ``log_prob`` (W,), the
    ``generator`` the proposals draw from, ``accepted`` (W,) cumulative
    accepted-move counts (int32) and ``step``, the number of steps taken."""

    coords: torch.Tensor
    log_prob: torch.Tensor
    generator: torch.Generator
    accepted: torch.Tensor
    step: int


@dataclass
class EnsembleResult:
    """``chain`` (W, S, K) in the emcee layout, ``log_prob`` (W, S), the
    resumable ``final`` state and the (W,) ``acceptance_fraction``."""

    chain: torch.Tensor
    log_prob: torch.Tensor
    final: EnsembleState
    acceptance_fraction: torch.Tensor


def make_generator(seed: int, device) -> torch.Generator:
    """Sampler generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def check_move(move) -> None:
    """Only ``"stretch"`` is ported; anything else raises."""
    if move != "stretch":
        raise NotImplementedError(
            f"move={move!r}: only the stretch move is ported to torch so far; "
            "DE, snooker and move mixtures are listed in ROADMAP.md "
            "(queue 1, item 5).")


def init_state(batched_lnprob: Callable, coords: torch.Tensor,
               generator: torch.Generator) -> EnsembleState:
    """Evaluate lnprob at the initial walkers and build the state."""
    return EnsembleState(
        coords=coords,
        log_prob=batched_lnprob(coords),
        generator=generator,
        accepted=torch.zeros(coords.shape[0], dtype=torch.int32,
                             device=coords.device),
        step=0,
    )


def propose_stretch(active: torch.Tensor, pool: torch.Tensor,
                    un: torch.Tensor, a: float):
    """Stretch proposals for one half against its partner pool.

    ``un``: (3, n_active) uniforms in [0, 1): the stretch factor, the partner
    index and the acceptance draw.  Returns (proposals, ln_bias, ln_u) with
    ln_bias = (K-1) ln z.
    """
    n_active, ndim = active.shape
    z = ((a - 1.0) * un[0] + 1.0) ** 2 / a
    n_pool = pool.shape[0]
    partner_idx = torch.clamp((un[1] * n_pool).to(torch.int64), max=n_pool - 1)
    partners = pool[partner_idx]
    proposals = partners + z[:, None] * (active - partners)
    return proposals, (ndim - 1.0) * torch.log(z), torch.log(un[2])


def _accept_update(batched_lnprob, active, active_lnp, proposals, ln_bias, ln_u):
    new_lnp = batched_lnprob(proposals)
    ln_accept = ln_bias + new_lnp - active_lnp
    # a NaN lnprob never wins
    accept = (ln_u < ln_accept) & torch.isfinite(new_lnp)
    coords = torch.where(accept[:, None], proposals, active)
    lnp = torch.where(accept, new_lnp, active_lnp)
    return coords, lnp, accept


def stretch_step(batched_lnprob: Callable, state: EnsembleState, a: float = 2.0,
                 uniforms: Optional[Sequence[torch.Tensor]] = None
                 ) -> EnsembleState:
    """One full ensemble step: the first half moves against the second, then
    the second against the updated first.

    ``uniforms``: the two (3, W/2) uniform blocks of the half-steps; drawn
    from ``state.generator`` when not given.
    """
    n_walkers = state.coords.shape[0]
    half = n_walkers // 2
    if uniforms is None:
        uniforms = [torch.rand((3, n), generator=state.generator,
                               dtype=state.coords.dtype, device=state.coords.device)
                    for n in (half, n_walkers - half)]
    c0, c1 = state.coords[:half], state.coords[half:]
    p0, p1 = state.log_prob[:half], state.log_prob[half:]

    c0, p0, acc0 = _accept_update(batched_lnprob, c0, p0,
                                  *propose_stretch(c0, c1, uniforms[0], a))
    c1, p1, acc1 = _accept_update(batched_lnprob, c1, p1,
                                  *propose_stretch(c1, c0, uniforms[1], a))

    return EnsembleState(
        coords=torch.cat([c0, c1], dim=0),
        log_prob=torch.cat([p0, p1], dim=0),
        generator=state.generator,
        accepted=state.accepted + torch.cat([acc0, acc1]).to(torch.int32),
        step=state.step + 1,
    )


def run_ensemble(batched_lnprob: Callable, initial: EnsembleState, n_steps: int,
                 a: float = 2.0, thin: int = 1,
                 move: str = "stretch") -> EnsembleResult:
    """Advance the ensemble ``n_steps`` steps; with ``thin > 1`` every
    ``thin``-th step is recorded (``n_steps`` must be a multiple of it).

    The generator of ``initial`` is advanced in place: ``initial`` and the
    returned ``final`` share it.
    """
    check_move(move)
    n_walkers, ndim = initial.coords.shape
    if n_walkers % 2:
        raise ValueError("Number of walkers must be even for half-ensemble moves.")
    if thin > 1 and n_steps % thin:
        raise ValueError("n_steps must be a multiple of thin.")
    thin = max(int(thin), 1)
    n_rec = n_steps // thin
    chain = torch.empty((n_rec, n_walkers, ndim), dtype=initial.coords.dtype,
                        device=initial.coords.device)
    lnp = torch.empty((n_rec, n_walkers), dtype=initial.log_prob.dtype,
                      device=initial.coords.device)
    state = initial
    for s in range(n_steps):
        state = stretch_step(batched_lnprob, state, a=a)
        if (s + 1) % thin == 0:
            chain[(s + 1) // thin - 1] = state.coords
            lnp[(s + 1) // thin - 1] = state.log_prob
    n_done = max(state.step - initial.step, 1)
    acc = (state.accepted - initial.accepted).to(initial.coords.dtype) / n_done
    return EnsembleResult(chain=chain.transpose(0, 1), log_prob=lnp.transpose(0, 1),
                          final=state, acceptance_fraction=acc)
