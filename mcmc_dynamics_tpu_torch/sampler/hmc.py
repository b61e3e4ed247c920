"""Gradient-based sampling: W independent Hamiltonian Monte Carlo chains in
torch.

Counterpart of ``mcmc_dynamics_tpu/sampler/hmc.py``.  The gradient of a
batched lnprob (W, P) -> (W,) comes from ``torch.autograd.grad`` of its sum
over walkers (each walker's lnP depends on its own row only), with
non-finite gradient entries mapped to 0 and non-finite lnP to -inf, per
walker: hard bounds simply reject.  Each step jitters the step size by
+-20 % (a fixed (eps, L) makes near-periodic trajectories on harmonic-like
posteriors), integrates ``n_leapfrog`` leapfrog steps carrying lnP at the new
position, and accepts per walker; during warmup the log step size follows a
Robbins-Monro update (gain 0.05) toward the target acceptance.  An optional
diagonal inverse mass ``mass_inv`` (P,) rescales the momenta.

The JAX package threads a key through a ``lax.scan``; here one
``torch.Generator`` draws each step's jitter uniform, momenta normals and
acceptance uniforms, in that order.  :func:`hmc_step` takes them as
arguments, so fed the JAX package's draws one torch step equals one JAX
step.  The log step size and the acceptance rate stay on the device: a step
never waits for the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

__all__ = ["HMCState", "HMCResult", "value_and_grad", "init_hmc", "hmc_step",
           "run_hmc"]


@dataclass
class HMCState:
    """W chains: ``coords`` (W, P), ``log_prob`` (W,), ``grad`` (W, P), the
    ``generator``, ``log_step`` (a 0-d tensor on the device: the log step
    size, adapted during warmup), ``accepted`` (W,) cumulative counts
    (int32) and ``step``, the number of steps taken."""

    coords: torch.Tensor
    log_prob: torch.Tensor
    grad: torch.Tensor
    generator: torch.Generator
    log_step: torch.Tensor
    accepted: torch.Tensor
    step: int


@dataclass
class HMCResult:
    """``chain`` (W, S, P), ``log_prob`` (W, S), the resumable ``final``
    state, the (W,) ``acceptance_fraction`` and the final ``step_size``."""

    chain: torch.Tensor
    log_prob: torch.Tensor
    final: HMCState
    acceptance_fraction: torch.Tensor
    step_size: float


def value_and_grad(batched_lnprob: Callable) -> Callable:
    """``q`` (W, P) -> (lnP (W,), dlnP/dq (W, P)) through autograd, with
    non-finite gradient entries set to 0 and non-finite lnP to -inf.

    Raises :class:`ValueError` when lnP has no autograd path to ``q`` (a
    kernel tier, a detached or constant lnprob): HMC needs the
    differentiable lnprob of ``Runner.build_lnprob_differentiable``."""
    def vg(q):
        with torch.enable_grad():
            x = q.detach().requires_grad_(True)
            lnp = batched_lnprob(x)
            grad = (torch.autograd.grad(lnp.sum(), x, allow_unused=True)[0]
                    if lnp.requires_grad else None)
        if grad is None:
            raise ValueError(
                "HMC: the lnprob's output has no autograd path to its input (a "
                "kernel tier or a detached function); pass the differentiable "
                "lnprob of Runner.build_lnprob_differentiable()")
        lnp = lnp.detach()
        grad = torch.where(torch.isfinite(grad), grad, torch.zeros_like(grad))
        lnp = torch.where(torch.isfinite(lnp), lnp, torch.full_like(lnp, -math.inf))
        return lnp, grad.detach()

    return vg


def init_hmc(batched_lnprob: Callable, coords: torch.Tensor,
             generator: torch.Generator, step_size: float = 0.1) -> HMCState:
    """Evaluate lnP and its gradient at the initial walkers."""
    lnp, grad = value_and_grad(batched_lnprob)(coords)
    return HMCState(coords=coords, log_prob=lnp, grad=grad, generator=generator,
                    log_step=torch.tensor(math.log(step_size), dtype=coords.dtype,
                                          device=coords.device),
                    accepted=torch.zeros(coords.shape[0], dtype=torch.int32,
                                         device=coords.device),
                    step=0)


def hmc_step(vg: Callable, state: HMCState, n_leapfrog: int = 10,
             mass_inv: Optional[torch.Tensor] = None, adapt: bool = False,
             target_accept: float = 0.8,
             draws: Optional[Sequence] = None) -> HMCState:
    """One HMC step of every chain.  ``vg`` is :func:`value_and_grad` of the
    batched lnprob.  ``draws``: ``(u_jitter () , normals (W, P), u_accept
    (W,))``, drawn from ``state.generator`` in that order when not given."""
    coords = state.coords
    n_walkers, ndim = coords.shape
    dtype, device = coords.dtype, coords.device
    m_inv = (torch.ones(ndim, dtype=dtype, device=device) if mass_inv is None
             else mass_inv)
    if draws is None:
        gen = state.generator
        draws = (torch.rand((), generator=gen, dtype=dtype, device=device),
                 torch.randn((n_walkers, ndim), generator=gen, dtype=dtype,
                             device=device),
                 torch.rand((n_walkers,), generator=gen, dtype=dtype, device=device))
    u_jitter, normals, u_accept = draws
    eps = torch.exp(state.log_step) * (0.8 + 0.4 * u_jitter)
    p0 = normals / torch.sqrt(m_inv)[None, :]

    q, p, grad, lnp = coords, p0, state.grad, state.log_prob
    for _ in range(int(n_leapfrog)):
        p = p + 0.5 * eps * grad
        q = q + eps * m_inv[None, :] * p
        # lnP at the new q rides along: the last evaluation is the proposal's
        lnp, grad = vg(q)
        p = p + 0.5 * eps * grad

    h0 = state.log_prob - 0.5 * torch.sum(p0 * p0 * m_inv[None, :], dim=1)
    h1 = lnp - 0.5 * torch.sum(p * p * m_inv[None, :], dim=1)
    # -inf - -inf (a walker stuck at an invalid point proposing another) is
    # NaN: a clean rejection, which must not reach the adapted step size
    delta = h1 - h0
    ln_accept = torch.where(torch.isnan(delta), torch.full_like(delta, -math.inf),
                            delta)
    accept = (torch.log(u_accept) < ln_accept) & torch.isfinite(lnp)

    accept_rate = torch.mean(torch.exp(torch.clamp(ln_accept, max=0.0)))
    gain = 0.05 if adapt else 0.0
    return HMCState(
        coords=torch.where(accept[:, None], q, coords),
        log_prob=torch.where(accept, lnp, state.log_prob),
        grad=torch.where(accept[:, None], grad, state.grad),
        generator=state.generator,
        log_step=state.log_step + gain * (accept_rate - target_accept),
        accepted=state.accepted + accept.to(torch.int32),
        step=state.step + 1)


def run_hmc(batched_lnprob: Callable, state: HMCState, n_steps: int,
            n_leapfrog: int = 10, mass_inv: Optional[torch.Tensor] = None,
            adapt: bool = False, target_accept: float = 0.8,
            store_chain: bool = True) -> HMCResult:
    """Advance the chains ``n_steps`` steps.

    Typical use: a warmup call with ``adapt=True`` (tunes the step size),
    then a sampling call with ``adapt=False`` resuming from ``result.final``.
    The generator of ``state`` is advanced in place.
    """
    vg = value_and_grad(batched_lnprob)
    n_walkers, ndim = state.coords.shape
    dtype, device = state.coords.dtype, state.coords.device
    n_rec = int(n_steps) if store_chain else 0
    chain = torch.empty((n_rec, n_walkers, ndim), dtype=dtype, device=device)
    lnp = torch.empty((n_rec, n_walkers), dtype=state.log_prob.dtype, device=device)
    final = state
    for s in range(int(n_steps)):
        final = hmc_step(vg, final, n_leapfrog, mass_inv=mass_inv, adapt=adapt,
                         target_accept=target_accept)
        if store_chain:
            chain[s] = final.coords
            lnp[s] = final.log_prob
    n_done = max(final.step - state.step, 1)
    return HMCResult(chain=chain.movedim(0, 1), log_prob=lnp.movedim(0, 1),
                     final=final,
                     acceptance_fraction=(final.accepted - state.accepted).to(dtype)
                     / n_done,
                     step_size=float(torch.exp(final.log_step)))
