"""Affine-invariant ensemble sampler in torch: stretch, DE and snooker moves
and their weighted mixtures.

Counterpart of ``mcmc_dynamics_tpu/sampler/stretch.py``: the ensemble is split
into two halves and each half proposes against the other (Goodman & Weare
2010; Foreman-Mackey et al. 2013).  The moves are the stretch move (stretch
factors ``z = ((a-1) u + 1)^2 / a``, ``ln alpha = (K-1) ln z + lnP(y) -
lnP(x)``), differential evolution (ter Braak 2006; emcee v3 ``DEMove``), the
snooker move (ter Braak & Vrugt 2008; emcee v3 ``DESnookerMove``) and a
weighted mixture of them, each walker drawing its move per half-step.

The reference threads a ``jax.random`` key through a ``lax.scan``; here a
``torch.Generator`` on the walkers' device is advanced by a Python loop.  The
two streams differ, so every proposal takes its random draws as arguments:
fed the draws the JAX move takes from its key, one torch half-step equals one
JAX half-step.  A checkpoint keeps the generator state, so a resumed run
continues bit for bit.

Every function takes an optional leading batch axis of independent
ensembles (the radial bins of ``pipelines.fit_radial_bins``): coords
(B, W, K), log_prob and accepted (B, W), and a batched lnprob
(B, W', K) -> (B, W').  A half-step draws its uniforms for all B ensembles
in one call on the one generator (and, when a DE move is in the spec, its
normals in a second call), never once per ensemble.

Each step of :func:`run_ensemble` runs in a ``sampler.step`` span
(:mod:`..profiling`), its draws, proposals and Metropolis updates in
``sampler.draw``, ``sampler.propose`` and ``sampler.accept`` spans, and each
lnprob call in a ``tier.lnprob`` span.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from ..profiling import span

__all__ = ["EnsembleState", "EnsembleResult", "init_state", "make_generator",
           "propose_stretch", "propose_de", "propose_snooker", "propose_mixture",
           "normalize_move", "draw_half", "draw_step", "half_update", "stretch_step",
           "run_ensemble"]


@dataclass
class EnsembleState:
    """Walker ensemble state: ``coords`` ([B,] W, K), ``log_prob`` ([B,] W),
    the ``generator`` the proposals draw from, ``accepted`` ([B,] W)
    cumulative accepted-move counts (int32) and ``step``, the number of steps
    taken."""

    coords: torch.Tensor
    log_prob: torch.Tensor
    generator: torch.Generator
    accepted: torch.Tensor
    step: int


@dataclass
class EnsembleResult:
    """``chain`` ([B,] W, S, K) in the emcee layout, ``log_prob`` ([B,] W, S),
    the resumable ``final`` state and the ([B,] W) ``acceptance_fraction``."""

    chain: torch.Tensor
    log_prob: torch.Tensor
    final: EnsembleState
    acceptance_fraction: torch.Tensor


def make_generator(seed: int, device) -> torch.Generator:
    """Sampler generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def init_state(batched_lnprob: Callable, coords: torch.Tensor,
               generator: torch.Generator) -> EnsembleState:
    """Evaluate lnprob at the initial walkers and build the state."""
    with span("sampler.init"):
        with span("tier.lnprob"):
            log_prob = batched_lnprob(coords)
        return EnsembleState(
            coords=coords,
            log_prob=log_prob,
            generator=generator,
            accepted=torch.zeros(coords.shape[:-1], dtype=torch.int32,
                                 device=coords.device),
            step=0,
        )


def _take(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (..., n) of ``pool`` (..., m, K) -> (..., n, K)."""
    if pool.dim() == 2:
        return pool[idx]
    return torch.gather(pool, -2, idx[..., None].expand(*idx.shape, pool.shape[-1]))


def _index(u: torch.Tensor, n: int) -> torch.Tensor:
    """min(floor(u n), n - 1): a uniform in [0, 1) as an index below n."""
    return torch.clamp((u * n).to(torch.int64), max=n - 1)


def propose_stretch(active: torch.Tensor, pool: torch.Tensor,
                    un: torch.Tensor, a: float):
    """Stretch proposals for one half against its partner pool.

    ``un``: ([B,] 3, n_active) uniforms in [0, 1): the stretch factor, the
    partner index and the acceptance draw.  Returns (proposals, ln_bias, ln_u)
    with ln_bias = (K-1) ln z.
    """
    ndim = active.shape[-1]
    z = ((a - 1.0) * un[..., 0, :] + 1.0) ** 2 / a
    partners = _take(pool, _index(un[..., 1, :], pool.shape[-2]))
    proposals = partners + z[..., None] * (active - partners)
    return proposals, (ndim - 1.0) * torch.log(z), torch.log(un[..., 2, :])


def propose_de(active: torch.Tensor, pool: torch.Tensor, un: torch.Tensor,
               eps: torch.Tensor, gamma0: Optional[float] = None,
               jitter: float = 1e-5, jump_prob: float = 0.1):
    """Differential-evolution proposals y = x + gamma (a - b) + jitter eps,
    with a != b drawn from the pool; a fraction ``jump_prob`` uses gamma = 1
    (mode jumping).  Symmetric, so ln_bias = 0.

    ``un``: ([B,] 4, n) uniforms (first partner, offset of the second, the
    mode-jump draw, acceptance); ``eps``: ([B,] n, K) standard normals (the
    JAX move draws them from ``fold_in(key, 1)``).
    """
    ndim = active.shape[-1]
    if gamma0 is None:
        gamma0 = 2.38 / math.sqrt(2.0 * ndim)
    n_pool = pool.shape[-2]
    idx1 = _index(un[..., 0, :], n_pool)
    # distinct second partner: shift by 1 + u*(n-1) modulo n
    off = 1 + _index(un[..., 1, :], n_pool - 1)
    idx2 = (idx1 + off) % n_pool
    jump = un[..., 2, :]
    gamma = torch.where(jump < jump_prob, torch.ones_like(jump),
                        torch.full_like(jump, gamma0))
    diff = _take(pool, idx1) - _take(pool, idx2)
    proposals = active + gamma[..., None] * diff + jitter * eps
    return proposals, torch.zeros_like(un[..., 3, :]), torch.log(un[..., 3, :])


def propose_snooker(active: torch.Tensor, pool: torch.Tensor, un: torch.Tensor,
                    gammas: float = 1.7):
    """Snooker proposals: each walker x draws three distinct pool members
    (z, z1, z2) and moves along u = (x - z)/|x - z| by ``gammas`` times the
    difference of the projections of z1 and z2 onto u, with the Metropolis
    correction ln_bias = (K-1)(ln|y - z| - ln|x - z|).

    ``un``: ([B,] 4, n) uniforms (z, the offsets of z1 and z2, acceptance).
    Needs a pool of >= 3 walkers.
    """
    ndim = active.shape[-1]
    n_pool = pool.shape[-2]
    if n_pool < 3:
        raise ValueError(
            f"Snooker proposals need a partner pool of >= 3 walkers (got "
            f"{n_pool}; use >= 6 walkers) — with 2 the z2 draw would wrap "
            "back onto z and break the Metropolis correction.")
    tiny = torch.finfo(active.dtype).tiny
    i0 = _index(un[..., 0, :], n_pool)
    # off1 in [1, n-1]; off2 drawn from [1, n-2] then bumped past off1, so
    # off2 in [1, n-1] \ {off1}: the three indices are distinct
    off1 = 1 + _index(un[..., 1, :], n_pool - 1)
    off2 = 1 + _index(un[..., 2, :], n_pool - 2)
    off2 = torch.where(off2 >= off1, off2 + 1, off2)
    z = _take(pool, i0)
    z1 = _take(pool, (i0 + off1) % n_pool)
    z2 = _take(pool, (i0 + off2) % n_pool)
    delta = active - z
    norm2 = torch.clamp(torch.sum(delta * delta, dim=-1), min=tiny)
    u_dir = delta * torch.rsqrt(norm2)[..., None]
    step = torch.sum(u_dir * (z1 - z2), dim=-1)
    proposals = active + gammas * step[..., None] * u_dir
    d_new = proposals - z
    norm2_new = torch.clamp(torch.sum(d_new * d_new, dim=-1), min=tiny)
    ln_bias = 0.5 * (ndim - 1.0) * (torch.log(norm2_new) - torch.log(norm2))
    return proposals, ln_bias, torch.log(un[..., 3, :])


_MOVE_NAMES = ("stretch", "de", "snooker")
# tunable hyperparameters per move; anything else in a spec is a typo
_MOVE_PARAMS = {
    "stretch": ("a",),
    "de": ("gamma0", "jitter", "jump_prob"),
    "snooker": ("gammas",),
}
# uniform rows each move draws per walker
_MOVE_ROWS = {"stretch": 3, "de": 4, "snooker": 4}


def _normalize_params(name: str, params) -> tuple:
    """Hyperparameter mapping -> sorted, hashable ((key, value), ...) tuple."""
    if not params:
        return ()
    items = dict(params).items()
    allowed = _MOVE_PARAMS[name]
    for k, _ in items:
        if k not in allowed:
            raise ValueError(
                f"Unknown hyperparameter {k!r} for move '{name}' "
                f"(tunable: {allowed}).")
    return tuple(sorted((str(k), None if v is None else float(v))
                        for k, v in items))


def normalize_move(move):
    """Canonicalise a move spec into a tuple of (name, weight, params)
    triples with the weights normalised to sum to 1.

    Accepts a single name (``"de"``), a weighted mixture in the emcee v3
    ``moves=[(DEMove(), 0.8), (DESnookerMove(), 0.2)]`` style
    (``(("de", 0.8), ("snooker", 0.2))``), or entries with an explicit
    hyperparameter mapping (``("de", 1.0, {"gamma0": 0.8})``); ``params`` is
    a sorted ``((key, value), ...)`` tuple.
    """
    if isinstance(move, str):
        entries = ((move, 1.0, ()),)
    else:
        entries = []
        try:
            for entry in move:
                if isinstance(entry, str):
                    entries.append((entry, 1.0, ()))
                else:
                    m, w, *rest = entry
                    params = rest[0] if rest else ()
                    entries.append((str(m), float(w), params))
            entries = tuple(entries)
        except (TypeError, ValueError) as err:
            raise ValueError(
                f"move must be a name or a sequence of (name, weight[, "
                f"params]) entries; got {move!r}") from err
    out = []
    for name, w, params in entries:
        if name not in _MOVE_NAMES:
            raise ValueError(f"Unknown move '{name}' (use one of {_MOVE_NAMES}).")
        if not w > 0:
            raise ValueError(
                f"Move weights must be positive (got {name!r}: {w}).")
        out.append((name, w, _normalize_params(name, params)))
    if not out:
        raise ValueError("Move weights must be positive.")
    total = sum(w for _, w, _p in out)
    return tuple((n, w / total, p) for n, w, p in out)


def draw_half(moves, generator: torch.Generator, n: int, ndim: int,
              dtype: torch.dtype, device, lead=()):
    """One half-step's draws for the normalised ``moves``, over ``lead``
    batch dimensions: ``(un, eps)`` with ``un`` (*lead, R, n) uniforms (the
    selection row when there are several moves, then each move's rows in
    order) from one ``torch.rand`` call, and ``eps`` (*lead, n_de, n, ndim)
    standard normals, one block per DE move, from one ``torch.randn`` call
    (None without a DE move)."""
    rows = (len(moves) > 1) + sum(_MOVE_ROWS[name] for name, _w, _p in moves)
    n_de = sum(name == "de" for name, _w, _p in moves)
    un = torch.rand(tuple(lead) + (rows, n), generator=generator, dtype=dtype,
                    device=device)
    eps = (torch.randn(tuple(lead) + (n_de, n, ndim), generator=generator,
                       dtype=dtype, device=device) if n_de else None)
    return un, eps


def draw_step(moves, generator: torch.Generator, n_walkers: int, ndim: int,
              dtype: torch.dtype, device, lead=()):
    """One full step's draws: :func:`draw_half` for the first half (W // 2
    walkers), then for the second, each as ``(un, eps)``.  The multi-device
    samplers draw the whole step on every rank from one replicated generator
    and take their own walkers' (or bins') slice of it."""
    half = n_walkers // 2
    return [draw_half(moves, generator, n, ndim, dtype, device, lead)
            for n in (half, n_walkers - half)]


def _propose_one(name, params, active, pool, un, eps, a):
    kw = dict(params)
    if name == "stretch":
        return propose_stretch(active, pool, un, kw.get("a", a))
    if name == "de":
        return propose_de(active, pool, un, eps, **kw)
    return propose_snooker(active, pool, un, **kw)


def propose_mixture(moves, active: torch.Tensor, pool: torch.Tensor,
                    un: torch.Tensor, eps: Optional[torch.Tensor] = None,
                    a: float = 2.0):
    """Proposals under a weighted move mixture (normalised (name, weight,
    params) tuple from :func:`normalize_move`), from the draws of
    :func:`draw_half`.

    Each walker picks a move with the given probabilities, from the first
    uniform row: state-independent mixing of valid Metropolis kernels, so
    detailed balance holds per walker.  Every component's proposals are
    computed and the chosen ones selected; lnprob runs once, on the
    selected proposals.
    """
    row = int(len(moves) > 1)
    k_de = 0
    parts = []
    for name, _w, params in moves:
        rows = _MOVE_ROWS[name]
        eps_k = eps[..., k_de, :, :] if name == "de" else None
        k_de += name == "de"
        parts.append(_propose_one(name, params, active, pool,
                                  un[..., row:row + rows, :], eps_k, a))
        row += rows
    if len(parts) == 1:
        return parts[0]
    u = un[..., 0, :]
    edges = torch.cumsum(torch.tensor([w for _, w, _p in moves[:-1]],
                                      dtype=active.dtype), 0).tolist()
    idx = sum((u >= e).to(torch.int64) for e in edges)          # (..., n)
    props = torch.stack([p[0] for p in parts])                  # (M, ..., n, K)
    proposals = torch.gather(props, 0, idx[None, ..., None].expand(
        (1,) + props.shape[1:]))[0]
    ln_bias, ln_u = (torch.gather(torch.stack([p[i] for p in parts]), 0,
                                  idx[None])[0] for i in (1, 2))
    return proposals, ln_bias, ln_u


def half_update(batched_lnprob: Callable, moves, active: torch.Tensor,
                active_lnp: torch.Tensor, pool: torch.Tensor, un: torch.Tensor,
                eps: Optional[torch.Tensor] = None, a: float = 2.0):
    """One half-ensemble's move: proposals against ``pool`` from the draws
    ``(un, eps)``, one lnprob call, the Metropolis step.  Returns (coords,
    log_prob, accepted).  The single-device step and the walker-sharded loop
    (``parallel/sharded.py``, whose pool is the gathered opposite half) both
    run it, so their proposals cannot drift apart."""
    with span("sampler.propose"):
        proposed = propose_mixture(moves, active, pool, un, eps, a=a)
    return _accept_update(batched_lnprob, active, active_lnp, *proposed)


def _accept_update(batched_lnprob, active, active_lnp, proposals, ln_bias, ln_u):
    with span("tier.lnprob"):
        new_lnp = batched_lnprob(proposals)
    with span("sampler.accept"):
        ln_accept = ln_bias + new_lnp - active_lnp
        # a NaN lnprob never wins
        accept = (ln_u < ln_accept) & torch.isfinite(new_lnp)
        coords = torch.where(accept[..., None], proposals, active)
        lnp = torch.where(accept, new_lnp, active_lnp)
    return coords, lnp, accept


def stretch_step(batched_lnprob: Callable, state: EnsembleState, a: float = 2.0,
                 draws: Optional[Sequence] = None,
                 move="stretch") -> EnsembleState:
    """One full ensemble step: the first half moves against the second, then
    the second against the updated first.

    ``move``: ``"stretch"``, ``"de"``, ``"snooker"`` or a weighted mixture
    (see :func:`normalize_move`).  ``draws``: the two half-steps' draws, each
    ``(un, eps)`` as :func:`draw_half` gives them (a bare ``un`` tensor for a
    move without DE); drawn from ``state.generator`` when not given.
    """
    moves = normalize_move(move)
    coords = state.coords
    n_walkers, ndim = coords.shape[-2:]
    lead = tuple(coords.shape[:-2])
    half = n_walkers // 2
    if draws is None:
        with span("sampler.draw"):
            draws = draw_step(moves, state.generator, n_walkers, ndim, coords.dtype,
                              coords.device, lead)
    draws = [d if isinstance(d, (tuple, list)) else (d, None) for d in draws]
    c0, c1 = coords[..., :half, :], coords[..., half:, :]
    p0, p1 = state.log_prob[..., :half], state.log_prob[..., half:]

    c0, p0, acc0 = half_update(batched_lnprob, moves, c0, p0, c1, *draws[0], a=a)
    c1, p1, acc1 = half_update(batched_lnprob, moves, c1, p1, c0, *draws[1], a=a)

    return EnsembleState(
        coords=torch.cat([c0, c1], dim=-2),
        log_prob=torch.cat([p0, p1], dim=-1),
        generator=state.generator,
        accepted=state.accepted + torch.cat([acc0, acc1], dim=-1).to(torch.int32),
        step=state.step + 1,
    )


def run_ensemble(batched_lnprob: Callable, initial: EnsembleState, n_steps: int,
                 a: float = 2.0, thin: int = 1, move="stretch",
                 store_chain: bool = True) -> EnsembleResult:
    """Advance the ensemble ``n_steps`` steps; with ``thin > 1`` every
    ``thin``-th step is recorded (``n_steps`` must be a multiple of it).
    ``store_chain=False`` records nothing (the chain has 0 steps).

    The generator of ``initial`` is advanced in place: ``initial`` and the
    returned ``final`` share it.
    """
    moves = normalize_move(move)
    n_walkers, ndim = initial.coords.shape[-2:]
    lead = tuple(initial.coords.shape[:-2])
    if n_walkers % 2:
        raise ValueError("Number of walkers must be even for half-ensemble moves.")
    if thin > 1 and n_steps % thin:
        raise ValueError("n_steps must be a multiple of thin.")
    thin = max(int(thin), 1)
    n_rec = n_steps // thin if store_chain else 0
    chain = torch.empty((n_rec,) + lead + (n_walkers, ndim),
                        dtype=initial.coords.dtype, device=initial.coords.device)
    lnp = torch.empty((n_rec,) + lead + (n_walkers,), dtype=initial.log_prob.dtype,
                      device=initial.coords.device)
    state = initial
    for s in range(n_steps):
        with span("sampler.step"):
            state = stretch_step(batched_lnprob, state, a=a, move=moves)
            if store_chain and (s + 1) % thin == 0:
                chain[(s + 1) // thin - 1] = state.coords
                lnp[(s + 1) // thin - 1] = state.log_prob
    n_done = max(state.step - initial.step, 1)
    acc = (state.accepted - initial.accepted).to(initial.coords.dtype) / n_done
    return EnsembleResult(chain=chain.movedim(0, -2), log_prob=lnp.movedim(0, -1),
                          final=state, acceptance_fraction=acc)
