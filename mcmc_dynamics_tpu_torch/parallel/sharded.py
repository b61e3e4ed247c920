"""Multi-device ensemble sampling: walkers over ``dp``, stars over ``sp``.

Counterpart of ``mcmc_dynamics_tpu/parallel/sharded.py``.  The scaling axes of
this workload are:

* **walkers**, the data-parallel axis.  The ensemble is split over the ranks
  of ``dp``; a half-step's partner pool is the whole opposite half,
  all-gathered over ``dp`` (W/2 x K numbers);
* **stars**, the sequence-parallel axis.  Each rank of ``sp`` holds a slice
  of the catalog; each walker's partial log-likelihood over the slice is
  summed over ``sp`` by an all-reduce and the prior is added once.

One rank a device (``parallel/mesh.py``), every rank running the same Python
step loop.  Draws are replicated: every rank advances the same generator,
seeded as a single-device run seeds it, draws each half-step's whole block
(:func:`~..sampler.stretch.draw_step`) and takes its own walkers' columns.
A rank's walkers therefore see the draws they would see on one device, and
the kernels are batch-invariant, so a run sharded over walkers alone is bit
for bit the single-device ``Runner.__call__``; with ``sp`` only the order of
the star sum changes.  (The JAX package folds its key with the dp index
instead, and its sharded run is not the unsharded one bit for bit.)  The
ranks of one ``dp`` row hold the same walkers and, after the all-reduce, the
same bits, so they take the same decisions.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..sampler.stretch import draw_step, half_update, normalize_move
from .mesh import Mesh

__all__ = ["pad_star_axis", "star_sharded_lnprob", "run_ensemble_sharded",
           "ShardedResult"]


def pad_star_axis(data: Dict[str, torch.Tensor], n_shards: int) -> Dict[str, torch.Tensor]:
    """Pad every per-star column to a multiple of ``n_shards`` stars.

    Padded lanes copy the first star (numerically benign) and get mask 0; a
    ``mask`` column is created (or extended), so the sums select them away."""
    sizes = {v.shape[0] for v in data.values()}
    if len(sizes) != 1:
        raise ValueError("All per-star arrays must share the star axis length.")
    n = sizes.pop()
    n_pad = (-n) % n_shards
    out = {}
    for name, arr in data.items():
        if n_pad:
            fill = arr[:1].expand((n_pad,) + tuple(arr.shape[1:]))
            arr = torch.cat([arr, fill], dim=0)
        out[name] = arr
    if "mask" not in out:
        ref = next(iter(data.values()))
        out["mask"] = torch.ones(n + n_pad, dtype=ref.dtype, device=ref.device)
    if n_pad:
        out["mask"] = out["mask"].clone()
        out["mask"][n:] = 0.0
    return out


def _star_slice(runner, mesh: Mesh, sp_axis: str) -> Dict[str, torch.Tensor]:
    """This rank's slice of the padded catalog (its ``sp`` block of
    ``runner.sharded_star_data()``), contiguous on the runner's device.
    Cached on the runner, keyed on the parameters, the model's settings and
    the slice, so checkpoint chunks do not rebuild it."""
    _ = runner.compiled   # refresh the parameter fingerprint
    n_sp, c = mesh.shape[sp_axis], mesh.coordinate(sp_axis)
    key = (runner._compiled_fp, runner.lnprob_cache_salt(), n_sp, c)
    cached = getattr(runner, "_sharded_data_cache", None)
    if cached is None or cached[0] != key:
        data = pad_star_axis(runner.sharded_star_data(), n_sp)
        block = data["mask"].shape[0] // n_sp
        local = {k: v[c * block:(c + 1) * block].contiguous() for k, v in data.items()}
        cached = (key, local)
        runner._sharded_data_cache = cached
    return cached[1]


def generic_partial(runner) -> Callable:
    """``fn(thetas, local) -> (W,)``: the masked sum of the model's per-star
    terms over the slice ``local``, in walker chunks of ``lnprob_chunk``
    (the star-sharded fallback where the model has no fused partial)."""

    def one(thetas, local):
        values = runner.scaled_values(thetas)
        p = {n: (v[:, None] if torch.is_tensor(v) and v.dim() == 1 else v)
             for n, v in values.items()}
        terms = runner.lnlike_terms(p, local)
        # select, not multiply: a -inf term on a padded lane x 0 is NaN
        return torch.where(local["mask"] > 0, terms, torch.zeros_like(terms)).sum(-1)

    def fn(thetas, local):
        return torch.cat([one(t, local) for t in torch.split(thetas, runner.lnprob_chunk)])

    return fn


def _star_sharded_batched(runner, mesh: Mesh, sp_axis: str, partial) -> Callable:
    """Batched lnprob (W, K) -> (W,) over this rank's star slice: the
    partial sums all-reduced over ``sp``, the prior added once after the
    sum (-inf where the prior is, whatever the partials)."""
    local = _star_slice(runner, mesh, sp_axis)
    return runner._with_prior(
        lambda thetas: mesh.all_reduce(partial(thetas, local), sp_axis))


def star_sharded_lnprob(runner, mesh: Mesh, sp_axis: str = "sp") -> Callable:
    """``lnprob(theta)`` with the star catalog sharded over ``sp_axis``:
    equal to the single-device lnprob up to the order of the star sum.

    ``theta``: (K,) (returns a 0-d tensor) or a batch (W, K).  Every rank of
    the ``sp`` line calls it with the same ``theta``; the per-star terms go
    through the model's ``lnlike_terms`` (the generic reduction)."""
    batched = _star_sharded_batched(runner, mesh, sp_axis, generic_partial(runner))

    def lnprob(theta):
        theta = torch.as_tensor(theta, dtype=runner.dtype, device=runner.device)
        if theta.dim() == 1:
            return batched(theta[None, :])[0]
        return batched(theta)

    return lnprob


class ShardedResult:
    """Output of :func:`run_ensemble_sharded`.

    ``final_coords`` (W, K), ``final_log_prob`` (W,) and ``final_key`` (the
    generator, advanced as on every rank) are whole on every rank.  The chain
    stays in this rank's walker blocks (``dp`` block d holds the first
    half's walkers ``d*w .. (d+1)*w - 1`` and the second half's likewise) until
    it is read: ``chain`` (W, S, K), ``log_prob`` (W, S), ``accepted`` and
    ``acceptance_fraction`` (W,) are gathered over ``dp`` on first access.

    .. warning:: that gather is a collective: every rank reads the attribute
       at the same point of the program.  :meth:`local_blocks` reads this
       rank's own blocks without one."""

    def __init__(self, mesh: Mesh, dp_axis: str, owner: bool, order: np.ndarray,
                 coords, lnp, generator, chain_local, lnp_local, acc_local,
                 n_steps: int):
        self.final_coords = coords
        self.final_log_prob = lnp
        self.final_key = generator
        self._mesh, self._dp = mesh, dp_axis
        self._owner = owner
        self._order = order
        self._inverse = torch.as_tensor(np.argsort(order), device=coords.device)
        self._local = (chain_local, lnp_local, acc_local)
        self._n_steps = n_steps
        self._full = {}

    def _gather(self, i: int, name: str):
        if name not in self._full:
            self._full[name] = self._mesh.all_gather(self._local[i], self._dp)[self._inverse]
        return self._full[name]

    @property
    def chain(self) -> torch.Tensor:
        return self._gather(0, "chain")

    @property
    def log_prob(self) -> torch.Tensor:
        return self._gather(1, "log_prob")

    @property
    def accepted(self) -> torch.Tensor:
        return self._gather(2, "accepted")

    @property
    def acceptance_fraction(self) -> torch.Tensor:
        return self.accepted.to(self.final_coords.dtype) / max(self._n_steps, 1)

    def local_blocks(self):
        """This rank's OWNED chain block as host arrays, no collective:
        ``[(walker_ids, chain (w, S, K), log_prob (w, S))]`` in the original
        walker numbering, or ``[]``.  The ``sp`` ranks of a ``dp`` row hold
        the same block; the one at ``sp`` coordinate 0 owns it, so exactly
        one rank writes each block."""
        if not self._owner:
            return []
        chain, lnp, _ = self._local
        w = chain.shape[0]
        d = self._mesh.coordinate(self._dp)
        return [(self._order[d * w:(d + 1) * w], chain.cpu().numpy(),
                 lnp.cpu().numpy())]


def run_ensemble_sharded(runner, coords, generator: torch.Generator, n_steps: int,
                         mesh: Mesh, dp_axis: str = "dp",
                         sp_axis: Optional[str] = "sp", a: float = 2.0,
                         move="stretch", log_prob0=None) -> ShardedResult:
    """Advance a walker-sharded ensemble ``n_steps`` steps on a mesh.

    ``coords``: (W, K), the same on every rank, with W a multiple of
    ``2 * mesh.shape[dp_axis]``; ``generator``: the sampler's generator, the
    same state on every rank (advanced in place); ``log_prob0`` (W,): the
    carried lnP of a continued run (computed when not given).  With an
    ``sp_axis`` of extent > 1 in the mesh the catalog is sharded over it:
    the model's fused partial tier (``build_lnlike_partial_batched``) where
    it has one, else the generic reduction, the partial sums all-reduced and
    the prior added once.  Without one every rank runs the model's full
    batched tier on its walkers.
    """
    moves = normalize_move(move)
    n_dp = mesh.shape[dp_axis]
    use_sp = sp_axis is not None and mesh.shape.get(sp_axis, 1) > 1
    coords = torch.as_tensor(coords, dtype=runner.dtype, device=runner.device)
    n_walkers, ndim = coords.shape
    if n_walkers % (2 * n_dp):
        raise ValueError(
            f"walkers ({n_walkers}) must be a multiple of 2*dp ({2 * n_dp})")

    if use_sp:
        partial = runner._partial_tier_cached() or generic_partial(runner)
        lnprob = _star_sharded_batched(runner, mesh, sp_axis, partial)
    else:
        lnprob = runner.batched_lnprob()

    # this rank's walkers: block d = [A_d ; B_d], A_d the first half's
    # walkers d*hl .. (d+1)*hl - 1 and B_d the second half's
    half = n_walkers // 2
    hl = half // n_dp
    d = mesh.coordinate(dp_axis)
    lo, hi = d * hl, (d + 1) * hl
    order = np.arange(n_walkers).reshape(2, n_dp, hl).transpose(1, 0, 2).reshape(-1)
    mine = torch.as_tensor(order[d * 2 * hl:(d + 1) * 2 * hl], device=coords.device)
    c_a, c_b = coords[lo:hi], coords[half + lo:half + hi]
    if log_prob0 is None:
        lnp = lnprob(coords[mine])
    else:
        lnp = torch.as_tensor(log_prob0, dtype=runner.dtype,
                              device=runner.device)[mine]
    p_a, p_b = lnp[:hl], lnp[hl:]

    chain = torch.empty((n_steps, 2 * hl, ndim), dtype=coords.dtype, device=coords.device)
    lnp_hist = torch.empty((n_steps, 2 * hl), dtype=coords.dtype, device=coords.device)
    acc = torch.zeros(2 * hl, dtype=torch.int32, device=coords.device)
    for s in range(n_steps):
        draws = draw_step(moves, generator, n_walkers, ndim, coords.dtype, coords.device)
        (un0, eps0), (un1, eps1) = draws
        pool = mesh.all_gather(c_b, dp_axis)
        c_a, p_a, acc_a = half_update(lnprob, moves, c_a, p_a, pool, un0[..., lo:hi],
                                      None if eps0 is None else eps0[..., lo:hi, :], a)
        pool = mesh.all_gather(c_a, dp_axis)
        c_b, p_b, acc_b = half_update(lnprob, moves, c_b, p_b, pool, un1[..., lo:hi],
                                      None if eps1 is None else eps1[..., lo:hi, :], a)
        chain[s, :hl], chain[s, hl:] = c_a, c_b
        lnp_hist[s, :hl], lnp_hist[s, hl:] = p_a, p_b
        acc[:hl] += acc_a.to(torch.int32)
        acc[hl:] += acc_b.to(torch.int32)

    inverse = torch.as_tensor(np.argsort(order), device=coords.device)
    final_c = mesh.all_gather(torch.cat([c_a, c_b]), dp_axis)[inverse]
    final_p = mesh.all_gather(torch.cat([p_a, p_b]), dp_axis)[inverse]
    owner = not use_sp or mesh.coordinate(sp_axis) == 0
    return ShardedResult(mesh, dp_axis, owner, order, final_c, final_p, generator,
                         chain.transpose(0, 1).contiguous(),
                         lnp_hist.transpose(0, 1).contiguous(), acc, n_steps)
