"""The comparison that decides ``correct``: the reference judges, step by
step, what the window's fits produced.

The program's sampler is the affine-invariant ensemble's stretch move
(Goodman & Weare 2010): each step moves the first half of the walkers
against the second, then the second against the updated first.  A
half-step draws one block of uniforms (3, n) from the fit's generator,
``torch.rand`` on the walkers' device in their dtype, seeded with the fit's
seed: for walker i the stretch factor z = ((a - 1) u0 + 1)^2 / a, the
partner j = min(floor(u1 n_pool), n_pool - 1) of the other half, and the
acceptance draw ln u2.  The proposal y = x_j + z (x_i - x_j) is accepted where
ln u2 < (K - 1) ln z + lnP(y) - lnP(x_i).

The check replays those draws from the fit's seed and, for a sample of
blocks of consecutive steps drawn from the run's seed, takes each step's
starting positions from what the program recorded (the chain's previous
step, the fit's initial walkers at step 0, and for the second half the
program's updated first half), and works out the proposals and decisions
itself with the reference's float64 lnprob.  So it follows the program step
by step from the program's own state; the start (step 0, from the walkers
the harness handed in) is checked by itself in every run.  Numbers:

* ``lnp_gap``: the widest gap between the lnprob the program recorded and
  the reference's at the same position, where both are finite (the prior
  and the likelihood tier);
* ``accept_margin``: where the program's accept decision differs from the
  reference's, the widest distance of ln u2 from the reference's
  ln(acceptance), 0 where none differs (the moves' acceptance);
* ``finite_mismatch`` (exact): recorded positions where one of the two
  lnprobs is finite and the other not, and differing decisions where the
  reference's ln(acceptance) is not finite (the prior's bounds);
* ``accept_rule`` (exact): steps after the first at which a walker's
  move breaks the Metropolis rule by the program's own recorded lnprobs: a
  move made although ln u2 >= (K - 1) ln z + lnP(y) - lnP(x_i), with lnP(y)
  the lnprob recorded after the move and lnP(x_i) the one before, beyond the
  float32 rounding of that sum (``ROUNDING`` of its terms' magnitudes), or a
  walker that stayed and whose lnprob changed (the acceptance rule itself,
  at every checked step, whatever the gap of the program's lnprob to the
  reference's);
* ``stray_moves`` (exact): moved walkers further than ``STRAY`` from the
  proposal (the moves' arithmetic: the proposals are formed in the
  program's dtype and order of operations, from its own draws);
* ``ckpt_mismatch`` (exact): the elements of each checkpoint on disk that
  differ from the chain, lnprob and final state the fit returned.
"""

from __future__ import annotations

import numpy as np
import torch

from .harness import seed_int

__all__ = ["judge", "replay_draws", "sample_blocks"]

# a moved walker further than this, relative, from the replayed proposal
# went somewhere the move cannot take it: thirty float32 roundings, far
# above what a different order of the same float32 operations gives
STRAY = 1e-5
# the float32 rounding of (K - 1) ln z + lnP(y) - lnP(x), as a share of the
# sum of its terms' magnitudes: two roundings of half a unit in the last
# place (2^-24 each) at most, taken four times over
ROUNDING = 4.0 * 2.0 ** -23


def replay_draws(seed, n_walkers, n_steps, dtype, device):
    """The uniforms of the first ``n_steps`` steps of a fit seeded with
    ``seed``: two arrays (n_steps, 3, n) in ``dtype``, one a half."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    half = n_walkers // 2
    first, second = [], []
    for _ in range(n_steps):
        first.append(torch.rand((3, half), generator=gen, dtype=dtype, device=device))
        second.append(torch.rand((3, n_walkers - half), generator=gen, dtype=dtype,
                                 device=device))
    return torch.stack(first).cpu(), torch.stack(second).cpu()


def sample_blocks(lengths, n_blocks, block_steps, seed):
    """{fit index: sorted step indices} of the blocks to check: the first
    fit's first block and the last fit's last one, and ``n_blocks - 2``
    drawn from the seed over every step of every fit."""
    fits = [i for i, n in enumerate(lengths) if n > 0]
    if not fits:
        return {}
    offsets = np.cumsum([0] + [lengths[i] for i in fits])
    starts = [(fits[0], 0), (fits[-1], max(lengths[fits[-1]] - block_steps, 0))]
    rng = np.random.default_rng(seed_int(seed, 4))
    for g in rng.integers(0, offsets[-1], size=max(n_blocks - 2, 0)):
        k = int(np.searchsorted(offsets, g, side="right")) - 1
        starts.append((fits[k], int(g - offsets[k])))
    out = {}
    for f, s in starts:
        s = min(s, max(lengths[f] - block_steps, 0))
        out.setdefault(f, set()).update(range(s, min(s + block_steps, lengths[f])))
    return {f: np.array(sorted(steps)) for f, steps in sorted(out.items())}


def _reference_lnprob(ref, rows):
    """The reference's lnprob of (M, K) float64 rows, as float64 numpy."""
    return ref(torch.as_tensor(rows, dtype=torch.float64)).double().cpu().numpy()


def _half_proposals(active, pool, un, a):
    """(proposals, ln_bias, ln_u) of one half for M steps at once, in the
    program's dtype and order of operations: active (M, n, K) and pool
    (M, m, K) as the program held them, un (M, 3, n) its uniforms."""
    n_pool, ndim = pool.shape[1], pool.shape[2]
    idx = torch.clamp((un[:, 1] * n_pool).to(torch.int64), max=n_pool - 1)
    z = ((a - 1.0) * un[:, 0] + 1.0) ** 2 / a
    partners = torch.gather(pool, 1, idx[..., None].expand(*idx.shape, ndim))
    y = partners + z[..., None] * (active - partners)
    return y, (ndim - 1.0) * torch.log(z), torch.log(un[:, 2])


def check_fit(ref, rec, steps, a, dtype, device):
    """The numbers of one fit's checked ``steps``."""
    chain = torch.as_tensor(rec["chain"]).to(dtype)         # (W, S, K) as recorded
    lnp = np.asarray(rec["lnprob"], np.float64)              # (W, S)
    n_walkers = chain.shape[0]
    half = n_walkers // 2
    start = torch.as_tensor(rec["pos"], dtype=dtype)
    u_first, u_second = replay_draws(rec["seed"], n_walkers, int(steps[-1]) + 1,
                                     dtype, device)

    # the reference's lnprob at every recorded position the steps start from
    # or end at (-1: the initial walkers)
    rows = np.array(sorted(set(steps.tolist()) | set((steps - 1).tolist())))
    pos = torch.stack([start if r < 0 else chain[:, r] for r in rows])   # (R, W, K)
    lp = _reference_lnprob(ref, pos.reshape(-1, pos.shape[-1]).double()).reshape(
        pos.shape[:2])
    at = {int(r): i for i, r in enumerate(rows)}
    recorded = rows >= 0
    got = lnp[:, rows[recorded]].T
    want = lp[recorded]
    both = np.isfinite(got) & np.isfinite(want)
    lnp_gap = float(np.max(np.abs(got[both] - want[both]), initial=0.0))
    finite_mismatch = int(np.sum(np.isfinite(got) != np.isfinite(want)))

    prev = pos[[at[int(s) - 1] for s in steps]]                          # (M, W, K)
    new = chain[:, steps].transpose(0, 1)
    lp_prev = lp[[at[int(s) - 1] for s in steps]]
    one = _half_proposals(prev[:, :half], prev[:, half:], u_first[steps], a)
    two = _half_proposals(prev[:, half:], new[:, :half], u_second[steps], a)
    y, ln_bias, ln_u = (torch.cat([p, q], dim=1).double().numpy()
                        for p, q in zip(one, two))
    prev, new = prev.double().numpy(), new.double().numpy()
    lp_y = _reference_lnprob(ref, y.reshape(-1, y.shape[-1])).reshape(y.shape[:2])
    with np.errstate(invalid="ignore"):
        ln_accept = ln_bias + lp_y - lp_prev
        accept = (ln_u < ln_accept) & np.isfinite(lp_y)
    moved = np.any(new != prev, axis=-1)
    differ = accept != moved
    finite = np.isfinite(ln_accept)
    accept_margin = float(np.max(np.abs(ln_u - ln_accept)[differ & finite], initial=0.0))
    finite_mismatch += int(np.sum(differ & ~finite))
    rel = np.max(np.abs(new - y) / np.maximum(np.abs(y), 1e-30), axis=-1)
    stray_moves = int(np.sum(moved & (rel > STRAY)))

    # the rule by the program's own lnprobs, where the one before the step
    # was recorded (every step but a fit's first)
    later = steps >= 1
    lnp_after = lnp[:, steps[later]].T                                   # (M', W)
    lnp_before = lnp[:, steps[later] - 1].T
    bias, draw, went = ln_bias[later], ln_u[later], moved[later]
    with np.errstate(invalid="ignore"):
        own = bias + lnp_after - lnp_before
        slack = ROUNDING * (np.abs(bias) + np.abs(lnp_after) + np.abs(lnp_before))
        broken = went & ~(draw < own + slack)
    kept_changed = ~went & ~((lnp_after == lnp_before)
                             | (np.isnan(lnp_after) & np.isnan(lnp_before)))
    accept_rule = int(np.sum(broken) + np.sum(kept_changed))
    return dict(lnp_gap=lnp_gap, accept_margin=accept_margin, accept_rule=accept_rule,
                stray_moves=stray_moves, finite_mismatch=finite_mismatch,
                walker_steps=int(steps.size * n_walkers))


def checkpoint_mismatch(rec):
    """Elements of the fit's checkpoint on disk that differ from what the
    fit returned (the chain and lnprob of a fit that completed; the final
    state's coords, lnprob and step count of every fit)."""
    if rec["prefix"] is None or rec["chain"] is None:
        return 0
    with np.load(f"{rec['prefix']}_chain.npz") as f:
        disk = {k: np.asarray(f[k]) for k in ("chain", "lnprob", "coords", "log_prob",
                                              "step")}
    chain, lnp = rec["chain"], rec["lnprob"]
    pairs = [(disk["coords"], chain[:, -1]), (disk["log_prob"], lnp[:, -1]),
             (disk["step"], np.asarray(chain.shape[1]))]
    if rec["completed"]:
        pairs += [(disk["chain"], chain), (disk["lnprob"], lnp)]
    bad = 0
    for got, want in pairs:
        if got.shape != want.shape:
            bad += max(got.size, want.size)
        else:
            bad += int(np.sum(~((got == want) | (np.isnan(got) & np.isnan(want)))))
    return bad


def judge(cell, ref, fits, seed, device, dtype):
    """{number: {value, limit}} of the window's fits; each is correct where
    its value is at most its limit."""
    spec = cell.spec["check"]
    lengths = [0 if r["chain"] is None else r["chain"].shape[1] for r in fits]
    blocks = sample_blocks(lengths, int(spec["blocks"]), int(spec["block_steps"]), seed)
    numbers = dict(lnp_gap=0.0, accept_margin=0.0, accept_rule=0, stray_moves=0,
                   finite_mismatch=0)
    checked = 0
    for f, steps in blocks.items():
        got = check_fit(ref, fits[f], steps, float(cell.spec["a"]), dtype, device)
        checked += got.pop("walker_steps")
        for k in ("lnp_gap", "accept_margin"):
            numbers[k] = max(numbers[k], got[k])
        for k in ("accept_rule", "stray_moves", "finite_mismatch"):
            numbers[k] += got[k]
    numbers["ckpt_mismatch"] = sum(checkpoint_mismatch(r) for r in fits)
    limits = spec["limits"]
    out = {k: {"value": v, "limit": float(limits[k])} for k, v in numbers.items()}
    # a window that produced nothing to check is not correct
    out["no_steps_checked"] = {"value": float(checked == 0), "limit": 0.0}
    return out
