"""Drop-in ``emcee``-style :class:`EnsembleSampler` on the port's sampler core.

Counterpart of ``mcmc_dynamics_tpu/emcee_compat.py``.  Code written against
emcee — custom log-probabilities far beyond stellar kinematics — switches
with an import change:

    from mcmc_dynamics_tpu_torch.emcee_compat import EnsembleSampler

    sampler = EnsembleSampler(nwalkers, ndim, log_prob, device="cuda")
    sampler.run_mcmc(p0, 5000, progress=False)
    chain = sampler.get_chain(discard=1000, thin=10, flat=True)

Two execution paths, chosen by a probe when the sampler is made:

* **torch path** — ``log_prob`` is a torch function of one walker's
  parameters (mapped over the walkers with ``torch.func.vmap``) or, with
  ``vectorize=True``, of the (W, ndim) block: the whole chain advances on
  the sampler's device through ``sampler.stretch.run_ensemble``, with a
  ``torch.Generator`` whose state rides the backend (bitwise resume).
* **NumPy fallback** — ``log_prob`` calls code torch cannot run (scipy, I/O,
  external libraries): the JAX package's host-side half-ensemble stretch
  sampler, the same code, so a seed gives the JAX package's chain bit for
  bit.  ``pool=`` maps the walkers there.

The probe calls ``log_prob`` on a zero tensor on the sampler's device and
takes the torch path only when it returns a ``torch.Tensor`` of shape ``()``
(``(W,)`` with ``vectorize=True``; blobs, if any, tensors too) and, per
walker, when ``torch.func.vmap`` of it does as well.  A NumPy function can
accept a CPU tensor through ``__array__`` and return a NumPy value, so the
type is checked; on a card such a function raises NumPy's conversion
error, which selects the NumPy path too.  Any other error -- a kernel that
fails to build or launch, the device out of memory -- propagates.  The
choice is logged, at WARNING when a card's sampler goes to the host, and
kept in ``.backend_kind`` ("torch" or "numpy").

Supported surface: ``run_mcmc`` / ``sample`` (generator) / ``reset`` /
``get_chain`` / ``get_log_prob`` / ``get_blobs`` / ``get_last_sample`` /
``get_autocorr_time`` / ``acceptance_fraction`` / ``chain`` / ``flatchain``
/ ``lnprobability``, ``args``/``kwargs`` closures, ``vectorize=``,
``pool=``, ``backend=`` (in-memory
:class:`~mcmc_dynamics_tpu_torch.emcee_backends.Backend` or persistent
:class:`~mcmc_dynamics_tpu_torch.emcee_backends.HDFBackend`, emcee-v3
file-compatible, with bitwise restart), ``moves=`` as this package's move
specs ("stretch"/"de"/"snooker" or weighted pairs) or emcee move instances
(recognised by class name, tuned hyperparameters kept), ``thin_by``,
``store``, and **blobs**: a ``(log_prob, blobs)`` return is collected per
stored step.  On the torch path blobs are recomputed for the stored
positions in one batched call per ``run_mcmc`` (a pure function gives the
values it gave when each position was accepted).
"""

from __future__ import annotations

import logging
import numbers
from typing import Callable, Sequence

import numpy as np
import torch

from . import default_dtype, resolve_device
from . import emcee_backends as backends
from .sampler.diagnostics import AutocorrError, autocorr_time
from .sampler.stretch import (EnsembleState, init_state, make_generator,
                              normalize_move, run_ensemble)

__all__ = ["EnsembleSampler", "State", "backends"]

logger = logging.getLogger(__name__)


def _host_code_error(err: Exception) -> bool:
    """True for the errors NumPy raises when host code reads a tensor it
    cannot: a device tensor (TypeError) or a tensor under
    ``torch.func.vmap``, which has no storage.  A kernel's build error, a
    failed launch or the device out of memory is not one."""
    if isinstance(err, TypeError):
        return True
    return type(err) is RuntimeError and "doesn't have storage" in str(err)


class State:
    """Minimal emcee-compatible sampler state.

    Returned by :meth:`EnsembleSampler.run_mcmc` and
    :meth:`EnsembleSampler.get_last_sample`; can be passed back as
    ``initial_state`` (the standard emcee burn-in idiom).  It unpacks as the
    ``(coords, log_prob)`` pair older code expects.  ``blobs`` carries the
    per-walker blobs at the current position when the log-probability
    returns ``(log_prob, blobs)``; ``random_state`` exists so ported emcee
    code that reads it stays alive (always ``None`` here — the random state
    lives in the sampler and rides its backend instead).
    """

    __slots__ = ("coords", "log_prob", "blobs", "random_state")

    def __init__(self, coords, log_prob, blobs=None, random_state=None):
        self.coords = coords
        self.log_prob = log_prob
        self.blobs = blobs
        self.random_state = random_state

    # unpacks as a pair: ``coords, log_prob = state``
    def __iter__(self):
        return iter((self.coords, self.log_prob))

    def __len__(self):
        return 2

    def __getitem__(self, i):
        return (self.coords, self.log_prob)[i]

    def __repr__(self):
        return (f"State(coords={self.coords!r}, log_prob={self.log_prob!r}, "
                f"blobs={self.blobs!r})")


class _FunctionWrapper:
    """Picklable ``log_prob_fn(x, *args, **kwargs)`` closure (a lambda would
    break ``pool=`` with multiprocessing, which pickles the callable)."""

    def __init__(self, fn, args, kwargs):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs or {}

    def __call__(self, x):
        return self.fn(x, *self.args, **self.kwargs)


def _flatten(tree):
    """(leaves, rebuild) of a blob: a leaf, or tuples/lists/dicts of blobs."""
    if not isinstance(tree, (tuple, list, dict)):
        return [tree], lambda leaves: leaves[0]
    keys = list(tree) if isinstance(tree, dict) else list(range(len(tree)))
    parts = [_flatten(tree[k]) for k in keys]

    def rebuild(leaves):
        out, i = [], 0
        for sub_leaves, sub_rebuild in parts:
            out.append(sub_rebuild(leaves[i:i + len(sub_leaves)]))
            i += len(sub_leaves)
        if isinstance(tree, dict):
            return dict(zip(keys, out))
        return out if isinstance(tree, list) else tuple(out)

    return [leaf for sub_leaves, _ in parts for leaf in sub_leaves], rebuild


def _tree_map(fn, tree):
    leaves, rebuild = _flatten(tree)
    return rebuild([fn(leaf) for leaf in leaves])


def _regularize_blobs(block):
    """(W, S[, ...]) blob block -> numeric array when the blobs are uniform.

    Mirrors emcee's dtype discovery: scalar/array/tuple-of-scalar blobs
    become a plain numeric array (storable in HDF5); genuinely irregular
    blobs (dicts, ragged shapes) stay an object array."""
    if not isinstance(block, np.ndarray) or block.dtype != object:
        return block
    try:
        arr = np.asarray(block.tolist())
    except (ValueError, TypeError):
        return block
    return block if arr.dtype == object else arr


def _split_blob(out):
    """emcee return convention -> (log_prob, blob or None).

    ``log_prob`` alone, ``(log_prob, blob)``, or ``(log_prob, b1, b2, ...)``
    (the extra returns become a tuple blob, emcee's ``l[1:]`` rule).
    """
    if isinstance(out, (tuple, list)):
        if len(out) == 2:
            return out[0], out[1]
        return out[0], tuple(out[1:])
    return out, None


_EMCEE_MOVE_NAMES = {
    "StretchMove": "stretch",
    "DEMove": "de",
    "DESnookerMove": "snooker",
}
# emcee instance attribute -> this package's hyperparameter name, per move.
# emcee's DEMove calls the per-proposal jitter scale ``sigma`` and stores
# gamma0 as ``g0``; missing attributes are simply not forwarded.
_EMCEE_MOVE_ATTRS = {
    "stretch": (("a", "a"),),
    "de": (("sigma", "jitter"), ("g0", "gamma0")),
    "snooker": (("gammas", "gammas"),),
}


def _normalize_moves(moves):
    """emcee ``moves=`` (None, move instance, or [(move, weight), ...]) or this
    package's specs -> the sampler-core move argument.

    emcee move *instances* keep their tuned hyperparameters: the attributes in
    ``_EMCEE_MOVE_ATTRS`` are read off the instance and forwarded as the
    params leg of the core (name, weight, params) spec.
    """
    if moves is None:
        return "stretch"
    if isinstance(moves, str):
        return moves

    def one(m):
        """-> (name, params-dict) for a single move spec or emcee instance."""
        if isinstance(m, str):
            return m, {}
        name = type(m).__name__
        if name in _EMCEE_MOVE_NAMES:
            ours = _EMCEE_MOVE_NAMES[name]
            params = {}
            for attr, param in _EMCEE_MOVE_ATTRS[ours]:
                value = getattr(m, attr, None)
                if value is not None:
                    params[param] = float(value)
            return ours, params
        raise ValueError(
            f"Unsupported move {m!r}: use 'stretch'/'de'/'snooker', weighted "
            "pairs of those, or emcee StretchMove/DEMove/DESnookerMove "
            "instances.")

    if isinstance(moves, Sequence):
        out = []
        for entry in moves:
            # numbers.Real, not (int, float): np.float32/np.int64 weights
            # (e.g. taken from an array) are not Python-float subclasses
            if isinstance(entry, (tuple, list)) and len(entry) == 2 \
                    and isinstance(entry[1], numbers.Real):
                name, params = one(entry[0])
                out.append((name, float(entry[1]), params))
            else:
                name, params = one(entry)
                out.append((name, 1.0, params))
        return out
    name, params = one(moves)
    return [(name, 1.0, params)]


def _host(tensor) -> np.ndarray:
    return tensor.detach().cpu().numpy()


class EnsembleSampler:
    """emcee-compatible affine-invariant ensemble sampler (see module doc).

    Beside emcee's arguments: ``seed`` (the sampler's random state), and
    ``dtype`` and ``device`` of the torch path (default: ``"cuda"``, in
    float32; pass ``device="cpu"`` for the CPU, in float64).
    """

    def __init__(self, nwalkers: int, ndim: int, log_prob_fn: Callable,
                 args=(), kwargs=None, moves=None, a: float = 2.0,
                 vectorize: bool = False, seed: int = 0, dtype=None,
                 pool=None, backend=None, device="cuda"):
        if nwalkers % 2:
            raise ValueError("nwalkers must be even (half-ensemble moves).")
        if nwalkers < 2 * ndim:
            logger.warning("nwalkers (%d) < 2*ndim (%d): stretch moves mix poorly "
                           "on thin ensembles.", nwalkers, ndim)
        self.nwalkers = int(nwalkers)
        self.ndim = int(ndim)
        self.a = float(a)
        self._moves = _normalize_moves(moves)
        kwargs = kwargs or {}
        self._vectorize = bool(vectorize)
        self._fn = _FunctionWrapper(log_prob_fn, args, kwargs) \
            if (args or kwargs) else log_prob_fn
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device) if dtype is None else dtype
        self._rng = np.random.default_rng(seed)
        self._pool = pool

        self.has_blobs = False    # numpy path flips this on first tuple return
        self.backend_kind = self._probe_backend()
        self._batched = None
        self._blob_batched = None
        if self.backend_kind == "torch":
            fn = self._fn
            if self.has_blobs:
                # the sampler core sees only the scalar leg; blobs are
                # recomputed for the stored positions afterwards
                def lnp_only(x):
                    return _split_blob(fn(x))[0]

                def blob_only(x):
                    return _split_blob(fn(x))[1]

                self._batched = (lnp_only if self._vectorize
                                 else torch.func.vmap(lnp_only))
                self._blob_batched = (blob_only if self._vectorize
                                      else torch.func.vmap(blob_only))
            else:
                self._batched = fn if self._vectorize else torch.func.vmap(fn)
        self._live_blobs = None   # numpy path: (W,) object array, current pos
        self._state = None        # EnsembleState, or (pos, lnp) for numpy
        self.backend = backend if backend is not None else backends.Backend()
        if self.backend.initialized:
            have = (self.backend.nwalkers, self.backend.ndim)
            if have != (self.nwalkers, self.ndim):
                raise ValueError(
                    f"backend holds a {have} chain, sampler is "
                    f"({self.nwalkers}, {self.ndim}); reset the backend or "
                    "match the shapes.")
        else:
            self.backend.reset(self.nwalkers, self.ndim)

    # ------------------------------------------------------------------ backends
    def _probe_backend(self) -> str:
        """'torch' when log_prob, called on a zero tensor on the device,
        returns a tensor of the expected shape (optionally plus tensor
        blobs), per walker also under ``torch.func.vmap``; else 'numpy'.
        Sets ``self.has_blobs``."""
        shape = (self.nwalkers, self.ndim) if self._vectorize else (self.ndim,)
        expected = (self.nwalkers,) if self._vectorize else ()
        reason = "ok"
        try:
            lnp, blob = _split_blob(self._fn(torch.zeros(shape, dtype=self.dtype,
                                                         device=self.device)))
            self.has_blobs = blob is not None
            leaves = [lnp] + (_flatten(blob)[0] if blob is not None else [])
            if not all(isinstance(leaf, torch.Tensor) for leaf in leaves):
                reason = f"it returned {type(lnp).__name__}, not torch tensors"
            elif tuple(lnp.shape) != expected:
                reason = f"its log_prob has shape {tuple(lnp.shape)}, not {expected}"
            elif not self._vectorize:
                mapped, _ = _split_blob(torch.func.vmap(self._fn)(torch.zeros(
                    (self.nwalkers, self.ndim), dtype=self.dtype, device=self.device)))
                if tuple(mapped.shape) != (self.nwalkers,):
                    reason = f"under torch.func.vmap it gave shape {tuple(mapped.shape)}"
        except (TypeError, RuntimeError) as err:
            if not _host_code_error(err):
                raise
            reason = f"{type(err).__name__}: {err}"
        kind = "torch" if reason == "ok" else "numpy"
        level = (logging.WARNING if kind == "numpy" and self.device.type != "cpu"
                 else logging.INFO)
        logger.log(level, "EnsembleSampler: log_prob on a zero %s tensor on %s -> "
                   "the %s path%s", tuple(shape), self.device, kind,
                   "" if kind == "torch" else f" ({reason})")
        return kind

    def _lnprob_batched_np(self, pos: np.ndarray):
        """(log_prob (W,), blobs object (W,) or None) on the host path.

        The first tuple-returning evaluation switches blob collection on —
        the numpy path cannot know before calling the function (emcee probes
        the same way)."""
        if self._vectorize:
            lnp, blob = _split_blob(self._fn(pos))
            lnp = np.asarray(lnp, dtype=np.float64)
            if blob is None:
                return lnp, None
            self.has_blobs = True
            blobs = np.empty(len(lnp), dtype=object)
            for i in range(len(lnp)):
                blobs[i] = _tree_map(lambda leaf: leaf[i], blob)
            return lnp, blobs
        outs = (list(self._pool.map(self._fn, pos)) if self._pool is not None
                else [self._fn(p) for p in pos])
        pairs = [_split_blob(v) for v in outs]
        lnp = np.array([float(l) for l, _b in pairs], dtype=np.float64)
        if pairs and pairs[0][1] is None:
            return lnp, None
        self.has_blobs = True
        blobs = np.empty(len(pairs), dtype=object)
        for i, (_l, b) in enumerate(pairs):
            blobs[i] = b
        return lnp, blobs

    # ------------------------------------------------------------------ emcee API
    def run_mcmc(self, initial_state, nsteps: int, progress: bool = False,
                 thin_by: int = 1, store: bool = True, **kwargs):
        """Advance the chain ``nsteps`` steps from ``initial_state`` (or from
        the current state when ``initial_state`` is None).  Returns the final
        :class:`State` (attribute access like emcee's State, unpacks as a
        (coords, log_prob) pair); it may be passed back as ``initial_state``
        — the standard burn-in idiom ``state = sampler.run_mcmc(p0, n);
        sampler.reset(); sampler.run_mcmc(state, m)`` works."""
        del progress  # accepted for signature parity
        if kwargs:
            logger.warning("run_mcmc: ignoring unsupported keyword arguments %s",
                           list(kwargs))
        if initial_state is not None:
            # emcee passes State objects around; also accept a bare
            # (coords, log_prob) pair from older code
            if hasattr(initial_state, "coords"):
                initial_state = initial_state.coords
            elif (isinstance(initial_state, (tuple, list))
                  and len(initial_state) == 2
                  and np.shape(initial_state[0]) == (self.nwalkers, self.ndim)):
                initial_state = initial_state[0]
            pos = np.asarray(initial_state, dtype=np.float64)
            if pos.shape != (self.nwalkers, self.ndim):
                raise ValueError(
                    f"initial_state has shape {pos.shape}, expected "
                    f"{(self.nwalkers, self.ndim)}.")
            self._init_from(pos)
        elif self._state is None and not self._restore_from_backend():
            raise ValueError("No initial_state, no previous state, and the "
                             "backend holds no chain: pass starting positions "
                             "on the first run_mcmc call.")

        nsteps, thin_by = int(nsteps), int(thin_by)
        if thin_by < 1:
            raise ValueError(f"thin_by must be >= 1 (got {thin_by}).")
        if nsteps < 0:
            raise ValueError(f"nsteps must be >= 0 (got {nsteps}).")
        n_props = nsteps * thin_by
        if self.backend_kind == "torch":
            start = self._state
            result = run_ensemble(self._batched, start, n_steps=n_props, a=self.a,
                                  thin=thin_by, move=self._moves, store_chain=store)
            final = result.final
            blob_block = final_blobs = None
            if self.has_blobs:
                if store and nsteps:
                    # one extra batched evaluation per stored step: the blobs
                    # of the stored positions, stacked (W, S, ...)
                    blob_block = _regularize_blobs(self._blob_block_np(
                        torch.func.vmap(self._blob_batched, in_dims=1,
                                        out_dims=1)(result.chain), n_axes=2))
                final_blobs = self._blob_block_np(self._blob_batched(final.coords),
                                                  n_axes=1)
            self.backend.append(
                _host(result.chain) if store else None,
                _host(result.log_prob) if store else None,
                _host(final.accepted - start.accepted), n_props,
                {"coords": _host(final.coords), "log_prob": _host(final.log_prob),
                 "key_data": final.generator.get_state().numpy(),
                 "key_impl": "torch", "rng_state": None},
                blob_block=blob_block)
            self._state = final
            return State(_host(final.coords), _host(final.log_prob),
                         blobs=final_blobs)

        pos, lnp = self._state
        chain = np.empty((self.nwalkers, nsteps, self.ndim)) if store else None
        lnps = np.empty((self.nwalkers, nsteps)) if store else None
        blob_block = None
        accepted = np.zeros(self.nwalkers)
        for s in range(n_props):
            pos, lnp, acc = self._numpy_step(pos, lnp)
            accepted += acc
            if store and (s + 1) % thin_by == 0:
                chain[:, s // thin_by, :] = pos
                lnps[:, s // thin_by] = lnp
                if self.has_blobs:
                    if blob_block is None:
                        blob_block = np.empty((self.nwalkers, nsteps),
                                              dtype=object)
                    blob_block[:, s // thin_by] = self._live_blobs
        self._state = (pos, lnp)
        self.backend.append(
            chain if store else None, lnps if store else None,
            accepted, n_props,
            {"coords": pos.copy(), "log_prob": lnp.copy(),
             "key_data": None, "key_impl": None,
             "rng_state": self._rng.bit_generator.state},
            blob_block=_regularize_blobs(blob_block))
        return State(pos.copy(), lnp.copy(),
                     blobs=None if self._live_blobs is None
                     else self._live_blobs.copy())

    def sample(self, initial_state=None, iterations: int = 1, tune: bool = False,
               thin_by: int = 1, store: bool = True, progress: bool = False):
        """emcee's step-by-step generator: yields a :class:`State` after each
        stored iteration (``thin_by`` proposal steps apiece).

        Prefer :meth:`run_mcmc` for throughput; ``sample`` exists for
        emcee-style convergence monitoring and custom stopping rules.
        ``progress=True`` wraps the loop in tqdm when available."""
        del tune  # parity only: there are no tunable proposal scales here
        it = range(int(iterations))
        if progress:
            try:
                from tqdm import tqdm
                it = tqdm(it, total=int(iterations))
            except ImportError:
                pass
        first = initial_state
        for _ in it:
            state = self.run_mcmc(first, 1, thin_by=thin_by, store=store)
            first = None
            yield state

    def reset(self):
        """Drop the stored chain and counters, keeping the current position.

        With a persistent backend this clears the file's chain group, exactly
        like emcee's ``backend.reset``."""
        self.backend.reset(self.nwalkers, self.ndim)

    # ------------------------------------------------------------------ accessors
    @property
    def acceptance_fraction(self) -> np.ndarray:
        return self.backend.accepted / max(self.backend.proposals, 1)

    def get_chain(self, flat: bool = False, thin: int = 1, discard: int = 0):
        """(steps, walkers, ndim) — emcee v3 layout."""
        return self.backend.get_chain(flat=flat, thin=thin, discard=discard)

    def get_log_prob(self, flat: bool = False, thin: int = 1, discard: int = 0):
        return self.backend.get_log_prob(flat=flat, thin=thin, discard=discard)

    def get_blobs(self, flat: bool = False, thin: int = 1, discard: int = 0):
        """(steps, walkers, ...) blobs in emcee's layout, or None when the
        log-probability returns no blobs.  Array blobs come back as a numeric
        array; structured blobs (tuples/dicts) as an object array."""
        return self.backend.get_blobs(flat=flat, thin=thin, discard=discard)

    def get_last_sample(self):
        if self._state is None:
            return self.backend.get_last_sample()
        if self.backend_kind == "torch":
            blobs = None
            if self.has_blobs:
                blobs = self._blob_block_np(self._blob_batched(self._state.coords),
                                            n_axes=1)
            return State(_host(self._state.coords), _host(self._state.log_prob),
                         blobs=blobs)
        return State(self._state[0].copy(), self._state[1].copy(),
                     blobs=None if self._live_blobs is None
                     else self._live_blobs.copy())

    def get_autocorr_time(self, discard: int = 0, thin: int = 1, c: float = 5.0,
                          tol: float = 50.0, quiet: bool = False):
        sub = np.swapaxes(self.get_chain(discard=discard, thin=thin), 0, 1)
        tau = autocorr_time(sub, c=c) * thin
        n_eff = sub.shape[1] * thin
        if not quiet and np.any(tau * tol > n_eff):
            raise AutocorrError(
                tau, f"The chain is shorter than tol={tol:g} times the "
                     f"integrated autocorrelation time; run longer, lower "
                     "tol, or pass quiet=True.")
        return tau

    # emcee v2 attribute surface
    @property
    def chain(self) -> np.ndarray:
        """(walkers, steps, ndim) — the emcee v2 layout."""
        return self.backend._full_chain()

    @property
    def flatchain(self) -> np.ndarray:
        return self.chain.reshape(-1, self.ndim)

    @property
    def lnprobability(self) -> np.ndarray:
        return self.backend._full_lnp()

    @property
    def iteration(self) -> int:
        """Stored steps so far — emcee's meaning, so ``tau * tol <
        sampler.iteration`` convergence loops keep their semantics under
        ``thin_by`` (tau is measured on the stored, already-thinned chain)."""
        return self.backend.iteration

    @property
    def proposals(self) -> int:
        """Total proposal steps made (= ``iteration * thin_by``); this is the
        denominator of :attr:`acceptance_fraction`."""
        return self.backend.proposals

    # ------------------------------------------------------------------ internals
    @staticmethod
    def _blob_block_np(blob, n_axes: int):
        """Torch blob (a tensor, or tuples/dicts of tensors) with ``n_axes``
        leading batch axes -> NumPy block.

        A single-tensor blob becomes a numeric array (the emcee fast path);
        structured blobs become an object array of per-element structures,
        which is what emcee degrades to as well when it cannot discover a
        uniform dtype."""
        leaves, rebuild = _flatten(blob)
        leaves = [_host(leaf) for leaf in leaves]
        if not isinstance(blob, (tuple, list, dict)):
            return leaves[0]
        shape = leaves[0].shape[:n_axes]
        out = np.empty(shape, dtype=object)
        for idx in np.ndindex(shape):
            out[idx] = rebuild([leaf[idx] for leaf in leaves])
        return out

    def _restore_from_backend(self) -> bool:
        """Rebuild the live sampler state from the backend's saved payload
        (cross-process resume); bitwise when the payload carries this path's
        random state."""
        payload = self.backend.load_state()
        if payload is None:
            return False
        coords = np.asarray(payload["coords"], dtype=np.float64)
        if coords.shape != (self.nwalkers, self.ndim):
            raise ValueError(
                f"backend state has shape {coords.shape}, expected "
                f"{(self.nwalkers, self.ndim)}.")
        if self.backend_kind == "torch":
            if payload.get("key_data") is not None \
                    and payload.get("key_impl") == "torch":
                gen = torch.Generator(device=self.device)
                gen.set_state(torch.as_tensor(np.asarray(payload["key_data"],
                                                         dtype=np.uint8)))
            else:
                # a chain written by real emcee (or another package's key)
                # carries no torch generator state; reseed
                gen = make_generator(int(self._rng.integers(0, 2 ** 31)), self.device)
            self._state = EnsembleState(
                coords=torch.as_tensor(coords, dtype=self.dtype, device=self.device),
                log_prob=torch.as_tensor(np.asarray(payload["log_prob"]),
                                         dtype=self.dtype, device=self.device),
                generator=gen,
                accepted=torch.zeros(self.nwalkers, dtype=torch.int32,
                                     device=self.device),
                step=0)
        else:
            if payload.get("rng_state") is not None:
                self._rng.bit_generator.state = payload["rng_state"]
            # copy: np.asarray can alias the backend's saved array, which
            # _numpy_step then mutates in place
            self._state = (coords.copy(),
                           np.array(payload["log_prob"], dtype=np.float64))
            if getattr(self.backend, "has_blobs", False):
                # one batched evaluation rebuilds the live per-walker blobs at
                # the restored position (they are not persisted as state)
                _, self._live_blobs = self._lnprob_batched_np(self._state[0])
        return True

    def _init_from(self, pos: np.ndarray):
        if self.backend_kind == "torch":
            gen = make_generator(int(self._rng.integers(0, 2 ** 31)), self.device)
            self._state = init_state(self._batched,
                                     torch.as_tensor(pos, dtype=self.dtype,
                                                     device=self.device), gen)
            lnp0 = _host(self._state.log_prob)
        else:
            lnp0, self._live_blobs = self._lnprob_batched_np(pos)
            self._state = (pos.copy(), lnp0)
        bad = ~np.isfinite(lnp0)
        if bad.all():
            raise ValueError("All walkers start at log_prob = -inf/nan.")

    def _stretch_spec(self):
        """(a_values, weights) when every move in the spec is a stretch move
        (the only kind the host-side fallback implements), else None."""
        moves = normalize_move(self._moves)
        if any(name != "stretch" for name, _w, _p in moves):
            return None
        return (np.array([dict(p).get("a", self.a) for _n, _w, p in moves]),
                np.array([w for _n, w, _p in moves]))

    def _numpy_step(self, pos, lnp):
        """One full step (both half-ensembles) of the host-side sampler.

        Stretch moves only on this path (the fallback exists for log-probs
        torch cannot run; DE/snooker need the torch path)."""
        spec = self._stretch_spec()
        if spec is None:
            raise NotImplementedError(
                "The numpy fallback supports stretch moves only; write the "
                "log-probability in torch (the torch path) to use DE/snooker "
                "moves.")
        a_values, weights = spec
        w = self.nwalkers
        half = w // 2
        acc_total = np.zeros(w)
        idx_a = np.arange(half)
        idx_b = np.arange(half, w)
        for active_idx, other_idx in ((idx_a, idx_b), (idx_b, idx_a)):
            if len(a_values) == 1:
                a = a_values[0]
            else:   # per-walker draw over a stretch-only mixture
                a = a_values[self._rng.choice(len(a_values), half, p=weights)]
            z = ((a - 1.0) * self._rng.random(half) + 1.0) ** 2 / a
            partners = other_idx[self._rng.integers(0, half, half)]
            prop = pos[partners] + z[:, None] * (pos[active_idx] - pos[partners])
            lnp_prop, blobs_prop = self._lnprob_batched_np(prop)
            ln_acc = (self.ndim - 1) * np.log(z) + lnp_prop - lnp[active_idx]
            accept = np.log(self._rng.random(half)) < ln_acc
            accept &= np.isfinite(lnp_prop)
            pos[active_idx[accept]] = prop[accept]
            lnp[active_idx[accept]] = lnp_prop[accept]
            if blobs_prop is not None:
                if self._live_blobs is None:     # blobs appeared mid-run
                    self._live_blobs = np.empty(w, dtype=object)
                self._live_blobs[active_idx[accept]] = blobs_prop[accept]
            acc_total[active_idx] += accept
        return pos, lnp, acc_total
