"""emcee-style chain backends for :mod:`mcmc_dynamics_tpu_torch.emcee_compat`.

The port's own copy of ``mcmc_dynamics_tpu/emcee_backends.py`` (that module
loads no JAX, but the port imports nothing of the JAX package).  emcee v3's
backends (``emcee.backends.Backend`` / ``HDFBackend``) are the standard way
long astronomy runs survive restarts; this module gives the same surface over
the port's sampler:

* :class:`Backend` — in-memory storage (the default inside
  :class:`~mcmc_dynamics_tpu_torch.emcee_compat.EnsembleSampler`);
* :class:`HDFBackend` — persistent HDF5 storage.  The file layout matches
  emcee v3 (group with ``chain`` (steps, walkers, ndim), ``log_prob``
  (steps, walkers), ``accepted`` (walkers,), ``iteration`` attr, and a
  ``blobs`` dataset + ``has_blobs`` attr when the log-probability returns
  blobs), so chains written here open with real emcee and with the JAX
  package's backend, and vice versa.  On top of emcee's layout the sampler's
  random state is stored (the torch generator's state bytes under
  ``key_data`` with ``key_impl = "torch"``, or the NumPy bit-generator state
  as ``rng_state``), which makes a restart bitwise-identical to an
  uninterrupted run.  ``h5py`` is imported only when an HDFBackend is made.

The sampler appends whole blocks (one ``run_mcmc`` call) instead of one step
at a time, so the backend write cost is amortised.

Usage, exactly the emcee idiom::

    from mcmc_dynamics_tpu_torch.emcee_compat import EnsembleSampler, backends

    backend = backends.HDFBackend("chain.h5")
    sampler = EnsembleSampler(64, 5, log_prob, backend=backend)
    sampler.run_mcmc(p0, 5000)

    # ... later, any process: resume or just read
    backend = backends.HDFBackend("chain.h5")
    print(backend.iteration, backend.get_chain(discard=100, flat=True).shape)
    sampler = EnsembleSampler(64, 5, log_prob, backend=backend)
    sampler.run_mcmc(None, 5000)        # continues bitwise from the file
"""

from __future__ import annotations

import json

import numpy as np

__all__ = ["Backend", "HDFBackend"]


class Backend:
    """In-memory chain storage with the emcee v3 backend surface."""

    def __init__(self):
        self.nwalkers = None
        self.ndim = None
        self._chain = None          # (W, capacity, K) buffer, first _len used
        self._lnp = None            # (W, capacity)
        self._blobs = None          # (W, capacity, *blob_shape) or object
        self._len = 0               # stored steps
        self._accepted = None       # (W,) float
        self._proposals = 0
        self._state = None          # payload dict (see append())

    # ------------------------------------------------------------- lifecycle
    @property
    def initialized(self) -> bool:
        return self.nwalkers is not None

    def reset(self, nwalkers: int, ndim: int):
        """Clear all stored samples and counters and fix the shape."""
        self.nwalkers = int(nwalkers)
        self.ndim = int(ndim)
        self._chain = None
        self._lnp = None
        self._blobs = None
        self._len = 0
        self._accepted = np.zeros(self.nwalkers)
        self._proposals = 0
        self._state = None

    # ------------------------------------------------------------- counters
    @property
    def iteration(self) -> int:
        """Number of *stored* steps (emcee's meaning)."""
        return self._len

    @property
    def proposals(self) -> int:
        """Total proposal steps made (≥ iteration when thinning)."""
        return self._proposals

    @property
    def accepted(self) -> np.ndarray:
        """(walkers,) cumulative accepted-proposal counts."""
        return self._accepted

    @property
    def has_blobs(self) -> bool:
        """True once blob blocks have been stored."""
        return self._blobs is not None

    # ------------------------------------------------------------- writing
    def append(self, chain_block, lnp_block, accepted_delta, proposals_delta,
               state, blob_block=None):
        """Record one sampler advance.

        ``chain_block``: (W, S, K) or None when the run did not store;
        ``lnp_block``: (W, S) or None; ``accepted_delta``: (W,) accepted
        counts in this advance; ``proposals_delta``: proposal steps made;
        ``state``: payload dict with keys ``coords`` (W, K), ``log_prob``
        (W,), and either ``key_data``/``key_impl`` (the torch path: the
        generator's state bytes and ``"torch"``) or ``rng_state`` (NumPy
        path) for exact resume; ``blob_block``:
        (W, S, *blob_shape) numeric or (W, S) object array, or None.
        """
        if chain_block is not None:
            block = np.asarray(chain_block)
            lnpb = np.asarray(lnp_block)
            n = block.shape[1]
            if blob_block is None and self._blobs is not None and n:
                # emcee raises the same way: silently misaligned blobs are
                # worse than a failed resume
                raise ValueError(
                    "Inconsistent use of blobs: the stored chain has blobs "
                    "but this advance provides none (did you resume a blob "
                    "chain with a blob-less log-probability?).")
            if n:
                self._ensure_capacity(self._len + n, block.dtype, lnpb.dtype,
                                      blob_block)
                self._chain[:, self._len:self._len + n] = block
                self._lnp[:, self._len:self._len + n] = lnpb
                if blob_block is not None:
                    self._blobs[:, self._len:self._len + n] = blob_block
                self._len += n
        self._accepted = self._accepted + np.asarray(accepted_delta)
        self._proposals += int(proposals_delta)
        self._state = dict(state)

    def _ensure_capacity(self, need: int, chain_dtype, lnp_dtype,
                         blob_block=None):
        """Geometric buffer growth: appends stay amortised O(1) per stored
        step even in emcee's one-step-per-iteration ``sample()`` monitoring
        loops (a block list re-concatenated per read would be quadratic)."""
        cap = 0 if self._chain is None else self._chain.shape[1]
        if blob_block is not None and self._blobs is None and self._len:
            raise ValueError(
                "Blobs appeared after blob-less steps were stored; reset the "
                "backend (the stored chain has no blob history).")
        if need <= cap and (blob_block is None or self._blobs is not None):
            return
        new_cap = max(need, 2 * cap, 64)
        chain = np.empty((self.nwalkers, new_cap, self.ndim),
                         dtype=chain_dtype if self._chain is None
                         else self._chain.dtype)
        lnp = np.empty((self.nwalkers, new_cap),
                       dtype=lnp_dtype if self._lnp is None
                       else self._lnp.dtype)
        if self._len:
            chain[:, :self._len] = self._chain[:, :self._len]
            lnp[:, :self._len] = self._lnp[:, :self._len]
        self._chain, self._lnp = chain, lnp
        if blob_block is not None or self._blobs is not None:
            proto = self._blobs if self._blobs is not None else blob_block
            blobs = np.empty((self.nwalkers, new_cap) + proto.shape[2:],
                             dtype=proto.dtype)
            if self._blobs is not None and self._len:
                blobs[:, :self._len] = self._blobs[:, :self._len]
            self._blobs = blobs

    def load_state(self):
        """The resume payload from the most recent :meth:`append`, or None."""
        return None if self._state is None else dict(self._state)

    # ------------------------------------------------------------- reading
    def _full_chain(self) -> np.ndarray:
        """(W, S_total, K) view of the stored chain."""
        if not self._len:
            raise AttributeError("No chain stored yet: call run_mcmc first.")
        return self._chain[:, :self._len]

    def _full_lnp(self) -> np.ndarray:
        if not self._len:
            raise AttributeError("No chain stored yet: call run_mcmc first.")
        return self._lnp[:, :self._len]

    def get_chain(self, flat: bool = False, thin: int = 1, discard: int = 0):
        """(steps, walkers, ndim) — emcee v3 layout and thinning semantics
        (``[discard + thin - 1::thin]``: the *last* step of each thin window,
        exactly what real emcee returns on the same chain)."""
        v = np.swapaxes(self._full_chain(), 0, 1)[discard + thin - 1::thin]
        return v.reshape(-1, self.ndim) if flat else v

    def get_log_prob(self, flat: bool = False, thin: int = 1, discard: int = 0):
        v = np.swapaxes(self._full_lnp(), 0, 1)[discard + thin - 1::thin]
        return v.reshape(-1) if flat else v

    def get_blobs(self, flat: bool = False, thin: int = 1, discard: int = 0):
        """(steps, walkers, ...) blobs, or None when none were stored (emcee
        returns None too).  Object arrays of uniform numeric blobs are
        regularised to a plain numeric array."""
        if self._blobs is None:
            return None
        v = np.swapaxes(self._blobs[:, :self._len], 0, 1)
        v = v[discard + thin - 1::thin]
        if v.dtype == object:
            try:            # scalar/array blobs stored via the object path
                vv = np.asarray(v.tolist())
                if vv.dtype != object:
                    v = vv
            except (ValueError, TypeError):
                pass
        return v.reshape((-1,) + v.shape[2:]) if flat else v

    def get_last_sample(self):
        from .emcee_compat import State
        payload = self.load_state()
        if payload is None:
            raise AttributeError("No samples stored yet: call run_mcmc first.")
        coords = np.asarray(payload["coords"])
        # emcee's get_last_sample carries blobs; attach the last stored blob
        # column when it corresponds to this position (every store=True
        # advance ends on a thin boundary, so the final state IS the last
        # stored step — a store=False tail leaves them misaligned, so skip)
        blobs = self._last_stored_blobs(coords) if self.has_blobs else None
        return State(coords, np.asarray(payload["log_prob"]), blobs=blobs)

    def _last_stored_blobs(self, coords):
        """Last stored (W, ...) blob column iff it belongs to ``coords``."""
        if self._len and np.array_equal(coords, self._chain[:, self._len - 1]):
            return self._blobs[:, self._len - 1].copy()
        return None


class HDFBackend(Backend):
    """Persistent HDF5 backend, file-layout-compatible with emcee v3.

    Parameters mirror emcee: ``filename`` and HDF5 group ``name``
    (default ``"mcmc"``), ``read_only=True`` opens without write intent.
    All reads/writes open the file per operation, so a crashed process never
    holds the file hostage and several readers can watch a running chain.
    """

    def __init__(self, filename: str, name: str = "mcmc",
                 read_only: bool = False):
        try:
            import h5py  # noqa: F401
        except ImportError as exc:
            raise ImportError(
                "HDFBackend needs h5py; use the in-memory Backend or install "
                "h5py.") from exc
        self.filename = str(filename)
        self.name = str(name)
        self.read_only = bool(read_only)

    def _open(self, mode: str = "r"):
        import h5py
        if self.read_only and mode != "r":
            raise RuntimeError(
                f"HDFBackend({self.filename!r}) is read-only; cannot write.")
        return h5py.File(self.filename, mode)

    # ------------------------------------------------------------- lifecycle
    @property
    def initialized(self) -> bool:
        import os
        if not os.path.exists(self.filename):
            return False
        if os.path.getsize(self.filename) == 0:
            return False          # pre-created empty file: nothing stored
        # an existing, non-empty file that cannot be opened (locked by a
        # writer, corrupt) must RAISE: returning False here would send
        # EnsembleSampler.__init__ into backend.reset(), which deletes the
        # stored chain group — silent data loss on a transient lock
        with self._open() as f:
            return self.name in f

    def reset(self, nwalkers: int, ndim: int):
        nwalkers, ndim = int(nwalkers), int(ndim)
        with self._open("a") as f:
            if self.name in f:
                del f[self.name]
            g = f.create_group(self.name)
            g.attrs["version"] = 3          # emcee v3 layout
            g.attrs["nwalkers"] = nwalkers
            g.attrs["ndim"] = ndim
            g.attrs["iteration"] = 0
            g.attrs["proposals"] = 0
            g.attrs["has_blobs"] = False
            g.create_dataset("chain", (0, nwalkers, ndim),
                             maxshape=(None, nwalkers, ndim), dtype="f8")
            g.create_dataset("log_prob", (0, nwalkers),
                             maxshape=(None, nwalkers), dtype="f8")
            g.create_dataset("accepted", data=np.zeros(nwalkers))

    def _group(self, f):
        if self.name not in f:
            raise AttributeError(
                f"No group {self.name!r} in {self.filename!r}: the backend "
                "was never reset/written.")
        return f[self.name]

    def _shape_attr(self, attr: str, axis: int):
        """nwalkers/ndim: our attr when present, else the chain dataset's
        shape (files written by real emcee carry no such attrs)."""
        if not self.initialized:
            return None
        with self._open() as f:
            g = self._group(f)
            if attr in g.attrs:
                return int(g.attrs[attr])
            return int(g["chain"].shape[axis])

    @property
    def nwalkers(self):
        return self._shape_attr("nwalkers", 1)

    @property
    def ndim(self):
        return self._shape_attr("ndim", 2)

    # ------------------------------------------------------------- counters
    @property
    def iteration(self) -> int:
        if not self.initialized:
            return 0
        with self._open() as f:
            return int(self._group(f).attrs["iteration"])

    @property
    def proposals(self) -> int:
        if not self.initialized:
            return 0
        with self._open() as f:
            g = self._group(f)
            # a file written by real emcee has no proposals attr; every
            # stored step was one proposal there
            return int(g.attrs.get("proposals", g.attrs["iteration"]))

    @property
    def accepted(self) -> np.ndarray:
        if not self.initialized:
            raise AttributeError(
                f"{self.filename!r} holds no chain yet: nothing accepted.")
        with self._open() as f:
            return np.asarray(self._group(f)["accepted"])

    @property
    def has_blobs(self) -> bool:
        if not self.initialized:
            return False
        with self._open() as f:
            return bool(self._group(f).attrs.get("has_blobs", False))

    # ------------------------------------------------------------- writing
    def append(self, chain_block, lnp_block, accepted_delta, proposals_delta,
               state, blob_block=None):
        if blob_block is not None and blob_block.dtype == object:
            raise NotImplementedError(
                "HDFBackend stores array blobs only (uniform shape/dtype); "
                "tuple/dict blobs need the in-memory Backend — exactly "
                "emcee's own constraint for files.")
        with self._open("a") as f:
            g = self._group(f)
            if chain_block is not None:
                block = np.swapaxes(np.asarray(chain_block), 0, 1)  # (S, W, K)
                lnp = np.swapaxes(np.asarray(lnp_block), 0, 1)      # (S, W)
                if blob_block is None and block.shape[0] \
                        and g.attrs.get("has_blobs", False):
                    raise ValueError(
                        "Inconsistent use of blobs: the stored chain has "
                        "blobs but this advance provides none (did you "
                        "resume a blob chain with a blob-less "
                        "log-probability?).")
                n0 = int(g.attrs["iteration"])
                g["chain"].resize(n0 + block.shape[0], axis=0)
                g["chain"][n0:] = block
                g["log_prob"].resize(n0 + lnp.shape[0], axis=0)
                g["log_prob"][n0:] = lnp
                if blob_block is not None:
                    blobs = np.swapaxes(blob_block, 0, 1)   # (S, W, ...)
                    if "blobs" not in g:
                        if n0:
                            raise ValueError(
                                "Blobs appeared after blob-less steps were "
                                "stored; reset the backend.")
                        g.create_dataset(
                            "blobs", (0,) + blobs.shape[1:],
                            maxshape=(None,) + blobs.shape[1:],
                            dtype=blobs.dtype)
                        g.attrs.modify("has_blobs", True)
                    g["blobs"].resize(n0 + blobs.shape[0], axis=0)
                    g["blobs"][n0:] = blobs
                # attrs.modify updates in place; plain assignment is a
                # delete+add in the object header, which leaks a 4 kB header
                # continuation block per open/append/close cycle
                g.attrs.modify("iteration", n0 + block.shape[0])
            g["accepted"][:] = (np.asarray(g["accepted"])
                                + np.asarray(accepted_delta))
            g.attrs.modify("proposals", int(g.attrs.get("proposals", 0))
                           + int(proposals_delta))
            # overwrite the state datasets IN PLACE: HDF5 never reclaims the
            # storage of a deleted dataset, so a del/create per append leaks
            # ~(W*K + W) * 8 bytes of dead file space on every step of an
            # emcee-style sample() monitoring loop.  Datasets are (re)created
            # only when absent or when their shape changed (never, in
            # practice, after a reset).
            def _put(key, data):
                if key in g and g[key].shape == data.shape \
                        and g[key].dtype == data.dtype:
                    g[key][...] = data
                else:
                    if key in g:
                        del g[key]
                    g.create_dataset(key, data=data)

            _put("last_coords", np.asarray(state["coords"], dtype="f8"))
            _put("last_log_prob", np.asarray(state["log_prob"], dtype="f8"))
            # random state: write the current kind and clear the OTHER kind,
            # so a torch-path resume never replays a stale numpy stream (or
            # vice versa) after the execution path switched between runs
            if state.get("key_data") is not None:
                _put("key_data", np.asarray(state["key_data"]))
                g.attrs.modify("key_impl", str(state["key_impl"]))
            else:
                if "key_data" in g:
                    del g["key_data"]
                if "key_impl" in g.attrs:
                    del g.attrs["key_impl"]
            if state.get("rng_state") is not None:
                g.attrs.modify("rng_state", json.dumps(state["rng_state"]))
            elif "rng_state" in g.attrs:
                del g.attrs["rng_state"]

    def load_state(self):
        if not self.initialized:
            return None
        with self._open() as f:
            g = self._group(f)
            n = int(g.attrs["iteration"])
            if "last_coords" in g:
                coords = np.asarray(g["last_coords"])
                log_prob = np.asarray(g["last_log_prob"])
            elif n > 0:
                # a chain written by real emcee: resume from the last stored
                # step (emcee's own get_last_sample semantics); no PRNG
                # state.  Index by the iteration attr, NOT -1: emcee's grow()
                # pre-sizes the datasets, so rows beyond iteration are zeros.
                coords = np.asarray(g["chain"][n - 1])
                log_prob = np.asarray(g["log_prob"][n - 1])
            else:
                return None
            payload = {"coords": coords, "log_prob": log_prob,
                       "key_data": None, "key_impl": None, "rng_state": None}
            if "key_data" in g:
                payload["key_data"] = np.asarray(g["key_data"])
                payload["key_impl"] = str(g.attrs["key_impl"])
            if "rng_state" in g.attrs:
                payload["rng_state"] = json.loads(g.attrs["rng_state"])
            return payload

    # ------------------------------------------------------------- reading
    def _read(self, name: str, thin: int, discard: int) -> np.ndarray:
        """Slice ``[discard+thin-1 : iteration : thin]`` inside HDF5 so only
        the requested rows are read from disk (emcee semantics; also skips
        any pre-grown zero rows in files written by real emcee)."""
        with self._open() as f:
            g = self._group(f)
            n = int(g.attrs["iteration"])
            if n == 0:
                raise AttributeError(
                    "No chain stored yet: call run_mcmc first.")
            return np.asarray(g[name][discard + thin - 1:n:thin])

    def get_chain(self, flat: bool = False, thin: int = 1, discard: int = 0):
        v = self._read("chain", thin, discard)
        return v.reshape(-1, v.shape[-1]) if flat else v

    def get_log_prob(self, flat: bool = False, thin: int = 1, discard: int = 0):
        v = self._read("log_prob", thin, discard)
        return v.reshape(-1) if flat else v

    def get_blobs(self, flat: bool = False, thin: int = 1, discard: int = 0):
        if not self.has_blobs:
            return None
        v = self._read("blobs", thin, discard)
        return v.reshape((-1,) + v.shape[2:]) if flat else v

    def _full_chain(self) -> np.ndarray:
        return np.swapaxes(self._read("chain", 1, 0), 0, 1)

    def _full_lnp(self) -> np.ndarray:
        return np.swapaxes(self._read("log_prob", 1, 0), 0, 1)

    def _last_stored_blobs(self, coords):
        """Last stored (W, ...) blob row iff it belongs to ``coords`` (the
        HDF5 layout is steps-major, like emcee's)."""
        with self._open() as f:
            g = self._group(f)
            n = int(g.attrs["iteration"])
            if n and "blobs" in g and np.array_equal(
                    coords, np.asarray(g["chain"][n - 1])):
                return np.asarray(g["blobs"][n - 1])
        return None
