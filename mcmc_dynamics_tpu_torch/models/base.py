"""Model base class: host shell compiling data + parameters into a batched lnprob.

Counterpart of ``mcmc_dynamics_tpu/models/base.py``; ``mesh=`` runs the
multi-device samplers of ``parallel/`` (one rank a device).  Observables
are converted to internal units on the host in float64 and then placed on the
model's device in its working dtype.  A batched lnprob maps a (W, K) walker
block to (W,); the sampler runs it on half-ensembles.  Checkpoints are
``.npz`` files with the reference's keys, so the JAX package reads the chains
this package writes.  The plotting methods import matplotlib when they draw,
and only then.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import pathlib
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import default_dtype, resolve_device
from .. import units as u
from ..expressions import compile_torch
from ..ops import dispatch
from ..parameters import CompiledParameters, Parameters
from ..profiling import count, fit_span, span
from ..sampler.diagnostics import AutocorrError, autocorr_time
from ..sampler.hmc import init_hmc, run_hmc
from ..sampler.stretch import (EnsembleState, init_state, make_generator,
                               run_ensemble)
from ..sampler.tempered import (TemperedState, init_tempered, log_evidence,
                                make_beta_ladder, run_tempered)
from ..utils.coordinates import get_amplitude_and_angle, xy_offset_rad
from ..utils.data import DataReader
from ..utils.table import Table

logger = logging.getLogger(__name__)

# the bundled parameter files (model.json, ...), copies of the reference's
_CONFIG_DIR = pathlib.Path(__file__).resolve().parents[1] / "config"


class Runner:
    """Base class of the port's models.

    Subclasses declare ``MODEL_PARAMETERS``, ``OBSERVABLES`` (column -> unit
    string) and ``INTERNAL_UNITS`` (parameter -> unit of the likelihood), and
    implement ``lnlike_terms(p, data)`` on a walker batch: ``p`` values are
    (w, 1) columns or floats, ``data`` columns (N,), the result (w, N).
    """

    MODEL_PARAMETERS: list = []
    OBSERVABLES: dict = {"v": "km/s", "verr": "km/s"}
    INTERNAL_UNITS: dict = {}
    parameters_file: Optional[str] = None

    # observables converted to these units before they reach the device
    _OBSERVABLE_INTERNAL = {"v": "km/s", "verr": "km/s", "ra": "rad", "dec": "rad",
                            "density": None, "pmember": None}

    # walkers per slice of the generic batched lnprob (bounds its (w, N) temporaries)
    lnprob_chunk = 64

    def __init__(self, data, parameters: Optional[Parameters] = None,
                 seed: int = 123, background=None, device="cuda", dtype=None):
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device) if dtype is None else dtype
        self.seed = seed

        if not isinstance(data, DataReader):
            raise TypeError("'data' must be a DataReader instance.")
        self.data = data
        if ("ra" in self.OBSERVABLES or "dec" in self.OBSERVABLES) \
                and not data.has_coordinates:
            raise IOError("Missing WCS coordinates of observed data.")

        self._data_arrays: Dict[str, torch.Tensor] = {}
        self._host_arrays: Dict[str, np.ndarray] = {}
        for name, unit in self.OBSERVABLES.items():
            if name not in data.data:
                raise IOError(f"Input data missing required column <{name}>")
            col = data.data[name]
            if isinstance(col, u.Quantity):
                if col.unit.is_unity() and not u.parse_unit(unit).is_unity():
                    logger.warning("Missing units for <%s> values. Assuming %s.",
                                   name, unit)
                    values = np.asarray(col.value, dtype=np.float64)
                else:
                    values = col.to(u.parse_unit(unit)).value.astype(np.float64)
            else:
                values = np.asarray(col, dtype=np.float64)
            internal = self._OBSERVABLE_INTERNAL.get(name)
            if internal is not None:
                values = values * u.parse_unit(unit).conversion_factor(
                    u.parse_unit(internal))
            self._host_arrays[name] = values
            self._data_arrays[name] = self._to_device(values)

        if parameters is None:
            parameters = self.default_parameters()
        if not isinstance(parameters, Parameters):
            raise TypeError("'parameters' must be a Parameters instance.")
        missing = set(self.MODEL_PARAMETERS).difference(parameters)
        if missing:
            raise IOError(f"Missing required parameter(s): '{missing}'")
        unused = set(parameters).difference(self.MODEL_PARAMETERS)
        if unused:
            logger.warning("Superfluous parameter(s) provided: '%s'", unused)
        if parameters.rng_seed is None:
            parameters.reseed(seed)
        self.parameters = parameters

        # background population (field stars): per-star ln-likelihoods are
        # data, computed once on the host in float64 (reference runner.py:96-106)
        self.background = background
        if background is not None:
            if "pmember" not in data.data:
                raise IOError("Background population requires a 'pmember' column "
                              "with prior membership probabilities.")
            lnl_back = np.asarray(background(data.data["v"], data.data["verr"]),
                                  dtype=np.float64)
            pmember = np.asarray(data.data.value("pmember"), dtype=np.float64)
            for name, values in (("lnlike_background", lnl_back), ("pmember", pmember)):
                self._host_arrays[name] = values
                self._data_arrays[name] = self._to_device(values)

        self._compiled: Optional[CompiledParameters] = None
        self._compiled_fp = None
        self._lnprob_batched_cache = None
        self._partial_tier_cache = None

    def _to_device(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.float64), dtype=self.dtype,
                               device=self.device)

    # ------------------------------------------------------------------ class helpers
    @classmethod
    def default_parameters(cls) -> Parameters:
        if cls.parameters_file is None:
            raise NotImplementedError
        return Parameters().load(_CONFIG_DIR / cls.parameters_file)

    # ------------------------------------------------------------------ properties
    @property
    def n_data(self) -> int:
        return self.data.sample_size

    @property
    def compiled(self) -> CompiledParameters:
        fp = self.parameters.fingerprint()
        if self._compiled is None or fp != self._compiled_fp:
            self._compiled = CompiledParameters(self.parameters, self.device,
                                                self.dtype)
            self._compiled_fp = fp
        return self._compiled

    @property
    def fitted_parameters(self):
        return self.compiled.free_names

    @property
    def n_fitted_parameters(self) -> int:
        return self.compiled.n_free

    @property
    def units(self):
        """Every parameter's declared unit, by name."""
        return {n: p.unit for n, p in self.parameters.items()}

    @property
    def labels(self):
        return [self.parameters[n].plot_label() for n in self.fitted_parameters]

    def observed(self, name: str) -> torch.Tensor:
        """The observed column ``name`` as the likelihood reads it: internal
        units, on the model's device in its dtype."""
        return self._data_arrays[name]

    # ------------------------------------------------------------------ batched pieces
    def scaled_values(self, theta: torch.Tensor) -> Dict[str, object]:
        """theta (W, K) in declared units -> every parameter in internal units."""
        values = self.compiled.expand(theta)
        factors = self.compiled.scale_factors(
            {n: unit for n, unit in self.INTERNAL_UNITS.items() if n in values})
        return {n: (v * factors[n] if n in factors else v) for n, v in values.items()}

    def lnlike_terms(self, p, data):
        return torch.zeros_like(data["v"])

    def lnlike_fn(self, p, data):
        """Log-likelihood: the masked sum of the per-star terms."""
        return masked_sum(self.lnlike_terms(p, data), data)

    def extra_lnprior_fn(self, p):
        """Hook for a model's joint prior in internal units: ``p`` as
        :meth:`scaled_values` gives it ((W,) columns, floats for fixed
        parameters); 0 or -inf per walker.  No joint prior by default."""
        return 0.0

    def _has_extra_lnprior(self) -> bool:
        return type(self).extra_lnprior_fn is not Runner.extra_lnprior_fn

    def prepare_data(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Hook: precomputed columns that are static given the fixed parameters."""
        return data

    def build_lnprob_batched(self) -> Callable:
        """Generic batched lnprob (W, K) -> (W,): expand, joint prior,
        ``lnlike_fn``, in slices of ``lnprob_chunk`` walkers.  Plain torch: the
        reference leaves this path to XLA."""
        compiled = self.compiled
        data = self.prepare_data(dict(self._data_arrays))
        extra = self._has_extra_lnprior()

        def one(thetas):
            with span("tier.chunk"):
                lp = compiled.lnprior(thetas)
                values = self.scaled_values(thetas)
                if extra:
                    lp = lp + self.extra_lnprior_fn(values)
                p = {n: (v[:, None] if torch.is_tensor(v) and v.dim() == 1 else v)
                     for n, v in values.items()}
                ll = self.lnlike_fn(p, data)
                return torch.where(torch.isfinite(lp), lp + ll,
                                   torch.full_like(lp, -math.inf))

        def batched(thetas):
            return torch.cat([one(t) for t in torch.split(thetas, self.lnprob_chunk)])

        return batched

    def _with_prior(self, lnlike: Callable) -> Callable:
        """Batched lnprob = lnprior (+ the joint prior, where the model has
        one) + ``lnlike(thetas)`` (in a ``tier.lnlike`` span), -inf wherever
        the prior is (the likelihood tiers' common wrapper)."""
        lnprior = self.compiled.lnprior
        extra = self._has_extra_lnprior()

        def batched(thetas):
            lp = lnprior(thetas)
            if extra:
                lp = lp + self.extra_lnprior_fn(self.scaled_values(thetas))
            with span("tier.lnlike"):
                ll = lnlike(thetas)
            return torch.where(torch.isfinite(lp), lp + ll,
                               torch.full_like(lp, -math.inf))

        return batched

    # ------------------------------------------------------------------ one walker
    def _one_walker(self, theta) -> torch.Tensor:
        """A parameter vector (K,) as a (1, K) batch on the model's device."""
        if torch.is_tensor(theta):
            theta = theta.to(device=self.device, dtype=self.dtype)
        else:
            theta = self._to_device(theta)
        return theta.reshape(1, -1)

    def lnprior(self, theta) -> torch.Tensor:
        """Prior of one parameter vector (declared units), without the joint
        prior, as in the reference (``base.py:320-321``)."""
        return self.compiled.lnprior(self._one_walker(theta))[0]

    def lnlike(self, theta) -> torch.Tensor:
        """Log-likelihood of one parameter vector through ``lnlike_fn``."""
        p = self.scaled_values(self._one_walker(theta))
        return self.lnlike_fn(p, self.prepare_data(dict(self._data_arrays)))

    def build_lnprob(self) -> Callable:
        """The pure log-posterior of one parameter vector: ``theta`` (K,) in
        declared units -> a scalar: prior, joint prior and ``lnlike_fn``, -inf
        where the prior is not finite (the reference's per-walker closure,
        ``base.py:229-242``).  Plain torch on the model's device, not a
        kernel tier."""
        compiled = self.compiled
        data = self.prepare_data(dict(self._data_arrays))

        def lnprob(theta):
            thetas = self._one_walker(theta)
            lp = compiled.lnprior(thetas)
            p = self.scaled_values(thetas)
            lp = lp + self.extra_lnprior_fn(p)
            ll = self.lnlike_fn(p, data)
            return torch.where(torch.isfinite(lp), lp + ll,
                               torch.full_like(lp, -math.inf))[0]

        return lnprob

    def lnprob(self, theta) -> torch.Tensor:
        """Log-posterior of one parameter vector (:meth:`build_lnprob`)."""
        return self.build_lnprob()(theta)

    def program_cache_salt(self) -> tuple:
        """Hook: the model's settings besides its parameters that
        ``build_lnprob_batched`` reads (the JAM models' MGE, quadrature orders,
        chunks and tier knobs); none by default.  A change of it rebuilds the
        cached tiers and the star-sharded slices."""
        return ()

    def _kernel_tier(self, tier: str) -> bool:
        """:func:`ops.use_kernel` for this model's device and dtype, consulted
        once as ``tier`` is built and logged: ``kernel``, or ``plain`` and
        why.  False binds the plain version beside the kernel."""
        why = dispatch.plain_reason(self.device, self.dtype)
        logger.info("%s %s tier: %s", type(self).__name__, tier,
                    "kernel" if why is None else f"plain ({why})")
        return why is None

    def _tier_cached(self, slot: str, build: Callable):
        """``build()``, kept in attribute ``slot`` and rebuilt only when the
        parameters, the tier choice (``MCMC_TPU_LNPROB``), the kernel switch
        (:func:`ops.dispatch.kernels_disabled`) or
        :meth:`program_cache_salt` change."""
        _ = self.compiled  # refresh fingerprint
        key = (self._compiled_fp, os.environ.get("MCMC_TPU_LNPROB", "auto"),
               dispatch.kernels_disabled(), self.program_cache_salt())
        cached = getattr(self, slot)
        if cached is None or cached[0] != key:
            count("tier.builds")
            cached = (key, build())
            setattr(self, slot, cached)
        return cached[1]

    def batched_lnprob(self) -> Callable:
        """The batched lnprob the sampler runs: ``build_lnprob_batched``,
        rebuilt only when :meth:`_tier_cached`'s key changes.  Building it
        is the set-up cost of a tier (the tensor tier's tables); later calls
        return the same one."""
        return self._tier_cached("_lnprob_batched_cache", self.build_lnprob_batched)

    def build_lnlike_partial_batched(self) -> Optional[Callable]:
        """Hook: the model's fused partial log-likelihood, or None.

        A model whose kernel reduces the stars by a plain sum returns
        ``fn(thetas, local) -> (W,)``: the partial sum over the per-star slice
        ``local`` (:meth:`sharded_star_data`'s columns, padded, with ``mask``).
        The star-sharded sampler (``parallel/sharded.py``) all-reduces the
        partials over the star axis and adds the prior once.  None: the
        sampler reduces the model's ``lnlike_terms`` instead."""
        return None

    def sharded_star_data(self) -> Dict[str, torch.Tensor]:
        """The per-star columns the star-sharded tiers read, whole (the
        sampler pads them and keeps this rank's slice): :meth:`prepare_data`'s
        columns."""
        return self.prepare_data(dict(self._data_arrays))

    def _partial_tier_cached(self) -> Optional[Callable]:
        """:meth:`build_lnlike_partial_batched`, rebuilt only when
        :meth:`batched_lnprob` would be."""
        return self._tier_cached("_partial_tier_cache",
                                 self.build_lnlike_partial_batched)

    def build_lnprob_differentiable(self) -> Callable:
        """The batched lnprob (W, K) -> (W,) that HMC differentiates: the
        generic tier, plain torch (the counterpart of the JAX package's
        per-walker closure ``build_lnprob``).  The kernel and table tiers
        have no backward, so they stay off the gradient path."""
        return Runner.build_lnprob_batched(self)

    def _validated_initials(self, pos, n_walkers: int) -> np.ndarray:
        """Draw (if needed) and validate (W, K) starting positions: right
        shape and a finite lnprior for every walker."""
        if pos is None:
            pos = self.get_initials(n_walkers)
        pos = np.asarray(pos, dtype=np.float64)
        if pos.shape != (n_walkers, self.n_fitted_parameters):
            raise ValueError(
                f"Array with starting values has invalid shape {pos.shape}; "
                f"expected {(n_walkers, self.n_fitted_parameters)}.")
        lp = self.compiled.lnprior(self._to_device(pos))
        bad = ~np.isfinite(lp.cpu().numpy())
        if bad.any():
            i = int(np.argmax(bad))
            raise ValueError(f"Invalid initial guesses for walker {i}: "
                             f"{self.fitted_parameters}={pos[i]}")
        return pos

    def center_is_fixed(self) -> bool:
        """True when the cluster centre is not sampled."""
        for name in ("ra_center", "dec_center"):
            if name not in self.parameters:
                return False
            par = self.parameters[name]
            if not par.fixed or par.expr is not None:
                return False
        return True

    def fixed_center_offsets(self):
        """Host float64 (dx, dy) offsets in radians for the fixed centre."""
        ra_c = self.parameters["ra_center"].quantity.to(u.rad).value
        dec_c = self.parameters["dec_center"].quantity.to(u.rad).value
        return xy_offset_rad(self._host_arrays["ra"], self._host_arrays["dec"],
                             float(ra_c), float(dec_c), xp=np)

    # ------------------------------------------------------------ free centre
    _FC_COLUMNS = ("fc_dx0", "fc_dy0", "fc_pm", "fc_qm", "fc_b0")

    def _freecenter_constants(self):
        """Host float64 star constants of the exact shifted-centre van de
        Ven+06 projection, in ARCMIN units (derivation:
        ``ops.lnlike_kernels.model_freecenter_lnlike_reference``).  The
        reference point is the catalog median centre — the trig identities are
        exact at ANY walker offset; the point only anchors the float64
        precomputation (the large spherical terms cancel analytically into
        dx0/dy0 instead of catastrophically in f32).  Memoized: catalog-only."""
        cached = getattr(self, "_fc_constants", None)
        if cached is not None:
            return cached
        arcmin_per_rad = 10800.0 / math.pi
        ra = np.asarray(self._host_arrays["ra"], np.float64)     # rad
        dec = np.asarray(self._host_arrays["dec"], np.float64)
        ra0 = float(np.median(ra))
        dec0 = float(np.median(dec))
        s0, c0 = float(np.sin(dec0)), float(np.cos(dec0))
        d = ra - ra0
        pm = arcmin_per_rad * np.cos(dec) * np.cos(d)
        qm = arcmin_per_rad * np.cos(dec) * np.sin(d)
        sm = arcmin_per_rad * np.sin(dec)
        dx0 = -qm
        dy0 = sm * c0 - pm * s0
        b0 = sm * s0 + pm * c0
        self._fc_constants = ((ra0, dec0, s0, c0), (dx0, dy0, pm, qm, b0))
        return self._fc_constants

    def add_freecenter_columns(self, data):
        """Ship the shifted-centre star constants as per-star data columns:
        free-centre likelihoods evaluate the projection from them with
        per-WALKER trig only (:meth:`freecenter_offsets_arcmin`)."""
        _, tabs = self._freecenter_constants()
        for name, tab in zip(self._FC_COLUMNS, tabs):
            data[name] = self._to_device(tab)
        return data

    def freecenter_offsets_arcmin(self, p, data):
        """(dx, dy) arcmin offsets at the walker's sampled centre, from the
        fc_* data columns — the exact trig-identity form (no small-offset
        expansion; equals xy_offset_rad in exact arithmetic at any offset).
        A centre coordinate held fixed arrives as a Python float."""
        (ra0, dec0, s0, c0), _ = self._freecenter_constants()
        eps = p["ra_center"] - ra0
        eta = p["dec_center"] - dec0
        ue = _sin(eps)
        we = 2.0 * _sin(0.5 * eps) ** 2          # 1 - cos(eps), stable
        un = _sin(eta)
        wn = 2.0 * _sin(0.5 * eta) ** 2
        rdel = data["fc_qm"] * ue - data["fc_pm"] * we
        dx = data["fc_dx0"] + (data["fc_pm"] * ue + data["fc_qm"] * we)
        a_ = data["fc_dy0"] - s0 * rdel
        b_ = data["fc_b0"] + c0 * rdel
        return dx, a_ - (wn * a_ + un * b_)

    def get_initials(self, n_walkers: int) -> np.ndarray:
        return self.compiled.sample_initials(n_walkers)

    def _sufficient_s_max(self) -> float:
        """Upper grid edge in s = sigma_max^2 for the table tiers: from the
        ``sigma_max`` prior bound when finite, else 1e6, which truncates the
        unbounded prior at 1000 km/s (announced, as in the reference)."""
        sigma_hi = self.parameters["sigma_max"].max
        if np.isfinite(sigma_hi):
            return float(min(1e8, max(1e4, (2.0 * float(sigma_hi)) ** 2)))
        logger.warning(
            "sigma_max has no finite upper bound; the table tier truncates the "
            "prior at sigma_max = 1000 km/s (walkers beyond get -inf). Set a "
            "finite max on 'sigma_max', or set MCMC_TPU_LNPROB=direct to keep "
            "the exact unbounded prior.")
        return 1.0e6

    # ------------------------------------------------------------------ fitting
    def __call__(self, n_walkers: int = 100, n_steps: int = 500, n_burn: int = 100,
                 n_out: Optional[int] = None, pos=None, a: float = 2.0,
                 thin: int = 1, move="stretch", seed: Optional[int] = None,
                 plot: bool = False, prefix: Optional[str] = "sampler",
                 true_values=None, state: Optional[EnsembleState] = None,
                 telemetry=None, n_threads: Optional[int] = None,
                 **kwargs) -> "SamplerResult":
        """Run the MCMC analysis; returns a :class:`SamplerResult`.

        The reference's signature (``n_burn`` is accepted and not used while
        sampling; ``n_threads`` is accepted and ignored).  ``move``: a move
        or a weighted mixture (:func:`~..sampler.stretch.normalize_move`).
        With ``n_out`` the run goes in chunks of ``n_out`` steps and, with a
        ``prefix``, checkpoints ``{prefix}_chain.npz`` after each and at the
        end.  ``state=`` (e.g. from :meth:`load_state`) continues a run bit
        for bit.  ``telemetry`` (a
        :class:`~..profiling.SamplerTelemetry`) records each chunk's wall
        time, the fetch of its chain to the host included; ``plot=True``
        draws ``{prefix}_chains.png`` (a failed plot is logged, never
        raised).

        ``mesh=`` (a :class:`~..parallel.Mesh`, with ``dp_axis=`` and
        ``sp_axis=``, default ``"dp"`` and ``"sp"``) runs the same analysis
        on every rank of the mesh: walkers over ``dp_axis``, the catalog over
        ``sp_axis`` where the mesh has it (:meth:`_call_sharded`).
        """
        del n_burn, n_threads
        mesh = kwargs.pop("mesh", None)
        dp_axis = kwargs.pop("dp_axis", "dp")
        sp_axis = kwargs.pop("sp_axis", "sp")
        if kwargs:
            logger.warning("Ignoring unsupported keyword arguments: %s", list(kwargs))
        if mesh is not None:
            if thin != 1:
                raise NotImplementedError(
                    "thin= is not supported with mesh= (the sharded sampler "
                    "records every step).")
            sampler = self._call_sharded(mesh, dp_axis, sp_axis, n_walkers=n_walkers,
                                         n_steps=n_steps, n_out=n_out, pos=pos, a=a,
                                         move=move, seed=seed, prefix=prefix,
                                         telemetry=telemetry, state=state)
            if plot:
                self._plot_run(sampler, prefix, true_values)
            return sampler
        if n_steps <= 0:
            raise ValueError("n_steps must be positive.")
        with fit_span():
            lnprob = self.batched_lnprob()

            if state is None:
                pos = self._validated_initials(pos, n_walkers)
                gen = make_generator(self.seed if seed is None else seed, self.device)
                state = init_state(lnprob, self._to_device(pos), gen)
            else:
                n_walkers = state.coords.shape[0]
            if telemetry is not None:
                telemetry.n_walkers = n_walkers

            chain_parts, lnp_parts = [], []
            chunk = n_out if n_out else n_steps
            done = 0
            accepted0 = state.accepted.clone()
            step0 = state.step
            while done < n_steps:
                steps = min(chunk, n_steps - done)
                # the fetch waits for the device, so it ends the telemetry's chunk
                with (telemetry.chunk(steps) if telemetry is not None
                      else contextlib.nullcontext()):
                    with span("runner.chunk"):
                        result = run_ensemble(lnprob, state, n_steps=steps, a=a,
                                              thin=thin, move=move)
                    with span("runner.fetch"):
                        chain_parts.append(result.chain.cpu().numpy())
                        lnp_parts.append(result.log_prob.cpu().numpy())
                state = result.final
                done += steps
                if n_out:
                    logger.info("step %5d  <lnP> = %12.5e", done,
                                float(lnp_parts[-1][:, -1].mean()))
                    if prefix is not None:
                        self.save_current_status_arrays(
                            np.concatenate(chain_parts, axis=1),
                            np.concatenate(lnp_parts, axis=1), state, prefix=prefix)

            n_done = max(state.step - step0, 1)
            acceptance = ((state.accepted - accepted0).cpu().numpy() / n_done)
            sampler = SamplerResult(chain=np.concatenate(chain_parts, axis=1),
                                    lnprobability=np.concatenate(lnp_parts, axis=1),
                                    final_state=state, acceptance_fraction=acceptance)
            if prefix is not None and n_out:
                self.save_current_status(sampler, prefix=prefix)
            if plot:
                self._plot_run(sampler, prefix, true_values)
            return sampler

    def _plot_run(self, sampler, prefix, true_values):
        """``{prefix}_chains.png`` of a run; a failed plot is logged."""
        try:
            from ..utils.plots import plot_chain
            plot_chain(sampler.chain, labels=self.labels, true_values=true_values,
                       filename=f"{prefix}_chains.png" if prefix else None)
        except Exception as err:  # plotting must never kill a fit
            logger.warning("Chain plotting failed: %s", err)

    def _call_sharded(self, mesh, dp_axis, sp_axis, n_walkers, n_steps, n_out,
                      pos, a, seed, prefix, telemetry, state=None,
                      move="stretch") -> "SamplerResult":
        """The chunked, checkpointed analysis of :meth:`__call__` on a mesh
        (``parallel.run_ensemble_sharded``), run by every rank.

        Draws come from one generator seeded as the single-device run's and
        replicated on every rank, so a mesh without a star axis of extent > 1
        gives the single-device chain bit for bit, and ``state=`` (a
        checkpoint of either, at any ``dp`` extent) continues it bit for bit.
        Checkpoints: with shared storage each rank writes its own walker
        blocks and the primary assembles ``{prefix}_chain.npz``
        (:meth:`save_current_status_shards`); otherwise the chain is gathered
        and the primary writes it."""
        from ..parallel.distributed import (checkpoint_dir_is_shared,
                                            mesh_spans_processes)
        from ..parallel.sharded import run_ensemble_sharded

        if n_steps <= 0:
            raise ValueError("n_steps must be positive.")
        if state is None:
            coords = self._to_device(self._validated_initials(pos, n_walkers))
            gen = make_generator(self.seed if seed is None else seed, self.device)
            lnp = None
            accepted0 = np.zeros(n_walkers, np.int64)
            step0 = 0
        else:
            coords, gen, lnp = state.coords, state.generator, state.log_prob
            n_walkers = coords.shape[0]
            accepted0 = state.accepted.cpu().numpy().astype(np.int64)
            step0 = int(state.step)
        if telemetry is not None:
            telemetry.n_walkers = n_walkers
        ndim = int(coords.shape[1])
        shard_ckpt = (prefix is not None and mesh_spans_processes(mesh)
                      and checkpoint_dir_is_shared(prefix))
        chain_parts, lnp_parts = [], []
        blocks: Dict[tuple, tuple] = {}    # walker ids -> ([chain], [lnp])
        assembled = (None, None)
        chunk = n_out if n_out else n_steps
        done = 0
        accepted_run = np.zeros(n_walkers, np.int64)

        def snapshot():
            return EnsembleState(
                coords=coords, log_prob=lnp, generator=gen,
                accepted=torch.as_tensor(accepted0 + accepted_run, dtype=torch.int32,
                                         device=self.device),
                step=step0 + done)

        while done < n_steps:
            steps = min(chunk, n_steps - done)
            with (telemetry.chunk(steps) if telemetry is not None
                  else contextlib.nullcontext()):
                result = run_ensemble_sharded(self, coords, gen, n_steps=steps,
                                              mesh=mesh, dp_axis=dp_axis,
                                              sp_axis=sp_axis, a=a, move=move,
                                              log_prob0=lnp)
                if telemetry is not None:
                    result.final_log_prob.cpu()    # waits for the device
            if shard_ckpt:
                for wids, cb, lb in result.local_blocks():
                    ent = blocks.setdefault(tuple(int(w) for w in wids), ([], []))
                    ent[0].append(cb)
                    ent[1].append(lb)
            else:
                chain_parts.append(result.chain.cpu().numpy())
                lnp_parts.append(result.log_prob.cpu().numpy())
            accepted_run += result.accepted.cpu().numpy().astype(np.int64)
            coords, lnp = result.final_coords, result.final_log_prob
            done += steps
            if n_out:
                logger.info("step %5d  <lnP> = %12.5e", done,
                            float(lnp.mean()))
                if shard_ckpt:
                    assembled = self.save_current_status_shards(
                        blocks, snapshot(), prefix, (n_walkers, done, ndim))
                elif prefix is not None:
                    self.save_current_status_arrays(
                        np.concatenate(chain_parts, axis=1),
                        np.concatenate(lnp_parts, axis=1), snapshot(), prefix=prefix)

        if shard_ckpt:
            if not n_out:
                assembled = self.save_current_status_shards(
                    blocks, snapshot(), prefix, (n_walkers, done, ndim))
            if assembled[0] is not None:
                chain, lnprobability = assembled
            else:       # the other ranks read the primary's canonical file
                with np.load(f"{prefix}_chain.npz") as f:
                    chain, lnprobability = np.asarray(f["chain"]), np.asarray(f["lnprob"])
        else:
            chain = np.concatenate(chain_parts, axis=1)
            lnprobability = np.concatenate(lnp_parts, axis=1)
        sampler = SamplerResult(chain=chain, lnprobability=lnprobability,
                                final_state=snapshot(),
                                acceptance_fraction=accepted_run / max(done, 1))
        if prefix is not None and n_out and not shard_ckpt:
            self.save_current_status(sampler, prefix=prefix)
        return sampler

    def sample_to_convergence(self, n_walkers: int = 100,
                              max_steps: int = 50_000,
                              check_every: int = 500,
                              tau_factor: float = 50.0,
                              rel_change: float = 0.02,
                              pos=None, a: float = 2.0, move="stretch",
                              seed: Optional[int] = None, state=None,
                              prefix: Optional[str] = None, telemetry=None,
                              **kwargs) -> "SamplerResult":
        """Sample in chunks of ``check_every`` steps until the chain certifies
        its own convergence: it is longer than ``tau_factor`` integrated
        autocorrelation times for every parameter AND the tau estimate moved
        by less than ``rel_change`` between checks.  Gives up at
        ``max_steps``.

        Returns a :class:`SamplerResult` with two extra attributes: ``tau``
        (the final per-parameter estimate) and ``converged`` (bool).
        ``mesh=`` (and ``dp_axis``/``sp_axis``) pass through to each chunk's
        :meth:`__call__`, on every rank.
        """
        if check_every <= 0:
            raise ValueError("check_every must be positive.")
        if max_steps <= 0:
            raise ValueError("max_steps must be positive.")
        chain_parts, lnp_parts = [], []
        done = 0
        accepted_total = None
        tau_prev = None
        converged = False
        while done < max_steps:
            steps = min(check_every, max_steps - done)
            result = self(n_walkers=n_walkers, n_steps=steps, n_burn=0,
                          pos=pos, a=a, move=move, seed=seed, state=state,
                          prefix=None, plot=False, telemetry=telemetry,
                          **kwargs)
            pos = None  # only the first chunk initialises walkers
            state = result.final_state
            chain_parts.append(result.chain)
            lnp_parts.append(result.lnprobability)
            # acceptance over the whole run, not the last chunk
            chunk_acc = np.asarray(result.acceptance_fraction) * steps
            accepted_total = (chunk_acc if accepted_total is None
                              else accepted_total + chunk_acc)
            done += steps

            chain = np.concatenate(chain_parts, axis=1)
            tau = autocorr_time(chain)
            tau_max = float(np.max(tau))
            stable = (tau_prev is not None
                      and np.all(np.abs(tau - tau_prev)
                                 <= rel_change * np.maximum(tau, 1.0)))
            logger.info("step %6d  max tau = %8.1f  (need > %0.0f tau%s)",
                        done, tau_max, tau_factor,
                        ", stable" if stable else "")
            if prefix is not None:
                self.save_current_status_arrays(
                    chain, np.concatenate(lnp_parts, axis=1), state,
                    prefix=prefix)
            # tau_max > 0: a frozen chain (every proposal rejected) gives
            # tau = -1, which must never certify convergence
            if tau_max > 0 and done > tau_factor * tau_max and stable:
                converged = True
                break
            tau_prev = tau

        sampler = SamplerResult(
            chain=np.concatenate(chain_parts, axis=1),
            lnprobability=np.concatenate(lnp_parts, axis=1),
            final_state=state,
            acceptance_fraction=accepted_total / done)
        sampler.tau = tau
        sampler.converged = converged
        if not converged:
            logger.warning(
                "sample_to_convergence stopped at max_steps=%d without "
                "certifying convergence (max tau = %.1f).", max_steps, tau_max)
        return sampler

    def sample_hmc(self, n_walkers: int = 32, n_steps: int = 500,
                   n_warmup: int = 200, n_leapfrog: int = 10,
                   step_size: float = 0.05, pos=None,
                   seed: Optional[int] = None) -> "SamplerResult":
        """Gradient-based HMC sampling of this model's posterior through
        :meth:`build_lnprob_differentiable`; returns a :class:`SamplerResult`.

        Windowed warmup (diagonal): phase 1 adapts the step size under the
        identity metric while it records the walkers; the per-parameter
        variance over the second half of that window (pooled over walkers,
        floored at 1e-12) becomes the inverse mass, and phase 2 re-adapts
        the step size under it before sampling.  Fewer than 20 samples a
        parameter cannot support a variance: the identity metric is kept
        and phase 2 skipped."""
        if pos is None:
            pos = self.get_initials(n_walkers)
        lnprob = self.build_lnprob_differentiable()
        gen = make_generator(self.seed if seed is None else seed, self.device)
        state = init_hmc(lnprob, self._to_device(pos), gen, step_size=step_size)
        warm = run_hmc(lnprob, state, n_steps=n_warmup, n_leapfrog=n_leapfrog,
                       adapt=True, store_chain=True)
        w_samples = warm.chain.cpu().numpy()[:, n_warmup // 2:, :]
        flat = w_samples.reshape(-1, w_samples.shape[-1])
        if flat.shape[0] >= 20 * flat.shape[1]:
            mass_inv = self._to_device(np.maximum(flat.var(axis=0), 1e-12))
            warm = run_hmc(lnprob, warm.final, n_steps=max(n_warmup // 2, 50),
                           n_leapfrog=n_leapfrog, mass_inv=mass_inv, adapt=True,
                           store_chain=False)
        else:
            mass_inv = None
        res = run_hmc(lnprob, warm.final, n_steps=n_steps, n_leapfrog=n_leapfrog,
                      mass_inv=mass_inv)
        return SamplerResult(chain=res.chain.cpu().numpy(),
                             lnprobability=res.log_prob.cpu().numpy(),
                             final_state=res.final,
                             acceptance_fraction=res.acceptance_fraction.cpu().numpy())

    def sample_tempered(self, n_walkers: int = 64, n_steps: int = 500,
                        n_temps: int = 8, beta_min: float = 1e-3,
                        swap_every: int = 5, pos=None,
                        seed: Optional[int] = None, mesh=None,
                        temp_axis: str = "tp", move="stretch",
                        state: Optional[TemperedState] = None):
        """Parallel-tempered ensemble sampling through the model's batched
        tier (:meth:`batched_lnprob`: one call a half-step on K x W/2
        walkers); returns (:class:`SamplerResult` of the cold chain,
        thermodynamic-integration log-evidence).

        ``state=`` resumes a prior run's ``result.final_state`` (every
        level's walkers and the generator), continuing the ladder bit for
        bit; ``n_temps`` is then the state's.

        With ``mesh=`` the ladder is sharded over the mesh's ``temp_axis``:
        one temperature a rank, swaps in alternating even/odd phases
        (``parallel.run_tempered_sharded``, the JAX package's sharded
        scheme); ``n_temps`` is the axis' extent, and the result is whole on
        every rank."""
        if mesh is not None:
            return self._sample_tempered_sharded(
                mesh, temp_axis, n_walkers=n_walkers, n_steps=n_steps,
                beta_min=beta_min, swap_every=swap_every, pos=pos, seed=seed,
                move=move, state=state)
        lnprob = self.batched_lnprob()
        if state is not None:
            betas = make_beta_ladder(state.coords.shape[0], beta_min)
        else:
            if pos is None:
                pos = self.get_initials(n_walkers)
            gen = make_generator(self.seed if seed is None else seed, self.device)
            state, betas = init_tempered(lnprob, self._to_device(pos), gen,
                                         n_temps=n_temps, beta_min=beta_min)
        res = run_tempered(lnprob, state, betas, n_steps=n_steps,
                           swap_every=swap_every, move=move)
        result = SamplerResult(chain=res.chain.cpu().numpy(),
                               lnprobability=res.log_prob.cpu().numpy(),
                               final_state=res.final,
                               acceptance_fraction=res.acceptance_fraction[0]
                               .cpu().numpy())
        return result, log_evidence(betas, res.mean_lnp_by_beta)

    def _sample_tempered_sharded(self, mesh, temp_axis, n_walkers, n_steps, beta_min,
                                 swap_every, pos, seed, move, state):
        """:meth:`sample_tempered` on a mesh, run by every rank."""
        from ..parallel.tempered import run_tempered_sharded

        if state is not None:
            pos, gen = state.coords, state.generator
            step0, lnp0 = int(state.step), state.log_prob
        else:
            if pos is None:
                pos = self.get_initials(n_walkers)
            pos = self._to_device(pos)
            gen = make_generator(self.seed if seed is None else seed, self.device)
            step0, lnp0 = 0, None
        res = run_tempered_sharded(self, pos, gen, n_steps=n_steps, mesh=mesh,
                                   temp_axis=temp_axis, beta_min=beta_min,
                                   swap_every=swap_every, move=move, step0=step0,
                                   log_prob0=lnp0)
        if state is not None:     # the state's counts are cumulative
            res.final.accepted = res.final.accepted + state.accepted
            res.final.swaps_accepted = res.final.swaps_accepted + state.swaps_accepted
        betas = make_beta_ladder(mesh.shape[temp_axis], beta_min)
        result = SamplerResult(chain=res.chain.cpu().numpy(),
                               lnprobability=res.log_prob.cpu().numpy(),
                               final_state=res.final,
                               acceptance_fraction=res.acceptance_fraction[0]
                               .cpu().numpy())
        return result, log_evidence(betas, res.mean_lnp_by_beta)

    # ------------------------------------------------------------------ persistence
    @staticmethod
    def save_chain(sampler, filename: str = "samplerchain.npz"):
        """Deprecated alias of :meth:`save_current_status` (reference
        runner.py:445-455)."""
        warnings.warn("Runner.save_chain() is deprecated. "
                      "Use Runner.save_current_status() instead.",
                      DeprecationWarning)
        # splitext, not split('.'): a dotted directory must not truncate the path
        prefix = os.path.splitext(filename)[0]
        if prefix.endswith("chain"):
            prefix = prefix[:-5].rstrip("_") or "sampler"
        Runner.save_current_status(sampler, prefix=prefix)

    @staticmethod
    def save_current_status(sampler, prefix: str = "sampler"):
        """``{prefix}_chain.npz`` from a :class:`SamplerResult`."""
        Runner.save_current_status_arrays(sampler.chain, sampler.lnprobability,
                                          sampler.final_state, prefix=prefix)

    @staticmethod
    def _state_arrays(state) -> Dict[str, np.ndarray]:
        """A state's checkpoint keys: ``key`` holds the torch generator
        state and ``key_impl`` is ``"torch"``."""
        return dict(key=state.generator.get_state().numpy(),
                    key_impl=np.asarray("torch"),
                    coords=state.coords.cpu().numpy(),
                    log_prob=state.log_prob.cpu().numpy(),
                    accepted=state.accepted.cpu().numpy(),
                    step=np.asarray(state.step, dtype=np.int32))

    @staticmethod
    def save_current_status_arrays(chain, lnprob, state, prefix: str = "sampler"):
        """``{prefix}_chain.npz`` with the reference's keys from an
        :class:`EnsembleState`, a :class:`TemperedState` (coords (K, W, P))
        or an :class:`~..sampler.hmc.HMCState`.  In a world of several ranks
        only the primary writes, and every rank waits for the file."""
        from ..parallel.distributed import barrier, is_primary

        with span("runner.checkpoint"):
            if is_primary():
                np.savez(f"{prefix}_chain.npz", chain=np.asarray(chain),
                         lnprob=np.asarray(lnprob), **Runner._state_arrays(state))
            barrier("checkpoint")

    @staticmethod
    def save_current_status_shards(blocks, state, prefix: str, chain_shape):
        """A multi-rank checkpoint that never gathers the chain.

        Each rank writes the walker blocks it owns (``blocks``: ``{walker_ids:
        ([chain chunks (w, s, K)], [lnp chunks])}``, from
        ``ShardedResult.local_blocks``) to ``{prefix}_chain.shard{r}of{n}.npz``;
        after a barrier the primary assembles the canonical
        ``{prefix}_chain.npz`` (the same keys, so :meth:`load_state` and
        :meth:`read_chain` are unchanged) and deletes the shards.  Needs the
        checkpoint directory on shared storage.  Returns ``(chain, lnprob)``
        on the primary and ``(None, None)`` elsewhere."""
        import torch.distributed as dist

        from ..parallel.distributed import barrier, is_primary

        small = Runner._state_arrays(state)
        rank, n = ((dist.get_rank(), dist.get_world_size()) if dist.is_initialized()
                   else (0, 1))
        arrs = {}
        for j, (wids, (cparts, lparts)) in enumerate(sorted(blocks.items())):
            arrs[f"wids_{j}"] = np.asarray(wids, np.int64)
            arrs[f"chain_{j}"] = np.concatenate(cparts, axis=1)
            arrs[f"lnp_{j}"] = np.concatenate(lparts, axis=1)
        np.savez(f"{prefix}_chain.shard{rank}of{n}.npz",
                 n_blocks=np.asarray(len(blocks)), **arrs)
        barrier("checkpoint-shards")

        chain = lnp = None
        if is_primary():
            filled = np.zeros(chain_shape[0], bool)
            for q in range(n):
                with np.load(f"{prefix}_chain.shard{q}of{n}.npz") as f:
                    for j in range(int(f["n_blocks"])):
                        block = f[f"chain_{j}"]
                        if chain is None:
                            chain = np.empty(chain_shape, block.dtype)
                            lnp = np.empty(chain_shape[:2], block.dtype)
                        w = f[f"wids_{j}"]
                        chain[w] = block
                        lnp[w] = f[f"lnp_{j}"]
                        filled[w] = True
            if not filled.all():
                raise IOError("checkpoint shard files do not cover every walker "
                              f"(prefix={prefix!r}); refusing to write a corrupt "
                              "canonical checkpoint.")
            np.savez(f"{prefix}_chain.npz", chain=chain, lnprob=lnp, **small)
            for q in range(n):
                try:
                    os.remove(f"{prefix}_chain.shard{q}of{n}.npz")
                except OSError:
                    pass
        # fences the canonical write and the removal (the next chunk writes
        # the same shard names)
        barrier("checkpoint-assembled")
        return chain, lnp

    def load_state(self, filename: str) -> EnsembleState:
        """Resumable state (coords, in-run lnP, generator, counters) from a
        checkpoint this package wrote; ``self(state=...)`` then continues the
        run bit for bit.  A JAX checkpoint goes through
        :func:`mcmc_dynamics_tpu_torch.convert.state_from_jax_checkpoint`."""
        path = pathlib.Path(filename)
        if path.suffix != ".npz":
            path = path.with_suffix(".npz")
        with np.load(path) as f:
            impl = str(f["key_impl"]) if "key_impl" in f else "legacy"
            if impl != "torch":
                raise ValueError(
                    f"{path} holds a {impl!r} PRNG key, not a torch generator "
                    "state; convert it with convert.state_from_jax_checkpoint.")
            gen = torch.Generator(device=self.device)
            gen.set_state(torch.from_numpy(np.array(f["key"], dtype=np.uint8)))
            return EnsembleState(
                coords=self._to_device(f["coords"]),
                log_prob=self._to_device(f["log_prob"]),
                generator=gen,
                accepted=torch.as_tensor(f["accepted"], dtype=torch.int32,
                                         device=self.device),
                step=int(f["step"]))

    @staticmethod
    def read_chain(filename: str) -> np.ndarray:
        """The (W, S, K) chain of a ``.npz`` checkpoint."""
        path = pathlib.Path(filename)
        if path.suffix != ".npz":
            path = path.with_suffix(".npz")
        with np.load(path) as f:
            return f["chain"]

    @staticmethod
    def read_final_chain(filename: str) -> np.ndarray:
        """The (W, K) last recorded step of a checkpoint's chain."""
        return Runner.read_chain(filename)[:, -1, :]

    # ------------------------------------------------------------------ posterior
    def convert_to_parameters(self, chain, n_burn: int) -> Dict[str, np.ndarray]:
        """Chain -> flattened posterior samples of every parameter (free,
        fixed and expression-derived)."""
        chain = np.asarray(chain)
        n_samples = chain.shape[0] * (chain.shape[1] - n_burn)
        pars: Dict[str, np.ndarray] = {}
        for i, name in enumerate(self.fitted_parameters):
            pars[name] = chain[:, n_burn:, i].reshape(-1)
        for name, par in self.parameters.items():
            if name in pars or par.expr is not None:
                continue
            pars[name] = np.full(n_samples, par.value)
        for name, par in self.parameters.items():
            if par.expr is None or name in pars:
                continue
            fn = compile_torch(par.expr)
            pars[name] = np.asarray(fn({k: torch.as_tensor(v)
                                        for k, v in pars.items()}))
        return pars

    def compute_percentiles(self, chain, n_burn: int, pct=None) -> np.ndarray:
        if pct is None:
            pct = [16, 50, 84]
        samples = np.asarray(chain)[:, n_burn:, :].reshape(-1, self.n_fitted_parameters)
        return np.percentile(samples, pct, axis=0)

    def compute_bestfit_values(self, chain, n_burn: int) -> Table:
        """Median and upper/lower 1-sigma errors per fitted parameter (rows
        median/uperr/loerr); sets each parameter's value to its median."""
        pct = self.compute_percentiles(chain, n_burn=n_burn, pct=[16, 50, 84])
        out = Table({"value": np.array(["median", "uperr", "loerr"], dtype=object)})
        for i, name in enumerate(self.fitted_parameters):
            self.parameters[name].value = pct[1, i]
            out[name] = u.Quantity(
                np.array([pct[1, i], pct[2, i] - pct[1, i], pct[1, i] - pct[0, i]]),
                self.parameters[name].unit)
        return out

    def predict_fields(self, chain, n_burn: int, ra, dec,
                       n_samples: int = 200, seed: int = 0) -> Table:
        """Posterior-predictive mean-velocity and dispersion fields at
        arbitrary sky positions: the model's ``rotation_field`` and
        ``dispersion_field`` under ``n_samples`` posterior draws (drawn with
        ``np.random.default_rng(seed)``, as in the reference), evaluated in
        one batched torch pass over (n_samples, n_positions) on the model's
        device.  ``ra``/``dec``: Quantities (or plain degrees).  Returns a
        Table with per-position ``v_los``/``sigma_los`` medians and
        16/84-percentile bounds."""
        if not (hasattr(self, "rotation_field")
                and hasattr(self, "dispersion_field")):
            raise NotImplementedError(
                f"{type(self).__name__} does not expose analytic "
                "rotation/dispersion fields; use create_profiles().")
        ra_q = ra if isinstance(ra, u.Quantity) else u.Quantity(ra, "deg")
        dec_q = dec if isinstance(dec, u.Quantity) else u.Quantity(dec, "deg")
        ra_rad = np.atleast_1d(ra_q.to("rad").value)
        dec_rad = np.atleast_1d(dec_q.to("rad").value)
        # fresh data dict (NOT prepare_data: its precomputed offsets belong to
        # the fitted catalog's positions, and the centre may be a chain column)
        pdata = {"ra": self._to_device(ra_rad), "dec": self._to_device(dec_rad),
                 "v": self._to_device(np.zeros(ra_rad.size))}

        chain = np.asarray(chain)
        flat = chain[:, n_burn:, :].reshape(-1, chain.shape[-1])
        if flat.shape[0] == 0:
            raise ValueError(
                f"n_burn={n_burn} leaves no posterior samples: the chain "
                f"holds {chain.shape[1]} recorded steps (note recorded steps "
                "= true steps / thin).")
        rng = np.random.default_rng(seed)
        draws = self._to_device(flat[rng.integers(0, flat.shape[0], n_samples)])
        p = {n: (v[:, None] if torch.is_tensor(v) and v.dim() == 1 else v)
             for n, v in self.scaled_values(draws).items()}
        shape = (n_samples, ra_rad.size)
        v, s = (torch.broadcast_to(field(p, pdata), shape).cpu().numpy()
                for field in (self.rotation_field, self.dispersion_field))
        return self._predictive_table(ra_q, dec_q, v, s)

    @staticmethod
    def _predictive_table(ra_q, dec_q, v, sigma) -> Table:
        good = np.isfinite(v).all(axis=1) & np.isfinite(sigma).all(axis=1)
        if not good.any():
            raise ValueError(
                "Every posterior draw produced non-finite predicted fields — "
                "the sampled region of parameter space is invalid for this "
                "model (check bounds / burn-in).")
        v, sigma = v[good], sigma[good]
        pv = np.percentile(v, [50, 16, 84], axis=0)
        ps = np.percentile(sigma, [50, 16, 84], axis=0)
        table = Table({"ra": ra_q, "dec": dec_q})
        for key, arr in (("v_los", pv), ("sigma_los", ps)):
            table[key] = u.Quantity(arr[0], "km/s")
            table[f"{key}_lower_1s"] = u.Quantity(arr[1], "km/s")
            table[f"{key}_upper_1s"] = u.Quantity(arr[2], "km/s")
        return table

    def sample_chain(self, chain, n_burn: int, n_samples: int = 1):
        """Randomly draw parameter dicts (in declared units) from the chain,
        with the parameters' own generator seed (as the reference)."""
        chain = np.asarray(chain)
        flat = chain[:, n_burn:, :].reshape(-1, chain.shape[-1])
        rng = np.random.default_rng(self.parameters.rng_seed)
        idx = rng.integers(0, flat.shape[0], size=n_samples)
        values = self.compiled.expand(self._to_device(flat[idx]))
        return [{n: float(v[i]) if torch.is_tensor(v) else float(v)
                 for n, v in values.items()} for i in range(n_samples)]

    def compute_theta_vmax(self, chain, n_burn: int, return_samples: bool = False):
        """Posterior rotation amplitude and angle (circular statistics)."""
        pars = self.convert_to_parameters(chain=chain, n_burn=n_burn)
        results, v_max, theta = get_amplitude_and_angle(pars,
                                                        return_samples=return_samples)
        if results is None:
            logger.error("Could not recover rotation-field parameters in "
                         "%s.compute_theta_vmax().", type(self).__name__)
            return None
        results["v_max"] = u.Quantity(results.value("v_max"),
                                      self.parameters["v_maxx"].unit)
        if return_samples:
            return results, v_max, theta, pars.get("sigma_max")
        return results

    # ------------------------------------------------------------------ plotting
    def plot_chain(self, chain, filename="chains.png", true_values=None,
                   lnprob=None, figure=None, plot_median=False):
        """Trace plot of every fitted parameter (``utils.plots.plot_chain``)."""
        from ..utils.plots import plot_chain
        return plot_chain(np.asarray(chain), labels=self.labels, filename=filename,
                          true_values=true_values, lnprob=lnprob, figure=figure,
                          plot_median=plot_median)

    def create_triangle_plot(self, chain, n_burn: int, filename="corner.png",
                             **kwargs):
        """Corner plot of the post-burn-in samples (``utils.plots.corner_plot``)."""
        from ..utils.plots import corner_plot
        samples = np.asarray(chain)[:, n_burn:, :].reshape(-1, self.n_fitted_parameters)
        kwargs.setdefault("labels", self.labels)
        return corner_plot(samples, filename=filename, **kwargs)


class SamplerResult:
    """emcee-style result: ``.chain`` (walkers, steps, params) and
    ``.lnprobability`` (walkers, steps) as NumPy arrays, plus the resumable
    ensemble state."""

    def __init__(self, chain, lnprobability, final_state, acceptance_fraction):
        self.chain = chain
        self.lnprobability = lnprobability
        self.final_state = final_state
        self.acceptance_fraction = acceptance_fraction

    @property
    def iteration(self) -> int:
        return self.chain.shape[1]

    def get_last_sample(self):
        return self.chain[:, -1, :]

    @property
    def flatchain(self):
        """(walkers * steps, ndim), the emcee v2 attribute."""
        return self.chain.reshape(-1, self.chain.shape[2])

    @property
    def flatlnprobability(self):
        return self.lnprobability.reshape(-1)

    def get_chain(self, flat: bool = False, thin: int = 1, discard: int = 0):
        """Chain in the emcee v3 layout (steps, walkers, ndim)."""
        v = np.swapaxes(self.chain, 0, 1)[discard + thin - 1::thin]
        return v.reshape(-1, v.shape[2]) if flat else v

    def get_log_prob(self, flat: bool = False, thin: int = 1, discard: int = 0):
        v = np.swapaxes(self.lnprobability, 0, 1)[discard + thin - 1::thin]
        return v.reshape(-1) if flat else v

    def get_autocorr_time(self, discard: int = 0, thin: int = 1, c: float = 5.0,
                          tol: float = 50.0, quiet: bool = False):
        """Integrated autocorrelation time per parameter (emcee v3 semantics:
        raises :class:`~..sampler.diagnostics.AutocorrError` when the chain
        is shorter than ``tol`` tau, unless ``quiet``)."""
        sub = np.asarray(self.chain)[:, discard + thin - 1::thin, :]
        tau = autocorr_time(sub, c=c) * thin
        n_eff_steps = sub.shape[1] * thin
        if not quiet and np.any(tau * tol > n_eff_steps):
            raise AutocorrError(
                tau, f"The chain is shorter than tol={tol:g} times the "
                     f"integrated autocorrelation time ({n_eff_steps} steps "
                     f"vs tau = {np.array2string(tau, precision=1)}); the "
                     "estimate is unreliable. Run longer, lower tol, or pass "
                     "quiet=True.")
        return tau


# --------------------------------------------------------------------------- terms
def gaussian_lnlike_terms(v, verr, v_los, sigma_los):
    """Per-star Gaussian terms: -1/2 ln(2 pi n) - 1/2 (v - v_los)^2 / n,
    n = verr^2 + sigma^2."""
    norm = verr * verr + sigma_los * sigma_los
    return -0.5 * (torch.log(2.0 * math.pi * norm) + (v - v_los) ** 2 / norm)


def mixture_lnlike_terms(lnlike_member, lnlike_background, pmember):
    """Two-population mixture per star via log-sum-exp (runner.py:272-286):
    ln[p * e^{lnL_m} + (1-p) * e^{lnL_b}]."""
    return torch.logaddexp(torch.log(pmember) + lnlike_member,
                           torch.log1p(-pmember) + lnlike_background)


def density_membership(density, f_back):
    """Membership prior m = density / (density + f_back), safe at the corner
    density = 0 AND f_back = 0 (both within their priors): the plain ratio is
    0/0 = NaN there.  A zero-density star is pure background (m = 0).  Used
    for a-posteriori membership outputs; the likelihood itself goes through
    :func:`density_mixture_terms`."""
    den = density + f_back
    tiny = torch.finfo(den.dtype).tiny
    return density / torch.clamp(den, min=tiny)


def density_mixture_terms(density, ln_density, f_back, lnl_member,
                          lnl_background):
    """Per-star density-weighted mixture in log space — the SAME formula as
    the fused kernels (``ops/lnlike_kernels.py``):

        lnL_i = logaddexp(ln D_i + lnL_m, ln f + lnL_b) - ln(D_i + f)

    Working from the float64-accurate ``ln_density`` (:func:`with_density_logs`)
    keeps a density that underflows to 0 in float32 weighting the cluster
    branch correctly, and the clamped normaliser keeps f_back = 0 (the prior's
    lower bound) finite."""
    ln_f = torch.log(torch.as_tensor(f_back, dtype=density.dtype,
                                     device=density.device))  # -inf at 0: fine
    den = density + f_back
    tiny = torch.finfo(den.dtype).tiny
    return (torch.logaddexp(ln_density + lnl_member, ln_f + lnl_background)
            - torch.log(torch.clamp(den, min=tiny)))


def with_density_logs(data, density, to_device):
    """Clamp the host float64 ``density`` column away from zero, and attach it
    and its float64-accurate log as ``density`` and ``ln_density`` (through
    ``to_device``).  The 1e-300 clamp only binds for exactly-zero densities;
    its log (-690.8) stays finite after the cast even in float32, where the
    clamped density itself underflows to 0."""
    if "ln_density" not in data:
        dens = np.maximum(np.asarray(density, np.float64), 1e-300)
        data["density"] = to_device(dens)
        data["ln_density"] = to_device(np.log(dens))
    return data


def log_indicator(ok, dtype, device) -> torch.Tensor:
    """A joint prior's log: 0 where ``ok`` (a bool, or a bool tensor), -inf
    elsewhere."""
    ok = torch.as_tensor(ok, device=device)
    return torch.zeros(ok.shape, dtype=dtype, device=device).masked_fill(~ok, -math.inf)


def membership_from_terms(lnl_cluster, lnl_background, m) -> np.ndarray:
    """A-posteriori membership per star, m e^{lnC} / (m e^{lnC} + (1 - m)
    e^{lnB}), from per-star tensors, as a float64 array."""
    lnl_c, lnl_b, m = (np.asarray(torch.as_tensor(t).cpu().numpy(), np.float64)
                       for t in (lnl_cluster, lnl_background, m))
    peak = np.maximum(lnl_c, lnl_b)
    num = m * np.exp(lnl_c - peak)
    return num / (num + (1.0 - m) * np.exp(lnl_b - peak))


class GaussianBackgroundMixin:
    """A sampled Gaussian field population in velocity space (``v_back``,
    ``sigma_back``) mixed with the cluster through per-star density
    membership priors ``m_i = density_i / (density_i + f_back)``: the pieces
    ConstantFitGB, ModelFitGB and DoubleModelFitGB share (reference
    ``constant.py:293-374``, ``model.py:443-476``).  Placed before the model
    class in the bases."""

    def __init__(self, data, parameters=None, **kwargs):
        background = kwargs.pop("background", None)
        if background is not None:
            logger.error("Class %s does not support additional background "
                         "components.", type(self).__name__)
        super().__init__(data=data, parameters=parameters, **kwargs)

    def prepare_data(self, data):
        return with_density_logs(super().prepare_data(data),
                                 self._host_arrays["density"], self._to_device)

    def membership_prior(self, p, data):
        return density_membership(data["density"], p["f_back"])

    def cluster_background_terms(self, p, data):
        """Per-star (cluster, background, membership-prior) triplet."""
        v_los = self.rotation_field(p, data)
        sigma_los = self.dispersion_field(p, data)
        lnl_cluster = gaussian_lnlike_terms(data["v"], data["verr"], v_los, sigma_los)
        lnl_back = gaussian_lnlike_terms(data["v"], data["verr"],
                                         p["v_back"], p["sigma_back"])
        return lnl_cluster, lnl_back, self.membership_prior(p, data)

    def lnlike_terms(self, p, data):
        lnl_cluster, lnl_back, m = self.cluster_background_terms(p, data)
        if "ln_density" in data:
            # log-space mixture off the f64-accurate ln_density: identical
            # formula to the fused kernels, NaN-free at f_back = 0
            return density_mixture_terms(data["density"], data["ln_density"],
                                         p["f_back"], lnl_cluster, lnl_back)
        return mixture_lnlike_terms(lnl_cluster, lnl_back, m)

    def calculate_membership_probabilities(self, chain, n_burn):
        """A-posteriori membership per star from the best-fit (median)
        parameters, on the catalog's own columns (reference
        ``model.py:468-476``), as a float64 array."""
        bestfit = self.compute_bestfit_values(chain=chain, n_burn=n_burn)
        theta = np.array([bestfit.value(n)[0] for n in self.fitted_parameters])
        p = self.scaled_values(self._to_device(theta[None, :]))
        return membership_from_terms(*self.cluster_background_terms(
            p, self._data_arrays))


def _sin(x):
    return torch.sin(x) if torch.is_tensor(x) else math.sin(x)


def masked_sum(terms, data):
    """Sum per-star terms over the last axis, honouring an optional mask with
    a select (a -inf term on a masked lane must not become NaN)."""
    mask = data.get("mask")
    if mask is not None:
        return torch.where(mask > 0, terms, torch.zeros_like(terms)).sum(dim=-1)
    return terms.sum(dim=-1)
