"""Carry state across from the JAX package to this one.

The functions take the JAX package's objects duck-typed (their JSON, plain
arrays that ``numpy.asarray`` reads), so this module imports nothing of that
package.  With them the tests feed both packages the same parameters, tables
and walkers.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from .ops.model_tensor import ModelTensorStats
from .parameters import Parameters
from .sampler.stretch import EnsembleState, make_generator
from .sampler.tempered import TemperedState

__all__ = ["parameters_from_reference", "tensor_stats_from_jax",
           "state_from_jax_checkpoint", "tempered_state_from_jax"]


def parameters_from_reference(params) -> Parameters:
    """The port's :class:`Parameters` from the JAX package's, through its
    native JSON (``p.dumps()``): values, units, bounds, expressions, the seed
    and the generator state, so both draw the same initial walkers."""
    return Parameters().loads(params.dumps())


def tensor_stats_from_jax(stats, *, device, dtype: torch.dtype) -> ModelTensorStats:
    """A :class:`ModelTensorStats` from the fields of the reference's
    ``ModelTensorStats`` NamedTuple (its arrays, as numpy)."""
    def tensor(name):
        return torch.as_tensor(np.array(getattr(stats, name), np.float64),
                               dtype=dtype, device=device)

    def interval(name):
        lo, hi = np.asarray(getattr(stats, name), np.float64)
        return float(lo), float(hi)

    return ModelTensorStats(
        table=tensor("table"), u_s=tensor("u_s"), u_a=tensor("u_a"),
        n_s=int(stats.n_s), n_a=int(stats.n_a), n_r=int(stats.n_r),
        t_s=interval("t_s"), t_a=interval("t_a"), t_r=interval("t_r"),
        offset=float(np.asarray(stats.offset)),
        n_stars=float(np.asarray(stats.n_stars)),
        s_max=float(stats.s_max), a_lo=float(stats.a_lo), a_hi=float(stats.a_hi),
        r_lo=float(stats.r_lo), r_hi=float(stats.r_hi))


def state_from_jax_checkpoint(filename, *, device, dtype: torch.dtype,
                              seed: int) -> EnsembleState:
    """An :class:`EnsembleState` from a JAX ``{prefix}_chain.npz`` (coords,
    log_prob, accepted, step).

    The JAX PRNG key cannot drive a torch generator, so the generator is
    seeded anew from ``seed``: continuing a JAX run here is a valid
    continuation of the chain, but not the bitwise one a resume within either
    package gives.
    """
    path = pathlib.Path(filename)
    with np.load(path if path.suffix == ".npz" else path.with_suffix(".npz")) as f:
        return EnsembleState(
            coords=torch.as_tensor(np.asarray(f["coords"], np.float64), dtype=dtype,
                                   device=device),
            log_prob=torch.as_tensor(np.asarray(f["log_prob"], np.float64),
                                     dtype=dtype, device=device),
            generator=make_generator(seed, device),
            accepted=torch.as_tensor(np.asarray(f["accepted"]), dtype=torch.int32,
                                     device=device),
            step=int(f["step"]))


def tempered_state_from_jax(state, *, device, dtype: torch.dtype,
                            seed: int) -> TemperedState:
    """A :class:`TemperedState` from the JAX package's ``TemperedState``
    (coords (K, W, P), log_prob, accepted, swaps_accepted, step) or from its
    tempered ``{prefix}_chain.npz`` (which holds no swap counts: they start
    at 0).  The generator is seeded anew from ``seed``, as in
    :func:`state_from_jax_checkpoint`: a valid continuation of the ladder,
    not a bitwise one."""
    if isinstance(state, (str, pathlib.Path)):
        path = pathlib.Path(state)
        with np.load(path if path.suffix == ".npz" else path.with_suffix(".npz")) as f:
            fields = {name: np.asarray(f[name])
                      for name in ("coords", "log_prob", "accepted", "step")}
        fields["swaps_accepted"] = np.zeros(fields["coords"].shape[0] - 1, np.int32)
    else:
        fields = {name: np.asarray(getattr(state, name))
                  for name in ("coords", "log_prob", "accepted", "swaps_accepted",
                               "step")}

    def counts(name):
        return torch.as_tensor(np.array(fields[name]), dtype=torch.int32, device=device)

    return TemperedState(
        coords=torch.as_tensor(np.array(fields["coords"], np.float64), dtype=dtype,
                               device=device),
        log_prob=torch.as_tensor(np.array(fields["log_prob"], np.float64),
                                 dtype=dtype, device=device),
        generator=make_generator(seed, device),
        accepted=counts("accepted"), swaps_accepted=counts("swaps_accepted"),
        step=int(fields["step"]))
