"""The JAM engine's line-of-sight moments as one CUDA kernel.

Beside the plain version, ``models/jam/moments.py:jam_los_moments``, which it
takes the arguments of and computes the function of: the kernel
(``csrc/jam_moments.cu``) replaces no TPU kernel (the JAX package leaves the
engine to XLA) and keeps the pair table and the (W, L, P) terms out of device
memory, in one launch a call.

The wrapper launches nothing else: each argument reaches the kernel as it is,
a pointer and its strides (0 along an axis it broadcasts over) or, for a
Python number, its value.  A CPU tensor takes the plain version; on a CUDA
device every tensor must be float32 on that device, or the wrapper raises.

Populations: ``lum_i`` and ``kappa`` may carry a leading population axis,
(n_pops, W, L), for tracer populations that share everything else (the
mass, the geometry, the tracers' widths, flattening and beta).  One launch
then evaluates every population, building and contracting the pair table
once a walker; the plain version takes one call a population.  The kernel
centres every population's line-of-sight map on the ridge of their summed
tracer, the plain version each on its own (``jam_los_moments``' ``ridge_i``
gives the kernel's centre): the same map where the tracer components share
one axis ratio; at distinct axis ratios two quadratures of one integral,
apart in vz by far more than float32's rounding (up to ~1e-3 of the field
at n_zeta 32), so a caller whose tracers differ in axis ratio makes a call
a population (as ChemoProfiles does).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..profiling import count
from ._build import Kernel, _library

__all__ = ["JAM_MOMENTS", "jam_moments", "jam_moments_plain"]

_P = ctypes.c_void_p
JAM_MOMENTS = Kernel("jam_moments_launch", [_P])

# the kernel's fields, in csrc/jam_moments.cu's order
_FIELDS = ("x", "y", "lum_i", "lum_s", "lum_q", "mass_i", "mass_s", "mass_q",
           "beta", "kappa", "mscale", "d", "incl", "mbh", "rbh")
_LUM = ("lum_i", "lum_s", "lum_q", "beta", "kappa")
# the arguments that may lead with a population axis
_POP = ("lum_i", "kappa")
_MASS = ("mass_i", "mass_s", "mass_q", "mscale")
_WALKER = ("d", "incl", "mbh", "rbh")


class _Field(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("row", ctypes.c_longlong),
                ("col", ctypes.c_longlong), ("pop", ctypes.c_longlong),
                ("value", ctypes.c_float)]


class _Args(ctypes.Structure):
    _fields_ = [("f", _Field * len(_FIELDS)), ("u_nodes", ctypes.c_void_p),
                ("z_nodes", ctypes.c_void_p), ("vz", ctypes.c_void_p),
                ("v2zz", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("W", ctypes.c_int), ("N", ctypes.c_int), ("L", ctypes.c_int),
                ("M", ctypes.c_int), ("n_u", ctypes.c_int), ("n_zeta", ctypes.c_int),
                ("with_bh", ctypes.c_int), ("n_pops", ctypes.c_int)]


@functools.cache
def _check_layout() -> None:
    """:class:`_Args` must be the C struct's size (the library says it)."""
    fn = _library().jam_moments_args_bytes
    fn.restype = ctypes.c_int
    if fn() != ctypes.sizeof(_Args):
        raise RuntimeError(f"jam_moments: _Args is {ctypes.sizeof(_Args)} bytes, "
                           f"the kernel's JamArgs {fn()}")


@functools.lru_cache(maxsize=None)
def _nodes(n_u: int, n_zeta: int, device: torch.device):
    """The u-nodes (n_u, 2) and the LOS map's nodes (n_zeta, 2) as float32 on
    ``device``, from the plain version's float64 tables."""
    from ..models.jam.moments import _gauss_legendre, _los_nodes

    x, w = _gauss_legendre(n_u)
    tan_t, wsec = _los_nodes(n_zeta)
    u = np.stack([0.5 * (x + 1.0), 0.5 * w], axis=1)
    z = np.stack([tan_t, wsec], axis=1)
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
                 for a in (u, z))


def _as_3d(name, v):
    """A tensor argument as (populations, rows, cols): positions and
    component arrays as the plain version's atleast_2d/_component, walker
    scalars as (rows, 1), one population but for ``lum_i`` and ``kappa``
    given with a population axis."""
    if v.dim() == 3 and name in _POP:
        return v
    if name in _WALKER:
        return v.reshape(1, -1, 1)
    if v.dim() <= 1:
        return v.reshape(1, 1, -1)
    if v.dim() != 2:
        raise ValueError(f"jam_moments: {name} has shape {tuple(v.shape)}; "
                         "expected at most 2 dimensions"
                         + (" (3 with a population axis)" if name in _POP else ""))
    return v[None]


def _engine_args(x, y, lum_i, lum_s, lum_q, mass_i, mass_s, mass_q, d, beta, kappa,
                 mscale, incl, mbh, rbh):
    return dict(x=x, y=y, lum_i=lum_i, lum_s=lum_s, lum_q=lum_q, mass_i=mass_i,
                mass_s=mass_s, mass_q=mass_q, beta=beta, kappa=kappa, mscale=mscale,
                d=d, incl=incl, mbh=mbh, rbh=rbh)


def jam_moments_plain(x, y, lum_i, lum_s, lum_q, mass_i, mass_s, mass_q, d, beta, kappa,
                      mscale, incl, mbh=0.0, rbh=1.0, n_u: int = 24, n_zeta: int = 32):
    """:func:`jam_moments`' arguments, shapes and results from the plain
    version, one call a population (each counted), on any device."""
    from ..models.jam.moments import JamMoments, jam_los_moments

    args = _engine_args(x, y, lum_i, lum_s, lum_q, mass_i, mass_s, mass_q, d, beta,
                        kappa, mscale, incl, mbh, rbh)
    stacked = [n for n in _POP if torch.is_tensor(args[n]) and args[n].dim() == 3]
    parts = []
    for p in range(max((args[n].shape[0] for n in stacked), default=1)):
        one = {n: args[n][p if args[n].shape[0] > 1 else 0] for n in stacked}
        count("jam.engine_plain")
        count("jam.populations")
        parts.append(jam_los_moments(**dict(args, **one), n_u=n_u, n_zeta=n_zeta))
    if not stacked:
        return parts[0]
    return JamMoments(*(torch.stack(f) for f in zip(*parts)))


def jam_moments(x, y, lum_i, lum_s, lum_q, mass_i, mass_s, mass_q, d, beta, kappa,
                mscale, incl, mbh=0.0, rbh=1.0, n_u: int = 24, n_zeta: int = 32):
    """:func:`~mcmc_dynamics_tpu_torch.models.jam.moments.jam_los_moments`'s
    moments, arguments and shapes, in one kernel launch on a CUDA device.

    Returns ``JamMoments(vz, v2zz, valid)``: (W, N) float32 and (W,) bool;
    with a population axis on ``lum_i`` or ``kappa`` ((n_pops, W, L); the
    other one may broadcast over it), (n_pops, W, N) and (n_pops, W).
    Positions on the CPU take the plain version, :func:`jam_moments_plain`.
    The black-hole branch is chosen by the type of ``mbh``, as there."""
    from ..models.jam.moments import JamMoments

    args = _engine_args(x, y, lum_i, lum_s, lum_q, mass_i, mass_s, mass_q, d, beta,
                        kappa, mscale, incl, mbh, rbh)
    x = torch.as_tensor(x)
    if x.device.type == "cpu":
        return jam_moments_plain(**args, n_u=n_u, n_zeta=n_zeta)
    if x.device.type != "cuda":
        raise TypeError(f"jam_moments: unsupported device {x.device}")
    _check_layout()
    packed, out, _ = _pack(x.device, args, n_u, n_zeta)
    JAM_MOMENTS(ctypes.addressof(packed),
                stream=torch.cuda.current_stream(x.device).cuda_stream)
    count("jam.engine_kernel")
    count("jam.populations", packed.n_pops)
    if not any(torch.is_tensor(args[n]) and args[n].dim() == 3 for n in _POP):
        out = tuple(t[0] for t in out)
    return JamMoments(*out)


def _pack(device, args, n_u, n_zeta):
    """The launcher's argument for ``args`` (the engine's, by name) on
    ``device``, the outputs it writes, (vz, v2zz, valid) with a leading
    population axis, and the tensors it points to (to be kept until the
    launch)."""
    with_bh = not (isinstance(args["mbh"], (int, float, np.floating))
                   and float(args["mbh"]) == 0.0)
    # each argument as (rows, cols), or a number
    shaped = {}
    for name, v in args.items():
        if isinstance(v, (int, float, np.floating, np.integer)):
            if name in ("x", "y"):
                raise TypeError(f"jam_moments: {name} must be a tensor")
            shaped[name] = float(v)
            continue
        if not torch.is_tensor(v):
            raise TypeError(f"jam_moments: {name} must be a number or a tensor, "
                            f"got {type(v).__name__}")
        if v.device != device or v.dtype != torch.float32:
            raise TypeError(f"jam_moments: {name}: expected float32 on {device}, got "
                            f"{v.dtype} on {v.device}")
        shaped[name] = _as_3d(name, v)

    def sizes(names, axis):
        got = {shaped[n].shape[axis] for n in names if torch.is_tensor(shaped[n])}
        size = max(got, default=1)
        if not got <= {1, size}:
            raise ValueError(f"jam_moments: {names} do not broadcast along axis "
                             f"{axis}: sizes {sorted(got)}")
        return size

    W = sizes(_FIELDS, 1)
    n_lum, n_mass = sizes(_LUM, 2), sizes(_MASS, 2)
    n_pops = sizes(_POP, 0)
    n_pos = shaped["x"].shape[2]
    if shaped["y"].shape[2] != n_pos:
        raise ValueError(f"jam_moments: x has {n_pos} positions, y "
                         f"{shaped['y'].shape[2]}")
    if n_u < 1 or n_zeta < 1:
        raise ValueError(f"jam_moments: n_u {n_u}, n_zeta {n_zeta}: need >= 1")

    fields = (_Field * len(_FIELDS))()
    for f, name in zip(fields, _FIELDS):
        v = shaped[name]
        if torch.is_tensor(v):
            f.ptr = v.data_ptr()
            f.pop = v.stride(0) if v.shape[0] > 1 else 0
            f.row = v.stride(1) if v.shape[1] > 1 else 0
            f.col = v.stride(2) if v.shape[2] > 1 else 0
        else:
            f.ptr, f.value = None, v
    u_nodes, z_nodes = _nodes(int(n_u), int(n_zeta), device)
    vz = torch.empty((n_pops, W, n_pos), dtype=torch.float32, device=device)
    v2zz = torch.empty((n_pops, W, n_pos), dtype=torch.float32, device=device)
    valid = torch.empty((n_pops, W), dtype=torch.bool, device=device)
    packed = _Args(fields, u_nodes.data_ptr(), z_nodes.data_ptr(), vz.data_ptr(),
                   v2zz.data_ptr(), valid.data_ptr(), W, n_pos, n_lum, n_mass,
                   int(n_u), int(n_zeta), int(with_bh), n_pops)
    return packed, (vz, v2zz, valid), shaped
