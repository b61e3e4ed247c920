"""The JAM polar grid's star reconstruction as one CUDA kernel.

From the grid's coefficients of the two interpolated fields, ``c1`` (the
rotation fraction, odd harmonics) and ``c2`` (log(v2zz + floor), even
harmonics), each (W, n_r, n_phi), and the kappa-frame angle ``theta0`` (a
number, (W,) or (W, 1)), it gives ``(vz, v2zz)`` at every star of the
:class:`~mcmc_dynamics_tpu_torch.models.jam.grid.JamGridSpec`, (W, N) each:
the tail of ``models/jam/grid.py:jam_grid_moments``.

Beside the plain version, :func:`jam_grid_reconstruct_plain` (that tail as
it was: two batched products (N, n_r) @ (W, n_r, n_phi), the harmonic sums,
exp and sqrt, in the working dtype), the kernel (``csrc/jam_grid.cu``)
replaces no TPU kernel (the JAX package leaves the reconstruction to XLA)
and keeps the (W, N, n_phi) products in registers, in one launch a call.

Each argument reaches the kernel as it is, a pointer and its strides (so a
star slice of the bases, as the star-sharded partial tier passes it, runs
unchanged), or ``theta0``'s value where it is a number.  CPU tensors take
the plain version; on a CUDA device every tensor must be float32 on that
device, or the wrapper raises.  ``jam.recon_kernel`` and ``jam.recon_plain``
count the calls by path.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..profiling import count
from ._build import Kernel, _library

__all__ = ["JAM_GRID_RECONSTRUCT", "jam_grid_reconstruct", "jam_grid_reconstruct_plain"]

_P = ctypes.c_void_p
JAM_GRID_RECONSTRUCT = Kernel("jam_grid_reconstruct_launch", [_P])

# the kernel's arguments, in csrc/jam_grid.cu's order: the spec's star bases
# and multipliers, the coefficients, theta0
_STARS = ("t_star", "cos_odd", "sin_odd", "cos_even", "sin_even")
_FIELDS = _STARS + ("c1", "c2", "mult_odd", "mult_even", "theta0")


class _Strided(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("s0", ctypes.c_longlong),
                ("s1", ctypes.c_longlong), ("s2", ctypes.c_longlong),
                ("value", ctypes.c_float)]


class _Args(ctypes.Structure):
    _fields_ = [("f", _Strided * len(_FIELDS)), ("vz", ctypes.c_void_p),
                ("v2zz", ctypes.c_void_p), ("W", ctypes.c_int), ("N", ctypes.c_int),
                ("n_r", ctypes.c_int), ("n_phi", ctypes.c_int),
                ("floor", ctypes.c_float)]


@functools.cache
def _check_layout() -> None:
    """:class:`_Args` must be the C struct's size (the library says it)."""
    fn = _library().jam_grid_reconstruct_args_bytes
    fn.restype = ctypes.c_int
    if fn() != ctypes.sizeof(_Args):
        raise RuntimeError(f"jam_grid_reconstruct: _Args is {ctypes.sizeof(_Args)} "
                           f"bytes, the kernel's ReconArgs {fn()}")


def jam_grid_reconstruct_plain(spec, c1, c2, theta0, floor):
    """``(vz, v2zz)`` at every star from the coefficients, in torch on any
    device and dtype: two batched products and the harmonic sums."""
    count("jam.recon_plain")
    # kappa-frame rotation in harmonic space
    theta0 = torch.as_tensor(theta0, dtype=c1.dtype,
                             device=c1.device).reshape(-1, 1, 1)      # (W, 1, 1)
    co, so = torch.cos(spec.mult_odd * theta0), torch.sin(spec.mult_odd * theta0)
    ce, se = torch.cos(spec.mult_even * theta0), torch.sin(spec.mult_even * theta0)

    # star reconstruction: one (N, n_r) @ (n_r, K) product per moment and walker
    h1 = torch.matmul(spec.t_star, c1)                                  # (W, N, K)
    h2 = torch.matmul(spec.t_star, c2)
    w = torch.sum(h1 * (spec.cos_odd * co + spec.sin_odd * so), dim=-1)
    v2f = torch.exp(torch.sum(h2 * (spec.cos_even * ce + spec.sin_even * se),
                              dim=-1))                                  # = v2zz + floor
    vz = w * torch.sqrt(v2f)
    return vz, v2f - floor


def jam_grid_reconstruct(spec, c1, c2, theta0, floor):
    """:func:`jam_grid_reconstruct_plain`'s function, arguments and shapes, in
    one kernel launch on a CUDA device; coefficients on the CPU take the
    plain version."""
    if c1.device.type == "cpu":
        return jam_grid_reconstruct_plain(spec, c1, c2, theta0, floor)
    if c1.device.type != "cuda":
        raise TypeError(f"jam_grid_reconstruct: unsupported device {c1.device}")
    _check_layout()
    packed, out, _ = _pack(c1.device, spec, c1, c2, theta0, floor)
    JAM_GRID_RECONSTRUCT(ctypes.addressof(packed),
                         stream=torch.cuda.current_stream(c1.device).cuda_stream)
    count("jam.recon_kernel")
    return out


def _pack(device, spec, c1, c2, theta0, floor):
    """The launcher's argument on ``device``, the outputs it writes,
    ``(vz, v2zz)``, and the tensors it points to (to be kept until the
    launch).  Raises on a dtype, device or shape the kernel does not take."""
    args = {name: getattr(spec, name) for name in _STARS + ("mult_odd", "mult_even")}
    args.update(c1=c1, c2=c2, theta0=theta0)
    for name, v in args.items():
        if name == "theta0" and isinstance(v, (int, float, np.floating, np.integer)):
            continue
        if not torch.is_tensor(v):
            raise TypeError(f"jam_grid_reconstruct: {name} must be a tensor"
                            + (" or a number" if name == "theta0" else "")
                            + f", got {type(v).__name__}")
        if v.device != device or v.dtype != torch.float32:
            raise TypeError(f"jam_grid_reconstruct: {name}: expected float32 on "
                            f"{device}, got {v.dtype} on {v.device}")
    if c1.dim() != 3 or c2.shape != c1.shape:
        raise ValueError(f"jam_grid_reconstruct: c1 {tuple(c1.shape)} and c2 "
                         f"{tuple(c2.shape)}: expected one (W, n_r, n_phi) shape")
    W, n_r, n_phi = c1.shape
    N = spec.t_star.shape[0]
    want = dict(t_star=(N, n_r), mult_odd=(n_phi,), mult_even=(n_phi,),
                **{name: (N, n_phi) for name in _STARS[1:]})
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"jam_grid_reconstruct: {name} has shape "
                             f"{tuple(args[name].shape)}, expected {shape} from c1 "
                             f"{tuple(c1.shape)} and {N} stars")
    if torch.is_tensor(theta0):
        args["theta0"] = theta0 = theta0.reshape(-1)
        if theta0.numel() not in (1, W):
            raise ValueError(f"jam_grid_reconstruct: theta0 has {theta0.numel()} "
                             f"values for {W} walkers")

    fields = (_Strided * len(_FIELDS))()
    for f, name in zip(fields, _FIELDS):
        v = args[name]
        if not torch.is_tensor(v):
            f.ptr, f.value = None, float(v)
            continue
        f.ptr = v.data_ptr()
        strides = [s if n > 1 else 0 for s, n in zip(v.stride(), v.shape)]
        f.s0, f.s1, f.s2 = strides + [0] * (3 - len(strides))
    vz = torch.empty((W, N), dtype=torch.float32, device=device)
    v2zz = torch.empty((W, N), dtype=torch.float32, device=device)
    packed = _Args(fields, vz.data_ptr(), v2zz.data_ptr(), W, N, n_r, n_phi, float(floor))
    return packed, (vz, v2zz), args
