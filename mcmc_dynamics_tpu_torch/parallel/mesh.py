"""Device meshes over ``torch.distributed``: one rank a device, named axes.

Counterpart of ``mcmc_dynamics_tpu/parallel/mesh.py``.  The JAX package drives
every local device from one process and names its mesh axes for
``shard_map``; PyTorch runs one process (rank) a device, so a mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the world,
wrapped in :class:`Mesh`, which keeps the JAX API its callers read
(``mesh.shape[name]``, ``name in mesh.shape``) and adds the collectives the
samplers run along one axis.

The transport is chosen once, when the mesh is built, from what the ranks
report about their devices (never by catching an error):

* ``"nccl"``: every rank owns its own GPU; collectives run on the card;
* ``"gloo"``: the ranks run on the CPU (the tests);
* ``"gloo-staged"``: several ranks share one card (NCCL refuses two ranks on
  one GPU).  Each collective copies its tensor to the host, runs gloo and
  copies the result back; the kernels still run on the card.

The world's default process group is gloo in every case: it carries
``barrier`` and the checkpoint handshakes beside NCCL.
"""

from __future__ import annotations

import socket
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "factorize_devices"]


def factorize_devices(n_devices: int, n_axes: int = 2) -> Tuple[int, ...]:
    """Split a device count into an ``n_axes``-long mesh shape, as balanced
    as an exact factorization allows (largest factors on the leading axes)."""
    if n_axes < 1:
        raise ValueError(f"n_axes must be >= 1 (got {n_axes}).")
    if n_axes == 1:
        return (n_devices,)
    # the largest factor <= the n_axes-th root goes on the LAST axis; recurse
    root = max(1, round(n_devices ** (1.0 / n_axes)))
    last = 1
    for f in range(1, n_devices + 1):
        if n_devices % f == 0 and f <= root:
            last = f
    return factorize_devices(n_devices // last, n_axes - 1) + (last,)


class Mesh:
    """A named mesh of ranks, one device each.

    ``shape`` maps each axis name to its extent (in mesh order), ``device`` is
    this rank's device and ``backend`` the transport of the collectives
    (module docstring).  The collectives run along one axis, among the ranks
    that share every other coordinate, and every rank of that group must
    reach them."""

    def __init__(self, device_mesh, device: torch.device, backend: str,
                 groups: Optional[Dict[str, object]] = None):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self.device = device
        self.backend = backend
        # NCCL groups by axis (None: the DeviceMesh's gloo groups)
        self._groups = groups or {}

    def __repr__(self):
        return (f"Mesh({self.shape}, backend={self.backend!r}, "
                f"device={self.device})")

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()))) if self.shape else 1

    def group(self, name: str):
        """The process group of this rank's line along axis ``name``."""
        if name in self._groups:
            return self._groups[name]
        return self.device_mesh.get_group(name)

    def coordinate(self, name: str) -> int:
        """This rank's coordinate along axis ``name``."""
        return int(self.device_mesh.get_local_rank(name))

    # ------------------------------------------------------------ collectives
    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        return x.cpu() if self.backend == "gloo-staged" else x

    def _back(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device) if self.backend == "gloo-staged" else x

    def all_gather(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """The blocks ``x`` of every rank along ``name``, concatenated on
        dim 0 in coordinate order (``jax.lax.all_gather(..., tiled=True)``)."""
        n = self.shape[name]
        xs = self._stage(x)
        out = torch.empty((n * xs.shape[0],) + tuple(xs.shape[1:]),
                          dtype=xs.dtype, device=xs.device)
        dist.all_gather_into_tensor(out, xs, group=self.group(name))
        return self._back(out)

    def all_reduce(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """The sum of ``x`` over the ranks along ``name`` (``psum``)."""
        xs = self._stage(x).clone()
        dist.all_reduce(xs, op=dist.ReduceOp.SUM, group=self.group(name))
        return self._back(xs)

    def broadcast(self, x: torch.Tensor, name: str, src: int = 0) -> torch.Tensor:
        """Coordinate ``src``'s ``x`` on every rank along ``name``."""
        group = self.group(name)
        xs = self._stage(x).clone()
        dist.broadcast(xs, src=dist.get_global_rank(group, src), group=group)
        return self._back(xs)


def _ensure_world():
    """The default process group; a one-rank gloo world when none exists."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)


def _card_is_shared(device: torch.device) -> bool:
    """True when another rank of the world reports the same host and card."""
    here = (socket.gethostname(), int(device.index))
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, here)
    return len(set(seen)) < len(seen)


def make_mesh(axis_names: Sequence[str] = ("dp", "sp"),
              shape: Optional[Sequence[int]] = None,
              device="cuda") -> Mesh:
    """A mesh of the world's ranks with ``axis_names``, one device a rank.

    ``shape`` defaults to :func:`factorize_devices` of the world size and
    must cover the world.  ``device`` is this rank's device type: ``"cuda"``
    takes the current card (``parallel.distributed.initialize`` sets it) and
    raises without one; ``"cpu"`` runs gloo on the host.  Without a process
    group a one-rank world is created, so a one-device mesh needs no launch.
    Default axes for this workload: ``dp`` = walkers and ``sp`` = stars
    (each rank holds a slice of the catalog and the partial sums are
    all-reduced)."""
    from .. import resolve_device
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    _ensure_world()
    n = dist.get_world_size()
    axis_names = tuple(axis_names)
    if shape is None:
        shape = factorize_devices(n, len(axis_names))
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))} "
                         f"devices (ranks), the world has {n}")
    device_mesh = init_device_mesh("cpu", shape, mesh_dim_names=axis_names)
    if device.type == "cpu":
        return Mesh(device_mesh, device, "gloo")
    device = torch.device("cuda", torch.cuda.current_device())
    if _card_is_shared(device):
        return Mesh(device_mesh, device, "gloo-staged")
    # every rank owns its card: one NCCL group per line of every axis, made
    # by every rank in the same order (new_group is collective)
    ranks = device_mesh.mesh
    me = dist.get_rank()
    groups = {}
    for i, name in enumerate(axis_names):
        lines = ranks.movedim(i, -1).reshape(-1, shape[i]).tolist()
        for line in lines:
            group = dist.new_group(line, backend="nccl")
            if me in line:
                groups[name] = group
    return Mesh(device_mesh, device, "nccl", groups)
