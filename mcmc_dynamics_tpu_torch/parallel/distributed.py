"""Multi-process execution: one rank a device under ``torch.distributed``.

Counterpart of ``mcmc_dynamics_tpu/parallel/distributed.py``.  The JAX package
wires one process per host into one runtime and drives every local device
from it; here every device has a process of its own (a rank), started by
``torchrun --nproc-per-node N`` (or a cluster launcher) or by the run
config's ``parallel.distributed`` block, and every rank runs the same script.
This module holds the plumbing at the process boundary:

* :func:`initialize`: idempotent; from its arguments or the ``torchrun``
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``); a no-op for a single process;
* :func:`global_mesh`: a mesh over every rank (:func:`~.mesh.make_mesh`);
* :func:`to_global`: a host array -> this rank's shard along a spec's axes;
* :func:`fetch`: a tensor or a sharded result's field -> the full host array;
* :func:`is_primary` / :func:`barrier` / :func:`checkpoint_dir_is_shared`:
  the primary-only checkpoint discipline.

Everything is a no-op or a thin wrapper without a process group, so library
code calls these helpers unconditionally.
"""

from __future__ import annotations

import datetime
import logging
import os
import pathlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

logger = logging.getLogger(__name__)

__all__ = ["initialize", "shutdown", "is_distributed", "is_primary",
           "global_mesh", "to_global", "fetch", "barrier",
           "mesh_spans_processes", "checkpoint_dir_is_shared"]


def _init_method(address: str) -> str:
    """``host:port`` -> ``tcp://host:port``; a URL (``file://``, ``tcp://``,
    ``env://``) as it is."""
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_rank: Optional[int] = None, auto: bool = False,
               timeout_s: float = 600.0) -> bool:
    """Join this process to the world of ranks.

    Call once at program start on every rank.  With no arguments the values
    come from the ``torchrun`` environment (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``); without those it is a no-op and
    the program stays one process.  ``coordinator_address`` is ``host:port``
    of rank 0 or an ``init_method`` URL (``file:///shared/path`` for a
    rendezvous file); ``auto=True`` takes everything from the environment.

    The card is chosen before the process group: ``cuda:(local_rank mod the
    card count)``, so ranks beyond the card count share cards (the transport
    is then chosen by :func:`~.mesh.make_mesh`).  The default group is gloo;
    NCCL groups are made per mesh.  Returns True when a world of more than
    one rank is (or already was) up.  Idempotent."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if local_rank is None and "LOCAL_RANK" in env:
        local_rank = int(env["LOCAL_RANK"])

    if coordinator_address is None and not auto:
        if num_processes not in (None, 1):
            raise ValueError("num_processes > 1 requires a coordinator_address "
                             "(host:port of rank 0, or an init_method URL).")
        return False
    if num_processes is None or process_id is None:
        raise ValueError("a multi-process world needs num_processes and "
                         "process_id (or WORLD_SIZE and RANK).")
    if torch.cuda.is_available():
        local = process_id if local_rank is None else local_rank
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        "gloo", init_method=_init_method(coordinator_address or "env://"),
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("torch.distributed initialized: rank %d of %d",
                dist.get_rank(), dist.get_world_size())
    return dist.get_world_size() > 1


def shutdown() -> None:
    """Tear down the process group (tests, clean exits)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def is_primary() -> bool:
    """True on the rank that owns checkpoint and log writes (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_mesh(axis_names: Sequence[str] = ("dp", "sp"),
                shape: Optional[Sequence[int]] = None, device="cuda") -> Mesh:
    """A mesh over every rank of the world: :func:`~.mesh.make_mesh`, named
    for the contract that the mesh is the same on every rank."""
    return make_mesh(axis_names, shape=shape, device=device)


def mesh_spans_processes(mesh: Mesh) -> bool:
    """True when ``mesh`` has ranks other than this one (any world of more
    than one rank: every device is a process of its own)."""
    return mesh.size > 1


def to_global(mesh: Mesh, spec, host_array) -> torch.Tensor:
    """A host array every rank holds in full -> this rank's shard on its
    device.  ``spec`` names a mesh axis (or None) per leading dimension, as a
    ``PartitionSpec``; a named dimension is split into the axis' extent of
    equal blocks and this rank keeps the block at its coordinate."""
    arr = np.asarray(host_array)
    index = []
    for dim, name in enumerate(tuple(spec)):
        if name is None:
            index.append(slice(None))
            continue
        n = mesh.shape[name]
        if arr.shape[dim] % n:
            raise ValueError(f"dimension {dim} ({arr.shape[dim]}) does not "
                             f"split over {name}={n}")
        block = arr.shape[dim] // n
        c = mesh.coordinate(name)
        index.append(slice(c * block, (c + 1) * block))
    return torch.as_tensor(np.ascontiguousarray(arr[tuple(index)]),
                           device=mesh.device)


def fetch(value) -> np.ndarray:
    """Any tensor or array -> host numpy.  The port's results are replicated
    on every rank when they leave a sampler (sharded fields are gathered by
    the result objects themselves, collectively), so this is the copy to the
    host."""
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def barrier(name: str = "mcmc_dynamics_tpu") -> None:
    """Block until every rank reaches this point (no-op for one process).

    Used around primary-only filesystem work: other ranks must not race ahead
    and read a checkpoint the primary is still writing."""
    del name
    if is_distributed():
        dist.barrier()


def checkpoint_dir_is_shared(prefix: str) -> bool:
    """True when every rank sees every rank's files under ``prefix``.

    The shard-file checkpoint (``Runner.save_current_status_shards``) needs
    the checkpoint directory on shared storage.  Every rank drops a marker, a
    barrier fences the writes, each checks it sees all markers, and an
    all-reduce forms the consensus (visibility can be asymmetric).  One
    process is trivially shared."""
    if not is_distributed():
        return True
    me, n = dist.get_rank(), dist.get_world_size()
    probe = pathlib.Path(f"{prefix}.ckptprobe.{me}")
    # an unwritable directory must not raise out of the handshake: every rank
    # has to reach the barrier and the all-reduce below
    try:
        probe.write_text("probe")
        ok = True
    except OSError:
        ok = False
    barrier("ckpt-probe-write")
    ok = ok and all(pathlib.Path(f"{prefix}.ckptprobe.{q}").exists()
                    for q in range(n))
    flag = torch.tensor([0 if ok else 1], dtype=torch.int32)
    dist.all_reduce(flag)    # the default (gloo) group: every rank's verdict
    barrier("ckpt-probe-read")
    try:
        probe.unlink()
    except OSError:
        pass
    shared = int(flag) == 0
    if not shared:
        logger.warning(
            "checkpoint directory for prefix %r is NOT shared across the %d "
            "ranks; falling back to the gathering checkpoint path.", prefix, n)
    return shared
