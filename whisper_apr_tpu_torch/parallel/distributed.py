"""Multi-host runs: ``torch.distributed`` process groups and global meshes.
Port of ``whisper_apr_tpu/parallel/distributed.py``.

One process per device. Each host runs ``ranks_per_host`` of them
(rank = host * ranks_per_host + local rank); the mesh's ``dp`` dim spans
the hosts while each ``tp`` group stays inside one host, so tp's
collectives never leave it.

Usage (one call per process):

    init_distributed("10.0.0.1:1234", num_processes=8, process_id=rank,
                     local_device_count=4)
    mesh = make_multihost_mesh(tp=2)
    params = shard_params(params, mesh)          # same specs as one host
    batch = host_local_batch_to_global(x, mesh)  # this host's rows
    ...
    rows = process_slice(out)                    # this host's rows back

The backend is NCCL on a CUDA device and gloo on the CPU, unless the
caller names one; a failure of either is raised, never retried on the
other. Gloo also carries CUDA tensors (``all_reduce`` and ``broadcast``
only), which is how two ranks share one GPU, where NCCL refuses.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import numpy as np
import torch

from .mesh import (coordinate, gather_dp, make_mesh, mesh_shape,  # noqa: F401
                   param_specs, shard_params)

_RANKS_PER_HOST: Optional[int] = None
_LAST_MESH = None


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int,
                     local_device_count: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout_s: float = 300.0) -> None:
    """Join the process group at ``coordinator_address`` ("host:port") as
    rank ``process_id`` of ``num_processes``. ``local_device_count`` is
    the ranks a host runs (by default the host's GPUs under NCCL, every
    rank under gloo). Under NCCL the rank takes GPU ``local rank``. Every
    collective gives up after ``timeout_s``."""
    import torch.distributed as dist
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if local_device_count is None:
        local_device_count = (min(torch.cuda.device_count(), num_processes)
                              if backend == "nccl" else num_processes)
    if local_device_count < 1 or num_processes % local_device_count:
        raise ValueError(f"{num_processes} ranks do not fill hosts of "
                         f"{local_device_count}")
    device = None
    if backend == "nccl":
        device = torch.device("cuda", process_id % local_device_count)
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s), device_id=device)
    global _RANKS_PER_HOST
    _RANKS_PER_HOST = local_device_count


def ranks_per_host() -> int:
    """Ranks on each host (``init_distributed``'s local_device_count)."""
    import torch.distributed as dist
    return _RANKS_PER_HOST or dist.get_world_size()


def make_multihost_mesh(tp: int = 1, devices: Optional[Sequence[int]] = None):
    """The global (dp, tp) mesh, each tp group inside one host's ranks:
    ranks are host-major, so consecutive ranks share a host. A tp that
    does not divide the ranks per host raises ValueError, as in JAX."""
    global _LAST_MESH
    n_local = ranks_per_host()
    if n_local % tp:
        raise ValueError(f"tp={tp} does not divide local devices {n_local}")
    _LAST_MESH = make_mesh(tp=tp, devices=devices)
    return _LAST_MESH


def _host_dp(mesh):
    """(dp shards per host, this rank's host index)."""
    import torch.distributed as dist
    return (ranks_per_host() // mesh_shape(mesh)["tp"],
            dist.get_rank() // ranks_per_host())


def host_local_batch_to_global(x, mesh, axis: int = 0,
                               device=None) -> torch.Tensor:
    """This rank's dp shard of a global batch that each host feeds with
    its own rows: ``x`` holds this host's rows (the same on each of its
    ranks), split over the host's dp shards in order; the global batch
    is the hosts' rows in host order. Returns this rank's rows, on
    ``device`` (x's own by default)."""
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    per_host, _ = _host_dp(mesh)
    n = t.shape[axis]
    if n % per_host:
        raise ValueError(f"{n} host rows do not split over {per_host} "
                         f"dp shards")
    k = n // per_host
    i = coordinate(mesh)[0] % per_host
    out = t.narrow(axis, i * k, k)
    return out if device is None else out.to(device)


def process_slice(global_out: torch.Tensor, axis: int = 0,
                  mesh=None) -> np.ndarray:
    """This host's rows of a dp-sharded output (the inverse of
    :func:`host_local_batch_to_global`), one copy per dp shard even
    where tp replicates them. ``global_out`` is this rank's dp shard;
    every rank calls this (the shards travel over the dp group). The
    mesh defaults to the last :func:`make_multihost_mesh`."""
    mesh = mesh if mesh is not None else _LAST_MESH
    if mesh is None:
        raise ValueError("process_slice needs the mesh")
    per_host, host = _host_dp(mesh)
    allrows = gather_dp(global_out, mesh, axis=axis)
    k = global_out.shape[axis]
    return allrows.narrow(axis, host * per_host * k,
                          per_host * k).cpu().numpy()
