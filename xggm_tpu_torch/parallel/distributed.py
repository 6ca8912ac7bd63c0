"""Multi-process runtime over `torch.distributed` (counterpart of
`xggm_tpu/parallel/distributed.py`).

A rank is one process driving one card (the CPU in the tests), and the
data-parallel group is the default process group. Every rank runs the same
program on its own slice of each global batch:

  * `init_distributed`   joins a world through a TCP rendezvous at a
    coordinator address (`--coordinator H:P --num_hosts N --host_id I`);
    `init_from_env` joins the world that torchrun's environment describes
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT). NCCL is the backend for a
    CUDA device and gloo for the CPU, unless the caller names one;
  * `host_barrier`       aligns every rank at a named point through the
    process group's key-value store, with a timeout the caller sets;
  * `process_slice`      is the contiguous chunk of a global batch that a
    rank feeds;
  * `to_host`            gathers each rank's rows of a result (eval
    predictions) to every rank, in rank order;
  * `host_scalar`        reads a step metric as a host float (from
    `utils/guard.py`; a rank's metrics are its own tensors).

There is no device ordering to compute, as `make_hybrid_mesh` does for a
TPU slice: a rank owns one device, and NCCL picks its own rings.
"""
from __future__ import annotations

import datetime
import itertools
import os
import socket
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from xggm_tpu_torch.utils.guard import host_scalar  # noqa: F401 - re-export

# barrier keys: every rank passes the same barriers in the same order
_barriers = itertools.count()


def default_backend(device: Union[str, torch.device]) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


def _join(init_method: str, world: int, rank: int, backend: Optional[str],
          device: Union[str, torch.device], timeout_s: float) -> None:
    dev = torch.device(device)
    if dist.is_initialized():
        raise RuntimeError("this process has joined a process group already")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or default_backend(dev),
                            init_method=init_method, world_size=world,
                            rank=rank, timeout=_timeout(timeout_s))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device: Union[str, torch.device] = "cuda",
                     timeout_s: float = 1800.0) -> Tuple[int, int]:
    """Join the world of `num_processes` ranks that meets at
    `coordinator_address` (host:port; rank 0 listens there) as rank
    `process_id`, over `backend` (default: `default_backend(device)`).
    Returns (rank, world size). With nothing given it joins nothing and
    returns this process's place: (0, 1), or its rank in a group it has
    joined already."""
    given = (coordinator_address, num_processes, process_id)
    if all(x is None for x in given):
        if dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
        return 0, 1
    if any(x is None for x in given):
        raise ValueError("a coordinator address, the number of processes and "
                         "this process's id go together")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside a world of "
                         f"{num_processes}")
    _join(f"tcp://{coordinator_address}", num_processes, process_id,
          backend, device, timeout_s)
    return process_id, num_processes


def init_from_env(backend: Optional[str] = None,
                  device: Union[str, torch.device] = "cuda",
                  timeout_s: float = 1800.0) -> Tuple[int, int]:
    """Join the world that torchrun's environment describes (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT); returns (rank, world size)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    _join("env://", world, rank, backend, device, timeout_s)
    return rank, world


def torchrun_environment() -> bool:
    """Whether torchrun's environment describes a world to join."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                         "MASTER_PORT"))


def host_ranks() -> Tuple[int, int]:
    """(this rank's index among the ranks on its host, the number of ranks
    on its host), from the host name each rank posts on the process group's
    store: the index is the card a rank drives. (0, 1) outside a group."""
    rank, size = world()
    if size <= 1:
        return 0, 1
    store = dist.distributed_c10d._get_default_store()
    me = socket.gethostname()
    store.set(f"xggm/host/{rank}", me)
    hosts = [store.get(f"xggm/host/{r}").decode() for r in range(size)]
    return hosts[:rank].count(me), hosts.count(me)


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> Tuple[int, int]:
    """(rank, world size) of this process: (0, 1) outside a group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_barrier(name: str, timeout_s: float = 1800.0) -> None:
    """Wait until every rank has reached the barrier `name`, through the
    process group's key-value store: no device collective runs, so ranks
    may arrive minutes apart. Raises after `timeout_s`. A no-op outside a
    group of more than one rank."""
    rank, size = world()
    if size <= 1:
        return
    store = dist.distributed_c10d._get_default_store()
    key = f"xggm/barrier/{next(_barriers)}/{name}"
    if store.add(key, 1) == size:
        store.set(key + "/go", "1")
    store.wait([key + "/go"], _timeout(timeout_s))


def process_slice(rows, process_index: int, process_count: int):
    """The contiguous leading-dim chunk of a global batch that rank
    `process_index` feeds (an index list, an array or a tensor; a basic
    slice). Raises when the batch does not divide."""
    n = len(rows)
    if n % process_count != 0:
        raise ValueError(f"global batch {n} not divisible by "
                         f"process_count {process_count}")
    local = n // process_count
    return rows[process_index * local:(process_index + 1) * local]


def to_host(x: torch.Tensor, mesh=None) -> np.ndarray:
    """`x`, each data rank's rows of one result, as the whole result on
    every rank: the data group's rows in rank order (an all-gather), as
    numpy. With no mesh, or a data group of one rank, `x` itself."""
    if mesh is None or mesh.size == 1:
        return x.detach().cpu().numpy()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.detach().contiguous(), group=mesh.data_group)
    return torch.cat(parts).cpu().numpy()
