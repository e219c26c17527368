"""Multi-process start-up (torch counterpart of
``stereo_match_traditional_tpu.parallel.distributed``).

One process a device.  The launch is the environment torchrun sets
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), or explicit arguments:

    torchrun --nproc-per-node 4 -m stereo_match_traditional_tpu_torch.cli \\
        run ad_census --synthetic 720x1280 --disp-range 128 --executor tiled

    from stereo_match_traditional_tpu_torch.parallel import distributed
    distributed.initialize()                 # env-driven under torchrun
    mesh = distributed.host_chip_mesh()      # DeviceMesh[(host, chip)]
    fn = tiled_pipeline("ad_census", cfg, mesh, axis_name="chip")

A process started alone gets a process group of world 1 (an in-process
store, no port), so that every mesh has a group.  NCCL is the backend on
the card, gloo on the CPU; gloo may be asked for on the card too (two
processes sharing one card, where NCCL refuses), and its exchanges then go
through host memory (``parallel.comm``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

#: How long a collective waits for the other ranks before it raises.
TIMEOUT = datetime.timedelta(seconds=600)


def _multi_process_requested() -> bool:
    """Whether the environment asks for more than one process (torchrun's
    ``WORLD_SIZE``): a failure to start is then raised, never turned into a
    single-process run, which would silently build a wrong mesh."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def device_type() -> str:
    """The device of this process' ranks: ``cuda`` on an NCCL group, else
    ``cpu`` (a gloo group; CUDA tensors are staged through host memory)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> str:
    """Idempotent ``torch.distributed.init_process_group``, driven by the
    environment when the arguments are None.

    ``coordinator_address`` is ``host:port`` (or ``tcp://host:port``) of
    rank 0; ``num_processes`` the world size, ``process_id`` this rank.
    ``backend``: ``nccl`` where CUDA is available, else ``gloo``.  Under
    NCCL each process takes the card ``LOCAL_RANK`` (default: its rank)
    modulo the cards it sees.

    Returns ``"initialized"`` (a group of several processes),
    ``"already-initialized"`` (a group exists: no-op), or
    ``"single-process"`` (nothing asked for more than one process: a group
    of world 1).  A multi-process start that was asked for and fails
    raises."""
    if dist.is_initialized():
        return "already-initialized"
    requested = (any(a is not None for a in (coordinator_address, num_processes, process_id))
                 or _multi_process_requested())
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if not requested:
        if backend == "nccl":
            torch.cuda.set_device(_local_rank(0) % torch.cuda.device_count())
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=TIMEOUT)
        return "single-process"
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if not coordinator_address.startswith("tcp://"):
        coordinator_address = "tcp://" + coordinator_address
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    if backend == "nccl":
        torch.cuda.set_device(_local_rank(rank) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=coordinator_address, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    return "initialized"


def host_chip_mesh(axis_names=("host", "chip")) -> DeviceMesh:
    """``(hosts, processes a host)`` mesh over every rank, ``LOCAL_WORLD_SIZE``
    processes a host (torchrun's; default: all on one host), ranks in
    torchrun's order, so that the chip axis stays within a host."""
    initialize()
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if per_host < 1 or world % per_host:
        raise ValueError(f"LOCAL_WORLD_SIZE {per_host} does not divide the world of {world}")
    ranks = torch.arange(world).reshape(world // per_host, per_host)
    return DeviceMesh(device_type(), ranks, mesh_dim_names=tuple(axis_names))
