"""Multi-process runtime entry on ``torch.distributed`` (port of
``cilantro_tpu/parallel/distributed.py``).

The one place a launcher touches:

    # on every process, e.g. under ``torchrun --nproc-per-node=N`` on a
    # host with N cards:
    from cilantro_tpu_torch.parallel import initialize_distributed, make_mesh
    initialize_distributed()            # reads torchrun's variables
    mesh = make_mesh(n_map_shards=torch.distributed.get_world_size())

Each process is one rank and works on one device: NCCL rank ``r`` on
``cuda:LOCAL_RANK``, gloo ranks on the CPU or on a card the caller
chooses. Every sharded entry point of this package then runs SPMD over the
mesh: each rank runs the body on its own shard and the collectives ride
the mesh's per-axis process groups (:mod:`.collectives`).

A single process needs no initialization: :func:`initialize_distributed`
returns False there, and :func:`.sharded.make_mesh` creates a world of one.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# Every process group of this package waits at most this long for a peer.
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
    *,
    backend: Optional[str] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Join the process group (idempotent).

    The arguments default from torch's own variables: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (the coordinator), ``WORLD_SIZE``, ``RANK`` and
    ``LOCAL_RANK`` (the card, for NCCL). ``coordinator_address`` is
    ``host:port`` or an ``init_method`` URL (``tcp://...``,
    ``file:///...``). ``local_device_ids`` names the card (an int or a
    sequence whose first entry is used). ``backend`` defaults to NCCL when
    CUDA is available, gloo otherwise. Returns True when a multi-process
    group is (or already was) joined, False in a single process."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None and process_id is None:
        return False  # a single process: nothing to coordinate
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize_distributed needs the coordinator, the process count and the "
                         f"process id (got {coordinator_address!r}, {num_processes}, {process_id})")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        if local_device_ids is None:
            local_device_ids = int(env.get("LOCAL_RANK", 0))
        card = local_device_ids if isinstance(local_device_ids, int) else list(local_device_ids)[0]
        torch.cuda.set_device(card)
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes, rank=process_id,
                            timeout=timeout)
    return True


def process_info():
    """``(rank, world size, local cards, global devices)``: one device a
    rank, so the global count is the world size; a single process without
    a group counts its own cards (1 on a machine without CUDA)."""
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    if not dist.is_initialized():
        return 0, 1, local, local
    world = dist.get_world_size()
    return dist.get_rank(), world, local, world
