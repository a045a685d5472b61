"""Process-group start-up, the counterpart of the JAX package's
parallel/multihost.py (the distributed runtime's initialize).

One process a card (or a CPU process under Gloo). The model is
replicated and the batch axis is split across ranks (parallel/mesh.py);
the only collectives are the training gradient's all-reduce and the
gathers of the sweep's traces and estimates.

    from score_based_channels_torch.parallel import multihost
    multihost.initialize()       # under torchrun: env:// (its variables)
    multihost.initialize("127.0.0.1:29500", num_processes=2, process_id=r,
                         device="cpu")   # explicit, Gloo on the CPU
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from .._device import resolve_device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device: Optional[Union[str, torch.device]] = None) -> str:
    """torch.distributed.init_process_group, returning the backend.

    With no address, world size or rank, the group is set up from the
    environment (`env://`, as torchrun sets it); otherwise from
    `tcp://<coordinator_address>` with the given world size and rank.
    The backend is NCCL when the port's device (`device`, None: the card)
    is CUDA and Gloo on the CPU; under NCCL each process takes the card of
    its local rank (LOCAL_RANK, else its rank modulo the cards)."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        rank = int(os.environ.get("RANK", 0))
        kwargs = dict(init_method="env://")
    else:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError("pass coordinator_address, num_processes and "
                             "process_id together, or none of them")
        rank = process_id
        kwargs = dict(init_method=f"tcp://{coordinator_address}",
                      world_size=num_processes, rank=process_id)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend=backend, **kwargs)
    return backend


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs: rank 0, or
    the only process when no group is initialised."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0
