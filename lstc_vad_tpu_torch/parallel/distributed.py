"""Multi-process runs: one process per device, joined by torch.distributed —
counterpart of lstc_vad_tpu/parallel/distributed.py.

``initialize_multihost`` joins the process group: ``--multihost
COORD:PORT`` with ``--num-processes`` and ``--process-id`` becomes
``init_process_group(init_method="tcp://COORD:PORT", ...)``, ``--multihost
auto`` reads torchrun's variables (``env://``).  The backend follows the
run's device: NCCL for the card, gloo for the CPU, never one in place of the
other.  Each process takes ``cuda:LOCAL_RANK`` (``local_device``).
``make_global_mesh`` then builds the (data, model) mesh over every process,
with the model axis inside one host, as the JAX function keeps it inside
one host's ICI domain.
"""

from __future__ import annotations

import os
import socket
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import _BACKEND, factor_devices, make_mesh

_owned = False  # this module initialized the process group


def world_size() -> int:
    """The launched world: the process group's, else torchrun's
    WORLD_SIZE, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda", alone: bool = False) -> bool:
    """Join the process group; returns whether this call created it.  A
    second call is a no-op.  With a coordinator ("host:port", or any
    ``init_method`` URL such as ``file:///path``), failures raise.  Without
    one, torchrun's variables are read; when there are none, the run is one
    process on its own, with a warning unless ``alone`` says that is
    expected."""
    global _owned
    if dist.is_initialized():
        return False
    backend = _BACKEND[torch.device(device).type]
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
    elif "MASTER_ADDR" in os.environ and "RANK" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        if not alone:
            warnings.warn("no torchrun environment (MASTER_ADDR, RANK): "
                          "running as one process")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    _owned = True
    return True


def shutdown():
    """Leave the process group, if this module created it."""
    global _owned
    if _owned and dist.is_initialized():
        dist.destroy_process_group()
    _owned = False


def local_rank() -> int:
    """This process's index among the processes of its host: torchrun's
    LOCAL_RANK, else the global rank modulo the cards visible."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = max(torch.cuda.device_count(), 1)
    return (dist.get_rank() if dist.is_initialized() else 0) % n


def local_device(device="cuda") -> torch.device:
    """The device of this process: ``cuda:LOCAL_RANK`` (made current) for a
    CUDA run, the CPU otherwise."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    dev = torch.device("cuda", local_rank() if dev.index is None
                       else dev.index)
    torch.cuda.set_device(dev)
    return dev


def local_world_size() -> int:
    """The processes on this host: torchrun's LOCAL_WORLD_SIZE, else a
    count of the ranks that share this host's name."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return 1
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return names.count(socket.gethostname())


def make_global_mesh(n_head: int = 8, max_model: int = 4,
                     device_type: str = "cpu"):
    """The (data, model) mesh over every process; the model axis divides
    the processes of one host (so tensor-parallel collectives stay on the
    host's links) and caps at 4 like ``factor_devices``; data absorbs the
    rest."""
    _, model = factor_devices(local_world_size(), n_head=n_head,
                              max_model=max_model)
    return make_mesh(world_size() // model, model, device_type)
