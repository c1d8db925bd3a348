"""Device selection shared by every entry point.

Entry points default to the CUDA card and never drop to the CPU on their own:
a run that asked for the card and finds none fails here, with the remedy in
the message.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` ("cuda", "cuda:N", "cpu" or a ``torch.device``) -> a
    ``torch.device``; raises RuntimeError when CUDA is asked for and no card
    is visible.  In a process of a multi-process run (an initialized
    process group), "cuda" is this process's card, ``cuda:LOCAL_RANK``
    (parallel/distributed.py::local_device)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; expected 'cuda' "
                         "or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA card; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            from .parallel.distributed import local_device

            return local_device(dev)
    return dev
