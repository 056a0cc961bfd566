"""Device selection for the port's entry points."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the CUDA card: under a process group, the card
    ``LOCAL_RANK`` (one process per device).  Without that card, raise: an
    entry point never moves to the CPU on its own; the caller asks for it
    with ``device="cpu"`` (or names a card, as ranks that share one do)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local} has no card ({torch.cuda.device_count()} "
                "visible); pass device= to place ranks that share a card")
        return torch.device("cuda", local)
    return torch.device("cuda")
