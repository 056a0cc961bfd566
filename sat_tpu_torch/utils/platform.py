"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the CUDA card.  Without one, raise: an entry point never
    moves to the CPU on its own; the caller asks for it with ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


def require_one_device(mesh_shape, mesh_axes, what: str) -> None:
    """The port runs on one device: ``mesh_shape`` (-1,) or (1,) on the
    ``data`` axis.  Anything else raises ``NotImplementedError`` naming the
    work that would lift the rule."""
    if tuple(mesh_shape) not in ((-1,), (1,)) or tuple(mesh_axes) != ("data",):
        raise NotImplementedError(
            f"--mesh_shape/--mesh_axes: the port {what} on one device; "
            "multi-GPU and vocab-dim tensor parallelism are ROADMAP.md §1 "
            "item 11")
