"""The port's training CLI, the counterpart of the root ``train.py``:

    python -m sat_tpu_torch.train --json data.json --batch 64 --epochs 10 ...

It takes ``sat_tpu/config.py``'s flags (``config.build_arg_parser``) and
``--log_root`` (default ``logs``), seeds the process, builds the
``Trainer`` on the CUDA card and runs ``fit``.  ``main(argv, device="cpu")``
runs on the CPU.

    python -m sat_tpu_torch.train --resume logs/run/version_0/last.ckpt --epochs 80

continues a run (a JAX package's checkpoint too): as in ``train.py``, the
model and optimizer settings come from the checkpoint's header, and only
``--epochs``, ``--name``, ``--json`` (default: the header's), ``--workers``,
``--val_interval``, ``--val_percent`` and ``--profile_dir`` from the
command line.

Data parallelism and vocab-dim tensor parallelism run one process per
device under ``torch.distributed`` (``parallel/mesh.py``):

    torchrun --nproc_per_node 2 -m sat_tpu_torch.train --mesh_shape 2 ...
    torchrun --nproc_per_node 4 -m sat_tpu_torch.train \
        --mesh_shape 2 2 --mesh_axes data model ...

joins the process group from torchrun's variables first
(``maybe_initialize_distributed``: NCCL on cards, gloo on the CPU, or
``$SAT_TORCH_DIST_BACKEND``); each rank takes the card ``LOCAL_RANK``."""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence, Union

import torch

from ..config import config_from_args
from ..utils.seeding import seed_everything


def main(argv: Optional[Sequence[str]] = None,
         device: Union[str, torch.device, None] = None) -> Dict[str, float]:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--log_root", default="logs")
    known, rest = pre.parse_known_args(argv)
    cfg = config_from_args(rest)
    if cfg.resume:
        from .checkpoints import read_checkpoint_config
        ck = read_checkpoint_config(cfg.resume)
        cfg = ck.replace(resume=cfg.resume, epochs=cfg.epochs, name=cfg.name,
                         json=cfg.json or ck.json, workers=cfg.workers,
                         val_interval=cfg.val_interval,
                         val_percent=cfg.val_percent,
                         profile_dir=cfg.profile_dir)
    seed_everything(cfg.seed)
    from ..parallel.mesh import maybe_initialize_distributed
    from .loop import Trainer
    maybe_initialize_distributed()
    print(f" * Effective Batch Size = {cfg.batch * cfg.accumulate}")
    trainer = Trainer(cfg, log_root=known.log_root, device=device)
    metrics = trainer.fit()
    print("final validation:", metrics)
    return metrics


if __name__ == "__main__":
    main()
