"""Embedding projector export, ported from ``sat_tpu/evalx/projector.py``
(reference: embeddings_to_tensorboard.py:13-22): the embedding matrix and
the vocabulary's words for the TensorBoard projector, or, where
``torch.utils.tensorboard`` does not import, as the TSV pair that
projector.tensorflow.org reads.

    python -m sat_tpu_torch.evalx.projector --checkpoint last.ckpt

``main(argv, device="cpu")`` loads the checkpoint on the CPU; by default on
the CUDA card, raising without one."""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch


def export_embeddings(model, logdir: str = "logs/embeddings") -> str:
    emb = model.decoder.embedding.detach().float().cpu().numpy()
    words = [model.vocab.itos(i) for i in range(model.vocab.size)]
    os.makedirs(logdir, exist_ok=True)
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        np.savetxt(os.path.join(logdir, "embeddings.tsv"), emb, delimiter="\t")
        with open(os.path.join(logdir, "metadata.tsv"), "w") as f:
            f.write("\n".join(words))
        return logdir
    w = SummaryWriter(log_dir=logdir)
    w.add_embedding(torch.tensor(emb), metadata=words)
    w.close()
    return logdir


def main(argv: Optional[Sequence[str]] = None,
         device: Union[str, torch.device, None] = None) -> str:
    from ..train.checkpoints import load_any_checkpoint
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--logdir", default="logs/embeddings")
    a = p.parse_args(argv)
    model = load_any_checkpoint(a.checkpoint, device=device)
    out = export_embeddings(model, a.logdir)
    print("exported to", out)
    return out


if __name__ == "__main__":
    main()
