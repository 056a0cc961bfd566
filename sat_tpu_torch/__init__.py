"""SAT-TPU ported to PyTorch and CUDA for NVIDIA Hopper (H100).

The JAX package ``sat_tpu`` is the reference; this package follows its module
layout (``config``, ``vocab``, ``models``, ``ops``, ``kernels``, ``decode``,
``train``) so each function has a counterpart of the same name.  It imports
neither JAX nor ``sat_tpu``.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; the two decode kernels are CUDA C++ under ``csrc/``,
built with ``nvcc`` at first use.

Public API (lazy: importing sat_tpu_torch does not import torch), the JAX
package's names:

    sat_tpu_torch.SATConfig / config_from_args   typed config, train.py's flags
    sat_tpu_torch.Trainer                        training engine (DP / vocab-TP ranks)
    sat_tpu_torch.SATModel                       encoder zoo + decoder bundle
    sat_tpu_torch.beam_search / greedy_decode    batched decoding
    sat_tpu_torch.load_any_checkpoint (SAT-TPU or Lightning .ckpt) /
        load_model_from_checkpoint / save_checkpoint
    sat_tpu_torch.CaptionDataset / CaptionLoader
    sat_tpu_torch.preprocess_karpathy / make_synthetic_dataset /
        make_learnable_dataset
    sat_tpu_torch.score_captions                 corpus BLEU/GLEU/cossim/perplexity
    sat_tpu_torch.create_mesh                    mesh of torch.distributed ranks
                                                 for DP / vocab-TP
"""

from importlib import import_module

from .config import SATConfig, config_from_args
from .vocab import Vocab

__version__ = "0.1.0"

_LAZY = {
    "Trainer": ".train.loop",
    "SATModel": ".models.model",
    "beam_search": ".decode.beam",
    "greedy_decode": ".decode.beam",
    "load_model_from_checkpoint": ".train.checkpoints",
    "load_any_checkpoint": ".train.checkpoints",
    "save_checkpoint": ".train.checkpoints",
    "CaptionDataset": ".data.dataset",
    "CaptionLoader": ".data.dataset",
    "preprocess_karpathy": ".data.preprocess",
    "make_synthetic_dataset": ".data.preprocess",
    "make_learnable_dataset": ".data.preprocess",
    "score_captions": ".evalx.metrics",
    "create_mesh": ".parallel.mesh",
}

__all__ = ["SATConfig", "config_from_args", "Vocab", "__version__",
           *_LAZY.keys()]


def __getattr__(name):
    if name in _LAZY:
        return getattr(import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
