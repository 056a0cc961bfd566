"""The SAT model bundle of ``sat_tpu/models/model.py`` as an ``nn.Module``:
encoder + decoder weights + config + attention grid + vocabulary, as a
checkpoint carries them.  ``create`` builds a fresh one for training;
``caption()`` is the user API: encode, then beam search; greedy captioning
is ``decode.beam.greedy_decode`` on ``encode``'s output."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..config import SATConfig
from ..decode.api import caption_from_annotations
from ..decode.beam import decode_route
from ..parallel.mesh import ONE_RANK, Mesh
from ..vocab import Vocab
from .backbones import batch_stats_over, flax_init_
from .decoder import ParamTree, init_decoder_params, vocab_sliced
from .encoder import SATEncoder, encoder_from_config, probe_encoder


class SATModel(nn.Module):
    def __init__(self, cfg: SATConfig, grid_hw: Tuple[int, int],
                 encoder: SATEncoder, decoder: ParamTree):
        super().__init__()
        assert cfg.encoder_dim is not None and cfg.vocab_size is not None
        self.cfg = cfg
        self.grid_hw = tuple(grid_hw)
        self.vocab = Vocab(cfg.vocab_stoi)
        self.encoder = encoder
        self.decoder = decoder

    @classmethod
    def create(cls, cfg: SATConfig, generator: torch.Generator) -> "SATModel":
        """A fresh model on the generator's device, drawn from it: the
        encoder with flax's initialisers, the decoder with the reference's.
        ``cfg.encoder_dim`` becomes the encoder's output width, and
        ``cfg.pretrained_embedding`` (a ``.npy`` path of a (V, E) matrix)
        replaces the drawn embedding.  With ``cfg.pretrained`` and
        ``cfg.pretrained_weights`` (a saved torchvision ``state_dict``), the
        backbone takes those weights (``models/torch_import.py``), as in the
        JAX package, which reads the file only when both are set;
        ``pretrained`` without a file would download, which the port does
        not do."""
        if cfg.pretrained and not cfg.pretrained_weights:
            raise NotImplementedError(
                "pretrained=True without pretrained_weights downloads "
                "torchvision's weights, which the port does not do; pass a "
                "saved state_dict as pretrained_weights")
        dim, grid = probe_encoder(cfg)
        cfg = cfg.replace(encoder_dim=dim)
        encoder = flax_init_(encoder_from_config(cfg).to(generator.device),
                             generator)
        decoder = init_decoder_params(generator, cfg)
        if cfg.pretrained_embedding:
            emb = np.load(cfg.pretrained_embedding).astype(np.float32)
            if emb.shape != tuple(decoder.embedding.shape):
                raise ValueError(f"pretrained embedding shape {emb.shape} != "
                                 f"{tuple(decoder.embedding.shape)}")
            decoder.embedding.copy_(torch.from_numpy(emb))
        if cfg.pretrained:
            from .jax_import import encoder_to_jax, load_encoder_weights
            from .torch_import import import_pretrained
            params, stats = encoder_to_jax(encoder)
            tree = import_pretrained(cfg.encoder_arch, cfg.pretrained_weights,
                                     {"params": {"encoder": params},
                                      "state": {"batch_stats": stats}})
            load_encoder_weights(encoder, tree["params"]["encoder"],
                                 tree["state"]["batch_stats"])
        return cls(cfg, grid, encoder, decoder)

    def encode(self, images: torch.Tensor, train: bool = False,
               mesh: Mesh = ONE_RANK) -> torch.Tensor:
        """images (B, H, W, 3) in [0, 1] -> annotations (B, L, D), on the
        model's device and in its dtype.  Eval mode runs without autograd.
        ``train=True`` puts the encoder in train mode, whose BatchNorm
        normalises with the batch statistics and updates its running ones,
        and follows the caller's grad mode; on a ``mesh`` of ranks, the
        statistics of the global batch (``backbones.batch_stats_over``)."""
        p = next(self.encoder.parameters())
        images = images.to(device=p.device, dtype=p.dtype)
        if train:
            with batch_stats_over(self.encoder, mesh):
                return self.encoder.train()(images)
        with torch.no_grad():
            return self.encoder.eval()(images)

    def decode_route(self, decoder_noise: Optional[float] = None) -> str:
        """The beam route ``caption(fused=None)`` takes on the model's
        device (``decode.beam.decode_route``), which callers report."""
        gh, gw = self.grid_hw
        return decode_route(self.decoder.embedding.device, self.cfg, gh * gw,
                            noisy=decoder_noise is not None and decoder_noise != 0.0,
                            vocab_sharded=vocab_sliced(self.decoder, self.cfg))

    def caption(self, images: torch.Tensor, beamk: int = 3,
                max_gen_length: int = 32,
                temperature: Union[float, Sequence[float]] = 1.0,
                sample_method: str = "beam", sample_topk: int = 3,
                decoder_noise: Optional[float] = None,
                rescore_method: Optional[str] = None,
                rescore_reward: float = 0.5, return_all: bool = False,
                generator: Optional[torch.Generator] = None,
                early_exit: bool = False, fused: Optional[bool] = None,
                mesh: Mesh = ONE_RANK):
        """images (B, H, W, 3) in [0, 1] -> (captions, scores, alphas,
        perplexity) python lists, the reference's output contract; runs on
        the model's device (``fused`` and ``mesh`` as in
        ``decode.beam.beam_search``: on a mesh, this rank's rows)."""
        return caption_from_annotations(
            self.decoder, self.cfg, self.encode(images), self.grid_hw,
            beamk=beamk, max_gen_length=max_gen_length, temperature=temperature,
            sample_method=sample_method, sample_topk=sample_topk,
            decoder_noise=decoder_noise, rescore_method=rescore_method,
            rescore_reward=rescore_reward, return_all=return_all,
            generator=generator, early_exit=early_exit, fused=fused, mesh=mesh)
