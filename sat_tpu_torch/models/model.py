"""The SAT model bundle of ``sat_tpu/models/model.py`` as an ``nn.Module``:
encoder + decoder weights + config + attention grid + vocabulary, as a
checkpoint carries them.  ``caption()`` is the user API: encode, then beam
search; greedy captioning is ``decode.beam.greedy_decode`` on ``encode``'s
output."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..config import SATConfig
from ..decode.api import caption_from_annotations
from ..vocab import Vocab
from .decoder import ParamTree
from .encoder import SATEncoder


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

    @torch.no_grad()
    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) in [0, 1] -> annotations (B, L, D), eval mode,
        on the model's device and in its dtype."""
        p = next(self.encoder.parameters())
        return self.encoder.eval()(images.to(device=p.device, dtype=p.dtype))

    def caption(self, images: torch.Tensor, beamk: int = 3,
                max_gen_length: int = 32,
                temperature: Union[float, Sequence[float]] = 1.0,
                sample_method: str = "beam", sample_topk: int = 3,
                decoder_noise: Optional[float] = None,
                rescore_method: Optional[str] = None,
                rescore_reward: float = 0.5, return_all: bool = False,
                generator: Optional[torch.Generator] = None,
                early_exit: bool = False, fused: Optional[bool] = None):
        """images (B, H, W, 3) in [0, 1] -> (captions, scores, alphas,
        perplexity) python lists, the reference's output contract; runs on
        the model's device (``fused`` as in ``decode.beam.beam_search``)."""
        return caption_from_annotations(
            self.decoder, self.cfg, self.encode(images), self.grid_hw,
            beamk=beamk, max_gen_length=max_gen_length, temperature=temperature,
            sample_method=sample_method, sample_topk=sample_topk,
            decoder_noise=decoder_noise, rescore_method=rescore_method,
            rescore_reward=rescore_reward, return_all=return_all,
            generator=generator, early_exit=early_exit, fused=fused)
