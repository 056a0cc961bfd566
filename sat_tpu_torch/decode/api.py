"""Host-side caption API, ported from ``sat_tpu/decode/api.py``.

``caption_from_annotations`` runs ``beam_search`` and ``unpack_beam_result``
turns its BeamResult into the reference's python-list contract: captions
(token-id lists without <START>/<END>), scores, alphas (2-D attention maps
per word) and perplexity."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import SATConfig
from ..parallel.mesh import ONE_RANK, Mesh
from .beam import BeamResult, beam_search


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def caption_from_annotations(
        params, cfg: SATConfig, annotations: torch.Tensor,
        grid_hw: Tuple[int, int], beamk: int = 3, max_gen_length: int = 32,
        temperature: Union[float, Sequence[float]] = 1.0,
        sample_method: str = "beam", sample_topk: int = 3,
        decoder_noise: Optional[float] = None,
        rescore_method: Optional[str] = None, rescore_reward: float = 0.5,
        return_all: bool = False,
        generator: Optional[torch.Generator] = None,
        early_exit: bool = False, fused: Optional[bool] = None,
        mesh: Mesh = ONE_RANK):
    """Decode annotations (B, L, D) -> (captions, scores, alphas,
    perplexity); ``return_all`` gives every hypothesis per image, best
    first.  ``fused`` and ``mesh`` as in ``beam_search``."""
    res = beam_search(
        params, cfg, annotations, beamk=beamk, max_gen_length=max_gen_length,
        temperature=temperature, sample_method=sample_method,
        sample_topk=sample_topk, decoder_noise=decoder_noise,
        rescore_method=rescore_method, rescore_reward=rescore_reward,
        generator=generator, fused=fused, early_exit=early_exit, mesh=mesh)
    return unpack_beam_result(res, grid_hw, return_all)


def unpack_beam_result(res: BeamResult, grid_hw: Tuple[int, int],
                       return_all: bool = False):
    """Convert a BeamResult to (captions, scores, alphas, perplexity) lists."""
    gh, gw = grid_hw
    tokens = _np(res.tokens)
    lengths = _np(res.lengths)
    scores = _np(res.scores)
    ppl = _np(res.perplexity)
    alphas = _np(res.alphas)
    b, k = lengths.shape

    captions, cap_scores, cap_alphas, cap_ppl = [], [], [], []
    for i in range(b):
        caps_i, al_i = [], []
        for j in range(k):
            n = int(lengths[i, j])
            caps_i.append(tokens[i, j, 1:n + 1].tolist())
            # alphas rows 0..n-1 belong to words 1..n (the END-step alpha and
            # the zero placeholders are dropped)
            al_i.append(alphas[i, j, :n].reshape(n, gh, gw))
        if return_all:
            order = np.argsort(-scores[i], kind="stable")
            captions.append([caps_i[j] for j in order])
            cap_alphas.append([al_i[j] for j in order])
            cap_scores.append([float(scores[i, j]) for j in order])
            cap_ppl.append([float(ppl[i, j]) for j in order])
        else:
            best = int(np.argmax(scores[i]))
            captions.append(caps_i[best])
            cap_alphas.append(al_i[best])
            cap_scores.append(float(scores[i, best]))
            cap_ppl.append(float(ppl[i, best]))
    return captions, cap_scores, cap_alphas, cap_ppl
