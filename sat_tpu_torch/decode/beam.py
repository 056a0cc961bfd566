"""Greedy decoding, ported from ``sat_tpu/decode/beam.py``.

``BeamResult`` keeps the JAX field shapes, with beam width 1 for greedy.
Beam search (``beam_search``) comes with the next slice."""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from ..config import SATConfig
from ..kernels.decoder_step import (fused_decoder_step, fused_output_logits,
                                    fused_step_supported, step_weights)
from ..kernels.greedy_loop import NEG_INF  # noqa: F401  (JAX's public name)
from ..kernels.greedy_loop import (greedy_loop_decode, greedy_loop_supported,
                                   greedy_scan)
from ..models.decoder import (attention_precompute, capped_embedding,
                              decoder_step, embed_tokens, init_lstm_state)


class BeamResult(NamedTuple):
    """Decode result with (B, k) leading dims."""
    tokens: torch.Tensor      # (B, k, S+2) int32, row = <START> w... <END>/pads
    lengths: torch.Tensor     # (B, k) int32, caption word count == finish step
    raw_scores: torch.Tensor  # (B, k) cumulative logprob at finish
    scores: torch.Tensor      # (B, k) rescored scores (selection key)
    perplexity: torch.Tensor  # (B, k) exp(-s/len)
    alphas: torch.Tensor      # (B, k, S+1, L) attention maps per generated word


RESCORE_METHODS = ("LN", "WR", "BAR")


def normalize_rescore_method(method: Optional[str]) -> Optional[str]:
    """None / 'none' / 'None' / '' -> None; case-normalises and validates."""
    if method is None or method in ("None", "none", ""):
        return None
    m = method.upper()
    if m not in RESCORE_METHODS:
        raise ValueError(f"unknown rescore_method {method!r}; expected one "
                         f"of {RESCORE_METHODS} (or 'none')")
    return m


def _rescore_single(scores: torch.Tensor, lf: torch.Tensor,
                    rescore_method: Optional[str],
                    rescore_reward: float) -> torch.Tensor:
    """Single-beam rescoring with beam_search's semantics; for a lone beam the
    BAR live mean over slots collapses to -score."""
    rescore_method = normalize_rescore_method(rescore_method)
    if rescore_method == "LN":
        return scores / lf
    if rescore_method == "WR":
        return scores + rescore_reward * lf
    if rescore_method == "BAR":
        return scores + rescore_reward * (-scores)
    return scores


def _result(tokens, alphas, scores, flen, finished, S, rescore_method,
            rescore_reward) -> BeamResult:
    flen = torch.where(finished, flen, S).to(torch.int32)
    lf = torch.clamp(flen.float(), min=1.0)
    rescored = _rescore_single(scores, lf, rescore_method, rescore_reward)
    return BeamResult(tokens=tokens[:, None], lengths=flen[:, None],
                      raw_scores=scores[:, None], scores=rescored[:, None],
                      perplexity=torch.exp(-scores / lf)[:, None],
                      alphas=alphas[:, None])


def select_fused(fused: Union[None, bool, str], device: torch.device,
                 cfg: SATConfig, L: int, itemsize: int) -> Union[bool, str]:
    """The implementation ``fused`` names for annotations on ``device``:
    ``None`` means the loop kernel on a CUDA device where its gate allows, else
    the step kernel, and the plain path elsewhere.  Raises where the chosen
    kernel's gate fails (both need one LSTM layer): a deeper stack on the card
    runs the plain path only when the caller asks for it, ``fused=False``."""
    if fused is None:
        if device.type != "cuda":
            return False
        fused = "loop" if greedy_loop_supported(cfg, L, itemsize) else True
    if fused == "loop":
        if not greedy_loop_supported(cfg, L, itemsize):
            raise ValueError("greedy loop kernel: decoder_layers must be 1 and "
                             "one row's state must fit shared memory")
    elif fused and not fused_step_supported(cfg, L):
        raise ValueError("fused step kernels: decoder_layers must be 1 and "
                         "L attention scores must fit shared memory")
    return fused


@torch.no_grad()
def greedy_decode(params, cfg: SATConfig, annotations: torch.Tensor, *,
                  max_gen_length: int = 32, temperature: float = 1.0,
                  fused: Union[None, bool, str] = None,
                  early_exit: bool = False,
                  rescore_method: Optional[str] = None,
                  rescore_reward: float = 0.5) -> BeamResult:
    """Greedy captioning: beam width 1 with a plain per-step argmax.

    ``fused`` chooses the implementation, as in JAX: ``False`` is the plain
    per-step PyTorch path, ``True`` the step kernels
    (``kernels/decoder_step.py``) plus a matmul for the vocab projection, and
    ``"loop"`` the whole-loop phase kernels (``kernels/greedy_loop.py``).  The one
    difference from the JAX signature is the default, ``fused=None``: on a
    CUDA tensor it means the loop kernel where its gate allows, else the step
    kernel, which raises where its gate fails too (both need one LSTM layer:
    a deeper stack on the card needs ``fused=False``); on a CPU tensor it
    means the plain path.  A kernel path on CPU tensors runs that kernel's
    plain PyTorch version.

    ``early_exit=True`` stops once every caption has emitted <END>; the
    outputs equal the fixed-length run (finished rows only append PAD and
    zero alphas).  On the card that costs one host sync per step; the loop
    kernels ignore it: they stop on the device, once their count of finished
    rows reaches the batch.

    annotations (B, L, D) -> BeamResult with k = 1."""
    annotations = annotations.contiguous()
    L, S = annotations.shape[1], max_gen_length
    fused = select_fused(fused, annotations.device, cfg, L,
                         annotations.element_size())
    att_enc = attention_precompute(params, annotations)
    h, c = init_lstm_state(params, annotations, cfg)

    if fused == "loop":
        out = greedy_loop_decode(params, cfg, annotations, att_enc,
                                 h[0].contiguous(), c[0].contiguous(),
                                 max_gen_length=S, temperature=temperature)
        return _result(*out, S, rescore_method, rescore_reward)

    if fused:
        lw = step_weights(params, cfg, annotations.dtype)   # once per decode
        emb = capped_embedding(params, cfg)

        def step(prev_embed, h, c):
            t, h1, c1, _, alpha = fused_decoder_step(
                lw, cfg, prev_embed.contiguous(), h[0].contiguous(),
                c[0].contiguous(), annotations, att_enc)
            return fused_output_logits(params, cfg, t, emb), h1[None], c1[None], alpha
    else:
        def step(prev_embed, h, c):
            logits, h1, c1, _, alpha = decoder_step(
                params, cfg, prev_embed, h, c, annotations, att_enc)
            return logits, h1, c1, alpha

    out = greedy_scan(step, lambda tok: embed_tokens(params, tok, cfg), cfg,
                      h, c, L, max_gen_length=S, temperature=temperature,
                      early_exit=early_exit)
    return _result(*out, S, rescore_method, rescore_reward)
