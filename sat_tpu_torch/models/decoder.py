"""The SAT attention-LSTM decoder's inference functions, ported from
``sat_tpu/models/decoder.py``.

The weights live in a ``ParamTree``: an ``nn.Module`` whose children mirror
the JAX parameter dict (``att_dec.w``, ``lstm.layer_0.w_ih``, ...).  Linear
weights keep the JAX layout ``w (in, out)`` and are applied as ``x @ w``.
Annotations are ``(B, L, D)``; ``h``/``c`` are ``(layers, B, H)``.

Dropout comes with the trainer."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..config import SATConfig
from ..ops.lstm import lstm_stack_step


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: dict keys become attributes,
    leaves become frozen parameters, so ``state_dict`` keys are the JAX paths
    joined by dots."""

    def __init__(self, tree: Dict[str, object]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(torch.as_tensor(v).clone(),
                                    requires_grad=False))

    def __contains__(self, key: str) -> bool:
        return hasattr(self, key)


def _linear(p: ParamTree, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w.to(x.dtype)
    if "b" in p:
        y = y + p.b.to(x.dtype)
    return y


def _embed_cap(vec: torch.Tensor, embed_norm: float) -> torch.Tensor:
    norm = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    return vec * torch.clamp(embed_norm / torch.clamp(norm, min=1e-7), max=1.0)


def capped_embedding(params: ParamTree, cfg: SATConfig) -> torch.Tensor:
    """The embedding table with every row capped at L2 norm ``embed_norm``
    (the table itself when ``embed_norm`` is None).  Capping all rows once
    gives what ``embed_tokens`` gives row by row, and what the tied output
    projection of ``deep_output`` uses."""
    if cfg.embed_norm is None:
        return params.embedding
    return _embed_cap(params.embedding, cfg.embed_norm)


def embed_tokens(params: ParamTree, ids: torch.Tensor, cfg: SATConfig
                 ) -> torch.Tensor:
    """Embedding lookup with the optional max-L2-norm cap."""
    vec = params.embedding[ids]
    if cfg.embed_norm is not None:
        vec = _embed_cap(vec, cfg.embed_norm)
    return vec


def init_lstm_state(params: ParamTree, annotations: torch.Tensor,
                    cfg: SATConfig, batch_reshape: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h, c (layers, B, H) from the mean annotation.  ``batch_reshape=True``
    is the reference's raw ``reshape(2*layers, B, H)`` of the (B, 2*layers*H)
    projection, which mixes rows for B > 1; False splits each row on its own
    (the decode layout)."""
    mean = annotations.mean(dim=1)
    init = _linear(params.init_proj, _linear(params.init_factorize, mean))
    b, n = mean.shape[0], cfg.decoder_layers
    if batch_reshape:
        init = init.reshape(2 * n, b, cfg.decoder_dim)
    else:
        init = init.reshape(b, 2 * n, cfg.decoder_dim).transpose(0, 1)
    return init[:n], init[n:]


def init_lstm_state_beams(params: ParamTree, annotations: torch.Tensor,
                          cfg: SATConfig, beamk: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-expanded initial state, h, c (layers, B, k, H).

    The reference runs its state init on each image's annotations repeated
    ``beamk`` times and reshapes the (k, 2*layers*H) projection raw, so beam
    slot j of layer l takes ``g[((l*k + j)*H + h) mod 2*layers*H]`` of the
    image's projection g: slots alternate between its h and c halves."""
    mean = annotations.mean(dim=1)
    g = _linear(params.init_proj, _linear(params.init_factorize, mean))
    L2, H, k, n = 2 * cfg.decoder_layers, cfg.decoder_dim, beamk, cfg.decoder_layers
    ar = lambda m: torch.arange(m, device=g.device)
    idx = (ar(L2)[:, None, None] * (k * H) + ar(k)[None, :, None] * H
           + ar(H)[None, None, :]) % (L2 * H)
    init = g[:, idx].movedim(0, 1)                 # (2*layers, B, k, H)
    return init[:n], init[n:]


def attention_precompute(params: ParamTree, annotations: torch.Tensor
                         ) -> torch.Tensor:
    """W_e·a for all locations, once per image: (B, L, D) -> (B, L, A)."""
    return _linear(params.att_enc, annotations)


def soft_attention(params: ParamTree, att_enc: torch.Tensor,
                   annotations: torch.Tensor, hidden: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Additive attention with the 1/sqrt(L) logit scale -> (zt (B, D),
    alpha (B, L))."""
    L = annotations.shape[1]
    att_dec = _linear(params.att_dec, hidden)[:, None, :]
    att = _linear(params.f_att, torch.tanh(att_enc + att_dec))[..., 0]
    att = att * (L ** -0.5)
    alpha = torch.softmax(att.float(), dim=-1).to(att.dtype)
    zt = torch.einsum("bl,bld->bd", alpha, annotations)
    return zt, alpha


def beta_gate(params: ParamTree, hidden: torch.Tensor) -> torch.Tensor:
    """Gating scalar beta = sigmoid(W h + b)."""
    return torch.sigmoid(_linear(params.beta, hidden))


def deep_output(params: ParamTree, cfg: SATConfig, prev_embed: torch.Tensor,
                hidden: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
    """Eq. 7 deep output -> (B, V) logits.  With tied weights the projection
    is the embedding table with ``embed_norm`` applied to every row."""
    if cfg.deep_output:
        x = torch.tanh(prev_embed + _linear(params.out_hidden, hidden)
                       + _linear(params.out_context, context))
    else:
        x = _linear(params.out_hidden, hidden)
    if cfg.weight_tying and cfg.deep_output:
        w = capped_embedding(params, cfg).to(x.dtype)
        return (x @ w.T).float()
    return _linear(params.out_proj, x)


def decoder_step(params: ParamTree, cfg: SATConfig, prev_embed: torch.Tensor,
                 h: torch.Tensor, c: torch.Tensor, annotations: torch.Tensor,
                 att_enc: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor, torch.Tensor]:
    """One decode step: attention -> beta gate -> LSTM -> deep output.
    Returns (logits, h', c', zt, alpha)."""
    zt, alpha = soft_attention(params, att_enc, annotations, h[-1])
    beta = beta_gate(params, h[-1])
    x = torch.cat([prev_embed, beta * zt], dim=-1)
    h_new, c_new = lstm_stack_step(x, h, c, params.lstm)
    logits = deep_output(params, cfg, prev_embed, h_new[-1], zt)
    return logits, h_new, c_new, zt, alpha
