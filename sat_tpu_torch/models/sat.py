"""Teacher-forced SAT forward pass and loss, ported from
``sat_tpu/models/sat.py``.

The decoder runs T - 1 steps over a caption batch in a Python loop, and
autograd keeps what the backward needs (the JAX scan recomputes it under
``jax.checkpoint`` instead).  As in JAX:

* every row computes every step; a row is active at step t while
  ``lengths > t``, and only active positions count in the loss;
* scheduled sampling draws ONE coin per step for the whole batch
  (``uniform <= epsilon``), and steps 0-2 always feed the ground truth;
* embedding dropout and output dropout are separate draws;
* the initial state is the reference's raw ``reshape(2 * layers, N, H)`` of
  the (N, 2 * layers * H) projection, which mixes rows.

Random draws come from one ``torch.Generator``, in a fixed order: the init
dropout, the coins, then per step the embedding and the output dropout.
Without a generator the draws come from seed 0 and dropout is off, as JAX
runs without a key.

On a mesh of ranks (``parallel/mesh.py``) the grouped loss takes this
rank's rows and returns this rank's share of the global loss: the CE over
the global count of target tokens, the attention term over the global
``B * R * L``; the initial state's reshape runs on the gathered projection,
so a rank's rows take their state from other ranks' images as one process's
rows do; dropout draws the global batch's masks."""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from ..config import SATConfig
from ..ops.label_smoothing import label_smoothing_loss, masked_token_accuracy
from ..ops.lstm import lstm_stack_step
from ..parallel.mesh import ONE_RANK, Mesh
from .decoder import (ParamTree, _dropout, _linear, attention_precompute,
                      beta_gate, decoder_step, deep_output, embed_tokens,
                      init_lstm_state)

Epsilon = Union[float, torch.Tensor]


def repeat_annotations(annotations: torch.Tensor, n_refs: int) -> torch.Tensor:
    """Each image's annotations once per reference caption (batch dim)."""
    return annotations.repeat_interleave(n_refs, dim=0)


def flatten_caption_batch(encoded_captions: torch.Tensor,
                          lengths: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(B, R, T), (B, R) -> (B*R, T), (B*R,), R."""
    b, r, t = encoded_captions.shape
    return encoded_captions.reshape(b * r, t), lengths.reshape(b * r), r


def _draws(generator: Optional[torch.Generator], device: torch.device
           ) -> Tuple[torch.Generator, Optional[torch.Generator]]:
    """(generator of the coins, generator of the dropout masks or None)."""
    if generator is None:
        return torch.Generator(device).manual_seed(0), None
    return generator, generator


def _coins(num_steps: int, epsilon: Epsilon, generator: torch.Generator,
           device: torch.device) -> torch.Tensor:
    return torch.rand(num_steps, device=device, generator=generator) <= epsilon


def train_forward(params: ParamTree, cfg: SATConfig,
                  annotations: torch.Tensor, encoded_captions: torch.Tensor,
                  lengths: torch.Tensor, epsilon: Epsilon,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Teacher-forced decode of a flat caption batch.

    annotations (N, L, D), already repeated to match the captions;
    encoded_captions (N, T); lengths (N,) targets per caption; epsilon the
    probability of feeding the ground truth.  Returns (logits (N, T-1, V)
    float32, targets (N, T-1), alphas (N, T-1, L), zero on inactive steps)."""
    dev = annotations.device
    caps = encoded_captions.long()
    num_steps = caps.shape[1] - 1
    gen, drop = _draws(generator, dev)
    h, c = init_lstm_state(params, annotations, cfg, batch_reshape=True,
                           generator=drop)
    att_enc = attention_precompute(params, annotations)
    coins = _coins(num_steps, epsilon, gen, dev)
    pred = torch.zeros(caps.shape[0], dtype=torch.long, device=dev)
    logits_all, alphas = [], []
    for t in range(num_steps):
        words = caps[:, t] if t <= 2 else torch.where(coins[t], caps[:, t], pred)
        prev_embed = _dropout(embed_tokens(params, words, cfg),
                              cfg.embedding_dropout, drop)
        logits, h, c, _, alpha = decoder_step(params, cfg, prev_embed, h, c,
                                              annotations, att_enc, drop)
        logits = logits.float()
        pred = logits.argmax(dim=-1)
        logits_all.append(logits)
        alphas.append(torch.where((lengths > t)[:, None], alpha, 0.0))
    return torch.stack(logits_all, 1), caps[:, 1:], torch.stack(alphas, 1)


def sat_loss(cfg: SATConfig, logits: torch.Tensor, targets: torch.Tensor,
             lengths: torch.Tensor, alphas: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
    """Label-smoothed CE + the doubly-stochastic attention loss (the mean
    over rows and locations of (1 - sum_t alpha)^2) + token accuracy."""
    steps = torch.arange(logits.shape[1], device=logits.device)
    mask = lengths[:, None] > steps[None, :]
    ce = label_smoothing_loss(logits, targets, mask, cfg.label_smoothing)
    att = ((1.0 - alphas.sum(dim=1)) ** 2).mean()
    return {"loss": ce + cfg.att_gamma * att, "ce_loss": ce, "att_loss": att,
            "accuracy": masked_token_accuracy(logits, targets, mask)}


def train_forward_loss_grouped(params: ParamTree, cfg: SATConfig,
                               annotations: torch.Tensor,
                               encoded_captions: torch.Tensor,
                               lengths: torch.Tensor, epsilon: Epsilon,
                               generator: Optional[torch.Generator] = None,
                               mesh: Mesh = ONE_RANK) -> Dict[str, torch.Tensor]:
    """The loss of ``train_forward`` + ``sat_loss`` with the reference
    captions kept grouped: annotations (B, L, D), not repeated;
    encoded_captions (B, R, T); lengths (B, R).  Each step's attention reads
    an image's annotations once for its R captions, and the loss terms are
    summed step by step, so no (N, T, V) logits are kept.

    Returns {"loss", "ce_loss", "att_loss", "accuracy"} as 0-d tensors; on
    a mesh of more than one rank, this rank's shares of them (the sum over
    the ranks is the global batch's value; the gradients of the shares sum
    to the global gradient)."""
    dev = annotations.device
    caps = encoded_captions.long()
    b, r, total_t = caps.shape
    n, num_steps = b * r, total_t - 1
    L, H, layers = annotations.shape[1], cfg.decoder_dim, cfg.decoder_layers
    confidence = 1.0 - cfg.label_smoothing
    gen, drop = _draws(generator, dev)

    # the reference's init over the N = B*R repeated rows: repeat the (B, D)
    # mean, then reshape the (N, 2*layers*H) projection as a whole
    mean = _dropout(annotations.mean(dim=1).repeat_interleave(r, dim=0),
                    cfg.dropout, drop, mesh)
    g = _linear(params.init_proj, _linear(params.init_factorize, mean))
    # on a mesh the global reshape, then this rank's rows
    init = mesh.gather(g).reshape(2 * layers, n * mesh.size, H)
    init = init[:, mesh.rank * n:(mesh.rank + 1) * n]
    h, c = init[:layers], init[layers:]
    att_enc = attention_precompute(params, annotations)           # (B, L, A)
    coins = _coins(num_steps, epsilon, gen, dev)

    pred = torch.zeros(b, r, dtype=torch.long, device=dev)
    ce_sum = correct = n_active = 0.0
    alpha_total = torch.zeros(b, r, L, device=dev)
    for t in range(num_steps):
        gt = caps[:, :, t]
        words = gt if t <= 2 else torch.where(coins[t], gt, pred)
        prev_embed = _dropout(embed_tokens(params, words, cfg, mesh),
                              cfg.embedding_dropout, drop, mesh)  # (B, R, E)
        # grouped soft attention: decoder.soft_attention with the annotations
        # broadcast over the R captions of each image
        att_dec = _linear(params.att_dec, h[-1].reshape(b, r, H))  # (B, R, A)
        att = _linear(params.f_att, torch.tanh(att_enc[:, None]
                                               + att_dec[:, :, None]))
        att = att[..., 0] * (L ** -0.5)                           # (B, R, L)
        alpha = torch.softmax(att.float(), dim=-1).to(att.dtype)
        zt = torch.einsum("brl,bld->brd", alpha, annotations).reshape(n, -1)
        x = torch.cat([prev_embed.reshape(n, -1),
                       beta_gate(params, h[-1]) * zt], dim=-1)
        h, c = lstm_stack_step(x, h, c, params.lstm)
        logits = deep_output(params, cfg, prev_embed.reshape(n, -1), h[-1],
                             zt, drop, mesh).float()              # (N, V)

        active = (lengths > t).float()                            # (B, R)
        tgt = caps[:, :, t + 1]
        logprobs = torch.log_softmax(logits, dim=-1)
        nll = -logprobs.gather(1, tgt.reshape(n, 1))[:, 0]
        smooth = -logprobs.mean(dim=-1)
        per_pos = (confidence * nll + cfg.label_smoothing * smooth).reshape(b, r)
        pred = logits.argmax(dim=-1).reshape(b, r)
        ce_sum = ce_sum + (per_pos * active).sum()
        correct = correct + ((pred == tgt).float() * active).sum()
        n_active = n_active + active.sum()
        alpha_total = alpha_total + alpha.float() * active[:, :, None]

    n_valid = torch.clamp(mesh.sum(n_active), min=1.0)
    att = ((1.0 - alpha_total) ** 2).mean() / mesh.size   # over the global B*R*L
    ce = ce_sum / n_valid
    return {"loss": ce + cfg.att_gamma * att, "ce_loss": ce, "att_loss": att,
            "accuracy": correct / n_valid}


def train_forward_loss(params: ParamTree, cfg: SATConfig,
                       annotations: torch.Tensor,
                       encoded_captions: torch.Tensor, lengths: torch.Tensor,
                       epsilon: Epsilon,
                       generator: Optional[torch.Generator] = None
                       ) -> Dict[str, torch.Tensor]:
    """``train_forward_loss_grouped`` on a flat batch: annotations (N, L, D)
    already repeated, encoded_captions (N, T), lengths (N,); each row is its
    own group of one caption."""
    return train_forward_loss_grouped(params, cfg, annotations,
                                      encoded_captions[:, None],
                                      lengths[:, None], epsilon, generator)
