"""The SAT attention-LSTM decoder, ported from ``sat_tpu/models/decoder.py``:
its init, its step functions and their dropout.

The weights live in a ``ParamTree``: an ``nn.Module`` whose children mirror
the JAX parameter dict (``att_dec.w``, ``lstm.layer_0.w_ih``, ...).  Linear
weights keep the JAX layout ``w (in, out)`` and are applied as ``x @ w``.
Annotations are ``(B, L, D)``; ``h``/``c`` are ``(layers, B, H)``.  Dropout
draws from a ``torch.Generator``; without one it is off, as JAX's is without
a key.

On a ``parallel.mesh.Mesh`` (the ``mesh`` arguments) the batch is this
rank's rows: dropout masks are drawn at the global shape and cut to them,
and where vocab TP gave the decoder a slice of the tables
(``vocab_sliced``), the lookup and the output projection gather over the
model axis."""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import SATConfig
from ..ops.lstm import init_lstm_params, lstm_stack_step
from ..parallel.mesh import ONE_RANK, Mesh


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: dict keys become attributes,
    leaves become parameters, so ``state_dict`` keys are the JAX paths joined
    by dots.  Leaves start frozen (decoding needs no gradient);
    ``requires_grad_()`` makes them trainable."""

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


def _linear_init(generator: torch.Generator, in_dim: int, out_dim: int,
                 bias: bool = True) -> Dict[str, torch.Tensor]:
    """torch Linear's init in the JAX layout: w (in, out) and b from
    U(-1/sqrt(in), 1/sqrt(in))."""
    k = 1.0 / math.sqrt(in_dim)
    dev = generator.device
    p = {"w": torch.empty(in_dim, out_dim, device=dev).uniform_(-k, k, generator=generator)}
    if bias:
        p["b"] = torch.empty(out_dim, device=dev).uniform_(-k, k, generator=generator)
    return p


def init_decoder_params(generator: torch.Generator, cfg: SATConfig
                        ) -> ParamTree:
    """A fresh decoder on the generator's device, with the JAX tree, shapes
    and distributions: embedding N(0, 1) with the <PAD> row zeroed, linears
    U(+-1/sqrt(fan_in)), the beta bias 1/H, the LSTM U(+-1/sqrt(H))."""
    assert cfg.vocab_size is not None and cfg.encoder_dim is not None
    V, E, D, A, H = (cfg.vocab_size, cfg.embed_dim, cfg.encoder_dim,
                     cfg.attention_dim, cfg.decoder_dim)
    dev = generator.device
    emb = torch.randn(V, E, device=dev, generator=generator)
    emb[0] = 0.0                           # padding_idx = <PAD> = 0
    lin = lambda *a, **k: _linear_init(generator, *a, **k)
    params = {"embedding": emb,
              "init_factorize": lin(D, E),
              "init_proj": lin(E, 2 * H * cfg.decoder_layers),
              "att_enc": lin(D, A, bias=False),
              "att_dec": lin(H, A, bias=False),
              "f_att": lin(A, 1, bias=False),
              "beta": lin(H, D)}
    params["beta"]["b"] = torch.full((D,), 1.0 / H, device=dev)
    params["lstm"] = init_lstm_params(generator, E + D, H, cfg.decoder_layers)
    params["out_hidden"] = lin(H, E, bias=False)
    if cfg.deep_output:
        params["out_context"] = lin(D, E, bias=False)
    if not (cfg.weight_tying and cfg.deep_output):
        # weight tying reuses the embedding table and drops the bias
        params["out_proj"] = lin(E, V, bias=not cfg.weight_tying)
    return ParamTree(params)


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
             mesh: Mesh = ONE_RANK) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate).  Off at rate 0 or without a generator.  On
    a mesh the mask is drawn for the global batch (x's rows times the mesh
    size) and cut to this rank's rows."""
    if rate <= 0.0 or generator is None:
        return x
    u = mesh.draw(lambda shape: torch.rand(shape, device=x.device, generator=generator),
                  x.shape)
    return torch.where(u < 1.0 - rate, x / (1.0 - rate), 0.0)


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


def vocab_sliced(params: ParamTree, cfg: SATConfig) -> bool:
    """Whether the decoder holds a vocab TP slice of its tables."""
    return params.embedding.shape[0] != cfg.vocab_size


def embed_tokens(params: ParamTree, ids: torch.Tensor, cfg: SATConfig,
                 mesh: Mesh = ONE_RANK) -> torch.Tensor:
    """Embedding lookup with the optional max-L2-norm cap.  ``F.embedding``,
    not ``embedding[ids]``: on the CPU the indexing's backward accumulates
    rows in a thread-dependent order, so training would not repeat bit for
    bit.  From a vocab slice the rows come from the model group
    (``Mesh.vocab_lookup``); the cap works row by row, after it."""
    vec = (mesh.vocab_lookup(params.embedding, ids) if vocab_sliced(params, cfg)
           else torch.nn.functional.embedding(ids, params.embedding))
    if cfg.embed_norm is not None:
        vec = _embed_cap(vec, cfg.embed_norm)
    return vec


def init_lstm_state(params: ParamTree, annotations: torch.Tensor,
                    cfg: SATConfig, batch_reshape: bool = False,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h, c (layers, B, H) from the mean annotation, with ``cfg.dropout`` on
    the mean where a generator is given.  ``batch_reshape=True`` is the
    reference's raw ``reshape(2*layers, B, H)`` of the (B, 2*layers*H)
    projection, which mixes rows for B > 1; False splits each row on its own
    (the decode layout)."""
    mean = _dropout(annotations.mean(dim=1), cfg.dropout, generator)
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
                hidden: torch.Tensor, context: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                mesh: Mesh = ONE_RANK) -> torch.Tensor:
    """Eq. 7 deep output -> (B, V) logits, with ``cfg.dropout`` before the
    projection where a generator is given.  With tied weights the projection
    is the embedding table with ``embed_norm`` applied to every row.  From a
    vocab slice the product runs on the model group's rows against the
    slice, and the slabs are gathered back (``Mesh.vocab_product``)."""
    if cfg.deep_output:
        x = torch.tanh(prev_embed + _linear(params.out_hidden, hidden)
                       + _linear(params.out_context, context))
    else:
        x = _linear(params.out_hidden, hidden)
    x = _dropout(x, cfg.dropout, generator, mesh)
    tied = cfg.weight_tying and cfg.deep_output
    return project_vocab(params, cfg, x, capped_embedding(params, cfg) if tied else None,
                         mesh)


def project_vocab(params: ParamTree, cfg: SATConfig, x: torch.Tensor,
                  embedding: Optional[torch.Tensor], mesh: Mesh = ONE_RANK,
                  float_bias: bool = False) -> torch.Tensor:
    """The vocab projection of rows x (n, E) -> (n, V): float32 logits
    against ``embedding`` (the table capped at ``embed_norm``) where the
    output is tied to it, else ``out_proj``, its bias added in x's type, or
    in float32 after a float32 product with ``float_bias`` (the kernels'
    route, JAX's ``fused_output_logits``).  From a vocab slice the product
    runs on the model group's rows against the slice, and the slabs are
    gathered back (``Mesh.vocab_product``)."""
    def project(t):
        if cfg.weight_tying and cfg.deep_output:
            return (t @ embedding.to(t.dtype).T).float()
        if not float_bias:
            return _linear(params.out_proj, t)
        out = (t @ params.out_proj.w.to(t.dtype)).float()
        return out + params.out_proj.b.float() if "b" in params.out_proj else out
    return mesh.vocab_product(x, project) if vocab_sliced(params, cfg) else project(x)


def decoder_step(params: ParamTree, cfg: SATConfig, prev_embed: torch.Tensor,
                 h: torch.Tensor, c: torch.Tensor, annotations: torch.Tensor,
                 att_enc: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 mesh: Mesh = ONE_RANK) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor, torch.Tensor]:
    """One decode step: attention -> beta gate -> LSTM -> deep output (its
    dropout drawn from ``generator``).  Returns (logits, h', c', zt, alpha)."""
    zt, alpha = soft_attention(params, att_enc, annotations, h[-1])
    beta = beta_gate(params, h[-1])
    x = torch.cat([prev_embed, beta * zt], dim=-1)
    h_new, c_new = lstm_stack_step(x, h, c, params.lstm)
    logits = deep_output(params, cfg, prev_embed, h_new[-1], zt, generator, mesh)
    return logits, h_new, c_new, zt, alpha
