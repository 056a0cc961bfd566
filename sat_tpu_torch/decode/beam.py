"""Beam search and greedy decoding, ported from ``sat_tpu/decode/beam.py``.

``beam_search`` decodes the whole batch with static ``(B, k)`` shapes, as
JAX's scan does: a finished slot keeps its place and offers one "stay"
candidate with a sentinel score, so the flat top-k re-selects it and fills
the other slots with the best live continuations; at step 0 the k words
come from slot 0 alone and each slot keeps its own state; the histories are
rebuilt after the loop from append-only records by one backwards walk over
the backpointers; rescoring (LN, WR, BAR) and perplexity come last.
Sampling (``multinomial``, ``topk``) is Gumbel-top-k over the same
log-weights.  ``greedy_decode`` is beam width 1 with a plain argmax.
``BeamResult`` keeps the JAX field shapes.

On a mesh of ranks (``parallel/mesh.py``; the ``mesh`` arguments) each
rank decodes its rows of the global batch: the noise is drawn at the
global shape and cut to them, ``early_exit`` stops when every rank's rows
have finished, and a decoder that holds a vocab TP slice embeds and
projects over the model axis (the greedy loop kernel, whose selection
holds the whole vocabulary per row, is not taken there)."""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..config import SATConfig
from ..kernels.decoder_step import (fused_decoder_step, fused_output_logits,
                                    fused_step_supported, step_weights)
from ..kernels.greedy_loop import NEG_INF  # noqa: F401  (JAX's public name)
from ..kernels.greedy_loop import _special, greedy_loop_decode, greedy_scan
from ..models.decoder import (_linear, attention_precompute, beta_gate,
                              capped_embedding, decoder_step, deep_output,
                              embed_tokens, init_lstm_state,
                              init_lstm_state_beams, vocab_sliced)
from ..ops.lstm import lstm_stack_step
from ..parallel.mesh import ONE_RANK, Mesh

STAY_SCORE = 1e9   # a finished slot's one candidate: always wins the top-k


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


def _gather_beams(x: torch.Tensor, parent: torch.Tensor, axis: int
                  ) -> torch.Tensor:
    """Beam slots of x by parent index: parent (B, k) int64, x with the
    batch at ``axis - 1`` and the k slots at ``axis``."""
    shape = [1] * x.ndim
    shape[axis - 1], shape[axis] = parent.shape
    return torch.gather(x, axis, parent.reshape(shape).expand(x.shape))


def topk_small(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis in JAX ``topk_small``'s order: descending
    values, ties to the lower index.  For k <= 8, k passes of (max, argmax):
    ``torch.argmax`` returns the first maximal index, where ``torch.topk``
    promises no tie order; -0.0 ties with 0.0, as in JAX's passes.  Above,
    ``lax.top_k``'s order: a stable descending sort with 0.0 before -0.0."""
    if k > 8:
        order = torch.sort(torch.signbit(x).to(torch.uint8), dim=-1,
                           stable=True).indices
        vals, idx = torch.sort(x.gather(-1, order), dim=-1, descending=True,
                               stable=True)
        return vals[..., :k], order.gather(-1, idx)[..., :k]
    vals, idxs, cur = [], [], x
    for _ in range(k):
        i = torch.argmax(cur, dim=-1, keepdim=True)
        vals.append(cur.gather(-1, i))
        idxs.append(i)
        cur = cur.scatter(-1, i, float("-inf"))
    return torch.cat(vals, -1), torch.cat(idxs, -1)


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel samples, float32: every draw of the sampling modes."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))


def normal_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard normal samples, float32: every draw of ``decoder_noise``."""
    return torch.randn(shape, generator=generator, device=device)


def _noise(fn, shape, generator: torch.Generator, device, mesh: Mesh,
           axis: int = 0) -> torch.Tensor:
    """``fn(shape, generator, device)``; on a mesh drawn for the global
    batch (on ``axis``) and cut to this rank's rows."""
    return mesh.draw(lambda full: fn(full, generator, device), shape, axis)


def _all_finished(finished: torch.Tensor, mesh: Mesh) -> bool:
    """Every row finished, on every rank of the mesh (one host sync)."""
    return mesh.all_true(bool(finished.all()))


def _rescore(scores: torch.Tensor, lf: torch.Tensor, bar: torch.Tensor,
             rescore_method: Optional[str], rescore_reward: float
             ) -> torch.Tensor:
    """The selection key: LN divides by the length, WR adds the reward per
    word, BAR adds the reward times the BAR term ``bar``."""
    rescore_method = normalize_rescore_method(rescore_method)
    if rescore_method == "LN":
        return scores / lf
    if rescore_method == "WR":
        return scores + rescore_reward * lf
    if rescore_method == "BAR":
        return scores + rescore_reward * bar
    return scores


def _result(tokens, alphas, scores, flen, finished, S, rescore_method,
            rescore_reward) -> BeamResult:
    """Greedy outputs as a k = 1 BeamResult; for a lone beam the BAR live
    mean over slots is -score."""
    flen = torch.where(finished, flen, S).to(torch.int32)
    lf = torch.clamp(flen.float(), min=1.0)
    rescored = _rescore(scores, lf, -scores, rescore_method, rescore_reward)
    return BeamResult(tokens=tokens[:, None], lengths=flen[:, None],
                      raw_scores=scores[:, None], scores=rescored[:, None],
                      perplexity=torch.exp(-scores / lf)[:, None],
                      alphas=alphas[:, None])


LOOP_ROUTE, STEP_ROUTE = "loop kernel", "step kernels"


def decode_route(device: torch.device, cfg: SATConfig, L: int, *,
                 noisy: bool = False, greedy: bool = False,
                 vocab_sharded: bool = False) -> str:
    """The implementation ``fused=None`` takes, named with its reason.

    On a CUDA device this is JAX's rule (``use_fused = fused and
    decoder_layers == 1 and not noisy``, ``sat_tpu/decode/beam.py``) with
    the kernels' one gate, ``fused_step_supported`` (attend's L scores fit
    a block): greedy decoding takes the loop kernel, beam search the step
    kernels where the call draws no hidden-state noise.  A decoder holding
    a vocab TP slice (``vocab_sharded``) takes the step kernels for greedy
    decoding too: the loop kernels combine the partials of every vocabulary
    tile on one rank, so a vocab slice cannot take them.  Everything else
    is the plain path, named ``"plain (<reason>)"``.  The rule reads only
    the config and the call's arguments: a kernel that fails to build or
    launch fails the run, it never turns into the plain path."""
    if device.type != "cuda":
        return "plain (not a CUDA device)"
    if cfg.decoder_layers != 1:
        return f"plain (decoder_layers {cfg.decoder_layers})"
    if noisy:
        return "plain (decoder_noise)"
    if not fused_step_supported(cfg, L):
        return f"plain (L {L} scores exceed the kernels' shared memory)"
    return LOOP_ROUTE if greedy and not vocab_sharded else STEP_ROUTE


def select_fused(fused: Union[None, bool, str], device: torch.device,
                 cfg: SATConfig, L: int,
                 vocab_sharded: bool = False) -> Union[bool, str]:
    """The implementation ``fused`` names for annotations on ``device``:
    ``None`` is ``decode_route``'s greedy route.  An explicit kernel path
    raises where the kernels' gate fails (one LSTM layer, attend's L scores
    in a block), and the loop kernel where the decoder holds a vocab
    slice."""
    if fused is None:
        route = decode_route(device, cfg, L, greedy=True,
                             vocab_sharded=vocab_sharded)
        return "loop" if route == LOOP_ROUTE else route == STEP_ROUTE
    if fused == "loop" and vocab_sharded:
        raise ValueError("greedy loop kernel: the decoder holds a vocab slice; "
                         "the kernels combine every vocabulary tile on one rank")
    if fused and not fused_step_supported(cfg, L):
        name = "greedy loop kernel" if fused == "loop" else "fused step kernels"
        raise ValueError(f"{name}: decoder_layers must be 1 and L attention "
                         "scores must fit shared memory")
    return fused


@torch.no_grad()
def greedy_decode(params, cfg: SATConfig, annotations: torch.Tensor, *,
                  max_gen_length: int = 32, temperature: float = 1.0,
                  fused: Union[None, bool, str] = None,
                  early_exit: bool = False,
                  rescore_method: Optional[str] = None,
                  rescore_reward: float = 0.5, mesh: Mesh = ONE_RANK) -> BeamResult:
    """Greedy captioning: beam width 1 with a plain per-step argmax.

    ``fused`` chooses the implementation, as in JAX: ``False`` is the plain
    per-step PyTorch path, ``True`` the step kernels
    (``kernels/decoder_step.py``) plus a matmul for the vocab projection, and
    ``"loop"`` the whole-loop phase kernels (``kernels/greedy_loop.py``).  The one
    difference from the JAX signature is the default, ``fused=None``:
    ``decode_route``'s greedy route, which on a CUDA tensor is the loop
    kernel where its gate allows, else the step kernel where its gate
    allows, else (a deeper LSTM stack) the plain path; on a CPU tensor it
    is the plain path.  An explicit kernel path raises where its gate
    fails.  A kernel path on CPU tensors runs that kernel's plain PyTorch
    version.

    ``early_exit=True`` stops once every caption has emitted <END>; the
    outputs equal the fixed-length run (finished rows only append PAD and
    zero alphas).  On the card that costs one host sync per step; the loop
    kernels ignore it: they stop on the device, once their count of finished
    rows reaches the batch.

    annotations (B, L, D) -> BeamResult with k = 1; on a ``mesh``, this
    rank's rows (module docstring)."""
    annotations = annotations.contiguous()
    L, S = annotations.shape[1], max_gen_length
    fused = select_fused(fused, annotations.device, cfg, L,
                         vocab_sliced(params, cfg))
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
            return (fused_output_logits(params, cfg, t, emb, mesh),
                    h1[None], c1[None], alpha)
    else:
        def step(prev_embed, h, c):
            logits, h1, c1, _, alpha = decoder_step(
                params, cfg, prev_embed, h, c, annotations, att_enc, mesh=mesh)
            return logits, h1, c1, alpha

    out = greedy_scan(step, lambda tok: embed_tokens(params, tok, cfg, mesh), cfg,
                      h, c, L, max_gen_length=S, temperature=temperature,
                      early_exit=early_exit,
                      all_finished=lambda f: _all_finished(f, mesh))
    return _result(*out, S, rescore_method, rescore_reward)


def select_beam_fused(fused: Optional[bool], device: torch.device,
                      cfg: SATConfig, L: int, noisy: bool) -> bool:
    """Whether beam search runs the step kernels: ``None`` is
    ``decode_route``'s beam route.  An explicit ``True`` raises where the
    kernels cannot run what was asked (``select_fused``'s gate,
    hidden-state noise)."""
    if fused == "loop":
        raise ValueError("beam search has no loop kernel: fused is None, "
                         "True or False")
    if fused is None:
        return decode_route(device, cfg, L, noisy=noisy) == STEP_ROUTE
    if fused and noisy:
        raise ValueError("fused step kernels: decoder_noise needs fused=False "
                         "(the kernels compute attention and the LSTM from "
                         "one hidden state)")
    return bool(select_fused(bool(fused), device, cfg, L))


def _live_mean(scores: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """BAR's term: minus the mean score over each image's live slots."""
    return -(torch.where(live, scores, 0.0).sum(1)
             / torch.clamp(live.sum(1), min=1))


@torch.no_grad()
def beam_search(params, cfg: SATConfig, annotations: torch.Tensor, *,
                beamk: int = 3, max_gen_length: int = 32,
                temperature: Union[float, Sequence[float]] = 1.0,
                sample_method: str = "beam", sample_topk: int = 3,
                decoder_noise: Optional[float] = None,
                rescore_method: Optional[str] = None,
                rescore_reward: float = 0.5,
                generator: Optional[torch.Generator] = None,
                fused: Optional[bool] = None,
                early_exit: bool = False, mesh: Mesh = ONE_RANK) -> BeamResult:
    """Batched beam or sampled search.  annotations (B, L, D) -> BeamResult
    with (B, k) leading dims.

    ``temperature`` may be a list, cycled per step.  ``generator`` draws the
    Gumbel noise of the sampling modes and the hidden-state noise of
    ``decoder_noise`` (``h + N(0, 1) noise / (t + 1)`` on the LSTM's input
    state only); ``None`` means a generator seeded with 0.

    ``fused`` chooses the implementation: ``False`` the plain path, whose
    attention reads the (B, L, .) annotations once per image for its k
    slots; ``True`` the step kernels (``kernels/decoder_step.py``) at B k
    rows, which read the same (B, L, .) tensors once per image for its k
    slots too, plus a matmul for the vocabulary.
    ``None`` is ``decode_route``'s beam route: the step kernels on a CUDA
    tensor, except for a deeper LSTM stack or ``decoder_noise`` (the kernels
    compute attention and the LSTM from one hidden state and need one LSTM
    layer), which take the plain path, as JAX's rule does; the plain path on
    a CPU tensor, where ``fused=True`` runs the kernels' plain version.
    ``fused=True`` raises with ``decoder_noise`` or a deeper stack.

    ``early_exit=True`` stops once every slot of every image has finished,
    at one host sync per step on the card; the tokens, scores, lengths and
    the alphas of rows below each length equal the fixed-length run's.
    On a ``mesh``, this rank's rows (module docstring)."""
    if sample_method not in ("beam", "multinomial", "topk"):
        raise ValueError(f"unknown sample_method {sample_method!r}")
    rescore_method = normalize_rescore_method(rescore_method)
    temps = (list(temperature) if isinstance(temperature, (list, tuple))
             else [temperature])
    annotations = annotations.contiguous()
    b, L = annotations.shape[:2]
    k, S, v, dev = beamk, max_gen_length, cfg.vocab_size, annotations.device
    start_i, end_i, pad_i, unk_i = _special(cfg)
    noisy = decoder_noise is not None and decoder_noise != 0.0
    fused = select_beam_fused(fused, dev, cfg, L, noisy)
    if generator is None and (noisy or sample_method != "beam"):
        generator = torch.Generator(device=dev).manual_seed(0)

    att_enc = attention_precompute(params, annotations)           # (B, L, A)
    h, c = init_lstm_state_beams(params, annotations, cfg, k)     # (layers, B, k, H)

    if fused:
        lw = step_weights(params, cfg, annotations.dtype)         # once per decode
        emb = capped_embedding(params, cfg)

        def step(prev_embed, h, c, t):
            # B k rows, image-major and slot-minor, over the (B, L, .)
            # tensors: the kernels read each image once for its k slots
            tproj, h1, c1, _, alpha = fused_decoder_step(
                lw, cfg, prev_embed.contiguous(),
                h[0].reshape(b * k, -1).contiguous(),
                c[0].reshape(b * k, -1).contiguous(), annotations, att_enc)
            return (fused_output_logits(params, cfg, tproj, emb, mesh),
                    h1.reshape(h.shape), c1.reshape(c.shape), alpha)
    else:
        def step(prev_embed, h, c, t):
            # attention of each image's k slots over its one (B, L, .) copy
            hidden = h[-1].reshape(b * k, -1)
            att_dec = _linear(params.att_dec, h[-1])              # (B, k, A)
            att = _linear(params.f_att, torch.tanh(
                att_enc[:, None] + att_dec[:, :, None]))[..., 0] * (L ** -0.5)
            alpha = torch.softmax(att.float(), dim=-1).to(att.dtype)
            zt = torch.einsum("bkl,bld->bkd", alpha,
                              annotations).reshape(b * k, -1)     # (B k, D)
            x = torch.cat([prev_embed, beta_gate(params, hidden) * zt], dim=-1)
            h_in = h
            if noisy:
                # in the state's type: JAX's float32 draw turns a bf16
                # state float32, which its scan's carry refuses (TypeError)
                h_in = h + (_noise(normal_noise, h.shape, generator, dev, mesh,
                                   axis=1) * (decoder_noise / (t + 1.0))).to(h.dtype)
            h1, c1 = lstm_stack_step(x, h_in.reshape(h.shape[0], b * k, -1),
                                     c.reshape(c.shape[0], b * k, -1),
                                     params.lstm)
            logits = deep_output(params, cfg, prev_embed, h1[-1], zt, mesh=mesh)
            return logits, h1.reshape(h.shape), c1.reshape(c.shape), alpha

    always = torch.zeros(v, device=dev)
    always[[start_i, pad_i]] = NEG_INF
    step0 = always.clone()
    step0[[end_i, unk_i]] = NEG_INF
    slot0 = (torch.arange(k, device=dev) == 0)[None, :, None]     # (1, k, 1)
    stay_row = torch.full((k,), NEG_INF, device=dev)
    stay_row[0] = STAY_SCORE
    ident = torch.arange(k, device=dev).expand(b, k)

    cur_tok = torch.full((b, k), start_i, dtype=torch.long, device=dev)
    scores = torch.zeros(b, k, device=dev)
    finished = torch.zeros(b, k, dtype=torch.bool, device=dev)
    flen = torch.zeros(b, k, dtype=torch.long, device=dev)
    bar = torch.zeros(b, k, device=dev)
    # append-only records; unexecuted steps (early_exit) keep PAD tokens and
    # identity backpointers, so the backwards walk passes through them
    tok_rec = torch.full((S + 1, b, k), pad_i, dtype=torch.long, device=dev)
    sparent_rec = ident.expand(S + 1, b, k).clone()
    alpha_rec = torch.zeros(S + 1, b, k, L, device=dev)

    for t in range(S + 1):
        prev_embed = embed_tokens(params, cur_tok.reshape(b * k), cfg, mesh)
        logits, h_new, c_new, alpha = step(prev_embed, h, c, t)
        scaled = logits.float() / temps[t % len(temps)]          # (B k, V)
        mask = step0 if t == 0 else always
        tf = float(max(t, 1))
        if sample_method == "beam":
            # two-stage top-k: each slot's own top k, then the top k of the
            # k k union; ties go to the lower slot, then the lower word
            vals, idx = topk_small(scaled + mask, k)               # (B k, k)
            lse = torch.logsumexp(scaled, dim=-1)
            cand_seq = scores[:, :, None] + (vals - lse[:, None]).reshape(b, k, k)
            cand_tok = idx.reshape(b, k, k)
            # step 0: every slot holds START, so the k words come from slot 0
            sel = torch.where(slot0, cand_seq, NEG_INF) if t == 0 else cand_seq
            sel = torch.where(finished[:, :, None], stay_row, sel)
            cand_tok = torch.where(finished[:, :, None], pad_i, cand_tok)
            _, flat_idx = topk_small(sel.reshape(b, k * k), k)     # (B, k)
            parent = flat_idx // k
            token = cand_tok.reshape(b, k * k).gather(1, flat_idx)
            cand_scores = cand_seq.reshape(b, k * k).gather(1, flat_idx)
        else:
            logp = torch.log_softmax(scaled, dim=-1).reshape(b, k, v) + mask
            seq_scores = scores[:, :, None] + logp                  # (B, k, V)
            if t == 0:
                sel = torch.where(slot0, seq_scores, NEG_INF)
            elif sample_method == "multinomial":
                row = 20.0 * seq_scores / tf
                sel = (row - torch.logsumexp(row, dim=-1, keepdim=True)
                       + _noise(gumbel_noise, row.shape, generator, dev, mesh))
            else:   # topk: sample among each row's sample_topk best
                kth = topk_small(seq_scores, sample_topk)[0][..., -1:]
                sel = torch.where(seq_scores >= kth, seq_scores / tf, NEG_INF)
                sel = sel + (_noise(gumbel_noise, sel.shape, generator, dev, mesh)
                             * (sel > NEG_INF / 2))
            stay = torch.full((b, k, v), NEG_INF, device=dev)
            stay[:, :, pad_i] = STAY_SCORE
            sel = torch.where(finished[:, :, None], stay, sel)
            _, flat_idx = topk_small(sel.reshape(b, k * v), k)
            parent = flat_idx // v
            token = flat_idx % v
            cand_scores = seq_scores.reshape(b, k * v).gather(1, flat_idx)
        # step 0 keeps every slot's own state (they differ: see
        # init_lstm_state_beams), so the state lineage is the identity there
        sparent = ident if t == 0 else parent

        p_finished = finished.gather(1, parent)
        scores = torch.where(p_finished, scores.gather(1, parent), cand_scores)
        cur_tok = torch.where(p_finished, pad_i, token)
        newly = ~p_finished & (cur_tok == end_i)
        finished = p_finished | newly
        flen = torch.where(newly, t, flen.gather(1, parent))
        # BAR's mean over the slots live at this step, kept at finish time
        bar = torch.where(newly, _live_mean(scores, ~p_finished)[:, None],
                          bar.gather(1, parent))
        h = _gather_beams(h_new, sparent, axis=2)
        c = _gather_beams(c_new, sparent, axis=2)
        tok_rec[t] = cur_tok
        sparent_rec[t] = sparent
        alpha_rec[t] = alpha.reshape(b, k, L).float()   # raw, finished slots too
        if early_exit and _all_finished(finished, mesh):
            break

    # walk the ancestor chain back from the final slots: at step t, anc is
    # the ancestor of each final slot; the token it chose is the history's
    # word t + 1, its alpha that of its state parent
    anc = ident
    tok_rows, alpha_rows = [None] * (S + 1), [None] * (S + 1)
    for t in range(S, -1, -1):
        tok_rows[t] = tok_rec[t].gather(1, anc)
        anc = sparent_rec[t].gather(1, anc)
        alpha_rows[t] = _gather_beams(alpha_rec[t], anc, axis=1)
    tokens = torch.cat([torch.full((b, k, 1), start_i, dtype=torch.long,
                                   device=dev), torch.stack(tok_rows, 2)], 2)

    # the max_gen_length flush: unfinished slots keep their score, length S
    # and the final live mean as BAR term
    bar = torch.where(finished, bar, _live_mean(scores, ~finished)[:, None])
    flen = torch.where(finished, flen, S)
    lf = torch.clamp(flen.float(), min=1.0)
    return BeamResult(
        tokens=tokens.to(torch.int32), lengths=flen.to(torch.int32),
        raw_scores=scores,
        scores=_rescore(scores, lf, bar, rescore_method, rescore_reward),
        perplexity=torch.exp(-scores / lf), alphas=torch.stack(alpha_rows, 2))
