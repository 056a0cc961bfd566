"""Plain PyTorch reference of the SAT decoder (Xu et al. 2015, eq. 4-7, with
the deep output of eq. 7): one step, the decode loops, and the scoring of a
served caption by teacher forcing.

Provenance: the reference repository's ``model.py`` as the port's plain
paths (``models/decoder.py``, ``decode/beam.py``, ``kernels/greedy_loop.py``'s
``greedy_scan``) compute it, written anew over a dict of tensors named as
the port's ``SATModel.state_dict`` (``decoder.att_enc.w``, ...; linear
weights (in, out), applied as ``x @ w``).  One LSTM layer, deep output, no
dropout, no weight tying, no embedding cap: what the benchmark's
configurations state.  Departures from the port's plain paths: none in the
arithmetic; the beam search keeps the port's rules (two-stage top-k, a
finished slot's one "stay" candidate, the initial state's raw reshape over
the k slots) but drops sampling, noise, the mesh and the other rescorings,
and runs its k slots over k-fold copies of the annotations.  Nothing here
imports the port."""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e9       # the masks' value, the port's (kernels/greedy_loop.py)
STAY = 1e9


class Specials(NamedTuple):
    start: int
    end: int
    pad: int
    unk: int


class Weights:
    """The decoder's tensors by the port's names, without the prefix."""

    def __init__(self, sd: Dict[str, torch.Tensor], prefix: str = "decoder."):
        self.p = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.p[name]

    @property
    def H(self) -> int:
        return self.p["lstm.layer_0.w_hh"].shape[0]


def masks(V: int, sp: Specials, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Additive masks (V,): (step 0, later): START and PAD always, END and
    UNK at step 0."""
    later = torch.zeros(V, device=device)
    later[[sp.start, sp.pad]] = NEG_INF
    step0 = later.clone()
    step0[[sp.end, sp.unk]] = NEG_INF
    return step0, later


def attention_precompute(w: Weights, annots: torch.Tensor) -> torch.Tensor:
    return annots @ w["att_enc.w"]


def initial_state(w: Weights, annots: torch.Tensor) -> torch.Tensor:
    """The (B, 2H) projection of the mean annotation: h is its first half, c
    its second."""
    mean = annots.mean(dim=1)
    f = mean @ w["init_factorize.w"] + w["init_factorize.b"]
    return f @ w["init_proj.w"] + w["init_proj.b"]


def beam_initial_state(w: Weights, annots: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h, c (B, k, H): the reference's state init on k copies of an image,
    reshaped raw, so slot j's h takes g[(j H + i) mod 2H] and its c
    g[((k + j) H + i) mod 2H]."""
    g = initial_state(w, annots)
    H = w.H
    i = torch.arange(H, device=g.device)
    hs = [g[:, (j * H + i) % (2 * H)] for j in range(k)]
    cs = [g[:, ((k + j) * H + i) % (2 * H)] for j in range(k)]
    return torch.stack(hs, 1), torch.stack(cs, 1)


def step(w: Weights, emb: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
         annots: torch.Tensor, att_enc: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step for rows (N, .) over their annotations (N, L, D) ->
    (logits (N, V), h', c', alpha (N, L))."""
    L = annots.shape[1]
    att = torch.tanh(att_enc + (h @ w["att_dec.w"])[:, None, :]) @ w["f_att.w"]
    alpha = torch.softmax(att[..., 0] * (L ** -0.5), dim=-1)
    z = torch.einsum("nl,nld->nd", alpha, annots)
    beta = torch.sigmoid(h @ w["beta.w"] + w["beta.b"])
    x = torch.cat([emb, beta * z], dim=-1)
    gates = (x @ w["lstm.layer_0.w_ih"] + h @ w["lstm.layer_0.w_hh"]
             + w["lstm.layer_0.b_ih"] + w["lstm.layer_0.b_hh"])
    gi, gf, gg, go = gates.chunk(4, dim=-1)
    c1 = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
    h1 = torch.sigmoid(go) * torch.tanh(c1)
    t = torch.tanh(emb + h1 @ w["out_hidden.w"] + z @ w["out_context.w"])
    return t @ w["out_proj.w"] + w["out_proj.b"], h1, c1, alpha


def embed(w: Weights, tokens: torch.Tensor) -> torch.Tensor:
    return w["embedding"][tokens]


# ---------------------------------------------------------------------------
# Scoring what the program served
# ---------------------------------------------------------------------------

SEARCH_TOL = 1e-4    # nats a word: a served caption this far below the best is worse


class Gaps(NamedTuple):
    """The widest gaps over a batch: per-token score, attention, and the
    rank gap (how far a served token's log-probability lies below the
    reference's k-th best at its step); for beam search also each image's
    served caption's LN score as the reference computes it."""
    score: float
    alpha: float
    rank: float
    tokens: int
    ln: Optional[torch.Tensor] = None


def _kth(logp: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(logp, k, dim=-1).values[..., -1]


@torch.no_grad()
def score_beam_captions(w: Weights, sp: Specials, annots: torch.Tensor,
                        captions: List[List[int]], scores: List[float],
                        alphas: List[np.ndarray], k: int, S: int) -> Gaps:
    """Teacher-force each image's served caption (``SATModel.caption``'s
    lists: words without START / END, the LN score, one attention map per
    word) through the reference and measure the gaps.

    The search's rules fix the lineage: step 0's k words come from slot 0's
    distribution, the j-th best to slot j, which keeps its own initial
    state, so the first word's rank picks the slot.  A caption of fewer than
    S words ended with END at step n, whose log-probability the score
    holds; one of S words holds one more term, the token of step S, which
    must be one of that step's k best: the closest of them is taken."""
    dev = annots.device
    B, L, _ = annots.shape
    V = w["out_proj.w"].shape[1]
    step0, later = masks(V, sp, dev)
    n = torch.tensor([len(c) for c in captions], device=dev)
    toks = torch.full((B, S + 1), sp.pad, dtype=torch.long, device=dev)
    toks[:, 0] = sp.start
    for i, cap in enumerate(captions):
        if cap:
            toks[i, 1:len(cap) + 1] = torch.tensor(cap, device=dev)
    att_enc = attention_precompute(w, annots)
    h0, c0 = beam_initial_state(w, annots, k)
    # step 0 of slot 0: the first word's distribution and rank
    lg0, _, _, _ = step(w, embed(w, toks[:, 0]), h0[:, 0], c0[:, 0], annots, att_enc)
    lp0 = torch.log_softmax(lg0, -1)
    masked0 = lp0 + step0
    first = toks[:, 1].clamp(max=V - 1)
    rank = (masked0 > masked0.gather(1, first[:, None])).sum(1).clamp(max=k - 1)
    rank = torch.where(n > 0, rank, torch.zeros_like(rank))
    h = h0[torch.arange(B, device=dev), rank]
    c = c0[torch.arange(B, device=dev), rank]
    logps, ranks, alph = [], [], []
    for s in range(S + 1):
        lg, h, c, a = step(w, embed(w, toks[:, s]), h, c, annots, att_enc)
        lp = lp0 if s == 0 else torch.log_softmax(lg, -1)
        logps.append(lp)
        ranks.append(_kth(lp + (step0 if s == 0 else later), k))
        alph.append(a)
    logp = torch.stack(logps, 1)                    # (B, S+1, V)
    kth = torch.stack(ranks, 1)                     # (B, S+1)
    alpha_ref = torch.stack(alph, 1)                # (B, S+1, L)
    tgt = torch.cat([toks[:, 1:], torch.full((B, 1), sp.pad, device=dev,
                                              dtype=torch.long)], 1)
    tgt = torch.where(torch.arange(S + 1, device=dev)[None] == n[:, None], sp.end, tgt)
    tlp = logp.gather(2, tgt[..., None])[..., 0]    # (B, S+1)
    steps = torch.arange(S + 1, device=dev)[None]
    live = steps < n[:, None]                        # word steps
    ended = (steps == n[:, None]) & (n[:, None] < S)  # the END step
    ref_raw = (tlp * (live | ended)).sum(1)
    prog_raw = torch.tensor(scores, device=dev, dtype=torch.float64) \
        * n.clamp(min=1).double()
    full = n >= S
    if bool(full.any()):
        # the step-S token: the closest of the reference's k best
        top = torch.topk(logp[:, S] + later, k, dim=-1).values  # (B, k)
        resid = (prog_raw - ref_raw.double())[:, None] - top.double()
        best = top.double().gather(1, resid.abs().argmin(1, keepdim=True))[:, 0]
        ref_raw = torch.where(full, ref_raw.double() + best, ref_raw.double())
    score_gap = ((prog_raw - ref_raw.double()).abs() / (n + 1).double()).max()
    rank_gap = torch.clamp(kth - tlp, min=0.0) * (live | ended)
    a_gap = 0.0
    for i in range(B):
        m = len(captions[i])
        if m:
            got = torch.as_tensor(np.asarray(alphas[i]), device=dev).reshape(m, L)
            a_gap = max(a_gap, float((got - alpha_ref[i, :m]).abs().max()))
    return Gaps(float(score_gap), a_gap, float(rank_gap.max()),
                int((live | ended).sum()), ref_raw.double() / n.clamp(min=1).double())


@torch.no_grad()
def score_greedy(w: Weights, sp: Specials, annots: torch.Tensor, tokens: torch.Tensor,
                 raw_scores: torch.Tensor, alphas: torch.Tensor, lengths: torch.Tensor,
                 S: int) -> Gaps:
    """Teacher-force each row's greedy tokens (B, S+2) through the reference:
    a row is live through the step that emitted END (its length), or
    through step S where it never did; its score sums the live steps'
    log-probabilities, its alphas are the live steps' maps, and each live
    token must be the masked row's best."""
    dev = annots.device
    B = annots.shape[0]
    V = w["out_proj.w"].shape[1]
    step0, later = masks(V, sp, dev)
    toks = tokens.to(dev).long()
    ended = (toks[:, 1:] == sp.end).any(1)
    last = torch.where(ended, lengths.to(dev).long(), torch.full_like(ended, S, dtype=torch.long))
    att_enc = attention_precompute(w, annots)
    g = initial_state(w, annots)
    H = w.H
    h, c = g[:, :H], g[:, H:2 * H]
    logps, best, alph = [], [], []
    for s in range(S + 1):
        lg, h, c, a = step(w, embed(w, toks[:, s]), h, c, annots, att_enc)
        lp = torch.log_softmax(lg, -1)
        logps.append(lp.gather(1, toks[:, s + 1:s + 2].clamp(max=V - 1))[:, 0])
        best.append((lp + (step0 if s == 0 else later)).max(-1).values)
        alph.append(a)
    tlp, top = torch.stack(logps, 1), torch.stack(best, 1)
    live = torch.arange(S + 1, device=dev)[None] <= last[:, None]
    ref_raw = (tlp * live).sum(1)
    score_gap = ((raw_scores.to(dev).double() - ref_raw.double()).abs()
                 / (last + 1).double()).max()
    rank_gap = (torch.clamp(top - tlp, min=0.0) * live).max()
    a_gap = ((alphas.to(dev).float() - torch.stack(alph, 1)).abs()
             * live[..., None]).max()
    return Gaps(float(score_gap), float(a_gap), float(rank_gap), int(live.sum()))


# ---------------------------------------------------------------------------
# The decode loops, for the control (the reference in the program's place)
# ---------------------------------------------------------------------------

@torch.no_grad()
def beam_search(w: Weights, sp: Specials, annots: torch.Tensor, k: int, S: int,
                grid_hw: Tuple[int, int], pick: int = 0, keep: int = 0,
                worst: bool = False):
    """Beam search with LN rescoring -> ``SATModel.caption``'s lists
    (captions, scores, alphas), the best hypothesis of each image.  Faults,
    for the control, each with the chosen words' own log-probabilities:
    ``pick`` p > 0 gives each slot its words of ranks p+1 .. p+k; ``keep``
    q > 0 keeps the union's candidates of ranks q+1 .. q+k after step 0;
    ``worst`` serves each image's worst hypothesis."""
    dev = annots.device
    B, L, D = annots.shape
    V = w["out_proj.w"].shape[1]
    step0, later = masks(V, sp, dev)
    rep = annots.repeat_interleave(k, 0)
    att_enc = attention_precompute(w, rep)
    h, c = (x.reshape(B * k, -1) for x in beam_initial_state(w, annots, k))
    slot0 = (torch.arange(k, device=dev) == 0)[None, :, None]
    stay = torch.full((k,), NEG_INF, device=dev)
    stay[0] = STAY
    ident = torch.arange(k, device=dev).expand(B, k)
    cur = torch.full((B, k), sp.start, dtype=torch.long, device=dev)
    scores = torch.zeros(B, k, device=dev)
    finished = torch.zeros(B, k, dtype=torch.bool, device=dev)
    flen = torch.zeros(B, k, dtype=torch.long, device=dev)
    tok_rec, par_rec, al_rec = [], [], []
    for t in range(S + 1):
        lg, h1, c1, a = step(w, embed(w, cur.reshape(-1)), h, c, rep, att_enc)
        lse = torch.logsumexp(lg, -1)
        vals, idx = torch.topk(lg + (step0 if t == 0 else later), k + pick, dim=-1)
        vals, idx = vals[:, pick:], idx[:, pick:]
        cand = scores[:, :, None] + (vals - lse[:, None]).reshape(B, k, k)
        ctok = idx.reshape(B, k, k)
        sel = torch.where(slot0, cand, NEG_INF) if t == 0 else cand
        sel = torch.where(finished[:, :, None], stay, sel)
        ctok = torch.where(finished[:, :, None], sp.pad, ctok)
        q = keep if t > 0 else 0
        flat = torch.topk(sel.reshape(B, k * k), k + q, dim=-1).indices[:, q:]
        parent = flat // k
        token = ctok.reshape(B, k * k).gather(1, flat)
        cs = cand.reshape(B, k * k).gather(1, flat)
        sparent = ident if t == 0 else parent
        pf = finished.gather(1, parent)
        scores = torch.where(pf, scores.gather(1, parent), cs)
        cur = torch.where(pf, sp.pad, token)
        newly = ~pf & (cur == sp.end)
        finished = pf | newly
        flen = torch.where(newly, t, flen.gather(1, parent))
        rows = (torch.arange(B, device=dev)[:, None] * k + sparent).reshape(-1)
        h, c = h1[rows], c1[rows]
        tok_rec.append(cur)
        par_rec.append(sparent)
        al_rec.append(a.reshape(B, k, L))
    anc = ident
    toks, als = [None] * (S + 1), [None] * (S + 1)
    for t in range(S, -1, -1):
        toks[t] = tok_rec[t].gather(1, anc)
        anc = par_rec[t].gather(1, anc)
        als[t] = al_rec[t].gather(1, anc[..., None].expand(B, k, L))
    toks = torch.stack(toks, 2).cpu().numpy()
    als = torch.stack(als, 2).cpu().numpy()
    flen = torch.where(finished, flen, S)
    ln = (scores / flen.clamp(min=1).float()).cpu().numpy()
    flen = flen.cpu().numpy()
    caps, out_s, out_a = [], [], []
    gh, gw = grid_hw
    for i in range(B):
        j = int(np.argmin(ln[i]) if worst else np.argmax(ln[i]))
        m = int(flen[i, j])
        caps.append(toks[i, j, :m].tolist())
        out_s.append(float(ln[i, j]))
        out_a.append(als[i, j, :m].reshape(m, gh, gw))
    return caps, out_s, out_a


@torch.no_grad()
def greedy(w: Weights, sp: Specials, annots: torch.Tensor, S: int, pick: int = 0):
    """Greedy decoding -> (tokens (B, S+2), raw scores (B,), alphas (B, S+1,
    L), lengths (B,)), ``greedy_decode``'s fields.  With ``pick`` p > 0 each
    step takes the word of rank p+1 with its own log-probability (a
    selection fault, for the control)."""
    dev = annots.device
    B, L, _ = annots.shape
    V = w["out_proj.w"].shape[1]
    step0, later = masks(V, sp, dev)
    att_enc = attention_precompute(w, annots)
    g = initial_state(w, annots)
    H = w.H
    h, c = g[:, :H], g[:, H:2 * H]
    toks = torch.full((B, S + 2), sp.pad, dtype=torch.long, device=dev)
    toks[:, 0] = sp.start
    alphas = torch.zeros(B, S + 1, L, device=dev)
    scores = torch.zeros(B, device=dev)
    flen = torch.zeros(B, dtype=torch.long, device=dev)
    fin = torch.zeros(B, dtype=torch.bool, device=dev)
    for t in range(S + 1):
        lg, h, c, a = step(w, embed(w, toks[:, t]), h, c, annots, att_enc)
        masked = lg + (step0 if t == 0 else later)
        tok = (torch.argmax(masked, -1) if pick == 0
               else torch.topk(masked, pick + 1, dim=-1).indices[:, pick])
        lp = lg.gather(1, tok[:, None])[:, 0] - torch.logsumexp(lg, -1)
        tok = torch.where(fin, sp.pad, tok)
        scores = torch.where(fin, scores, scores + lp)
        alphas[:, t] = torch.where(fin[:, None], 0.0, a)
        newly = ~fin & (tok == sp.end)
        flen = torch.where(newly, t, flen)
        fin = fin | newly
        toks[:, t + 1] = tok
    return toks, scores, alphas, torch.where(fin, flen, S)
