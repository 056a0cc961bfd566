"""The optimizer with the reference's parameter groups, ported from
``sat_tpu/train/optim.py`` onto ``torch.optim``.

* Groups: decoder leaves at ``decoder_lr`` (weight decay on leaves of two or
  more dimensions); the embedding at ``embedding_lr`` without decay, only
  when it is not tied and ``embedding_lr > 0`` (a tied embedding rides in
  the decoder group); the encoder at ``encoder_lr`` only when
  ``encoder_finetune_after > 0`` and ``encoder_lr > 0``.  A leaf in no group
  is frozen.
* Each group's ``lr`` is written from the scheduler before every update
  (``apply_group_lrs``); torch applies it after the rest of the update, as
  JAX's chains leave the LR to the trainer.
* Weight decay: ``sgd`` adds it to the gradient before the momentum trace,
  ``adam`` before the moments (L2), ``adamw`` after them (decoupled, times
  the LR): torch's SGD, Adam and AdamW, which are optax's chains.
* The clip (``clip_gradients``) runs over every leaf's gradient before the
  groups split, frozen leaves that have one included; the norm clip is
  ``clip_grad_norm_`` with its 1e-6 epsilon, which JAX copies.
* ``step`` counts every leaf of every group at every update: optax's Adam
  counts a step on zero gradients too, so a leaf without a gradient (an
  encoder still frozen before ``encoder_finetune_after``) steps on zeros.
* ``accumulate > 1`` wraps all of it in ``MultiSteps``, as JAX wraps its
  transformation in ``optax.MultiSteps``: the clip and the update act on
  the mean of ``accumulate`` gradients, once every ``accumulate`` steps."""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import torch

from ..config import SATConfig
from ..parallel.mesh import MODEL_AXIS, ONE_RANK, Mesh

FROZEN = "frozen"

LABEL_TO_LR_GROUP = {
    "decoder_decay": "decoder", "decoder_nodecay": "decoder",
    "embedding": "embedding",
    "encoder_decay": "encoder", "encoder_nodecay": "encoder",
    FROZEN: None,
}

NamedParams = Iterable[Tuple[str, torch.Tensor]]


def label_params(cfg: SATConfig, named_params: NamedParams) -> Dict[str, str]:
    """A group label for each leaf, by name: ``decoder.<path>`` or
    ``encoder.<path>``, as ``SATModel.named_parameters()`` names them."""
    emb_trainable = cfg.embedding_lr > 0 and not cfg.weight_tying
    enc_trainable = cfg.encoder_finetune_after > 0 and cfg.encoder_lr > 0
    labels = {}
    for name, leaf in named_params:
        top, _, path = name.partition(".")
        if top == "decoder" and path == "embedding":
            if cfg.weight_tying and cfg.deep_output:
                label = "decoder_decay"      # tied: lives in the output group
            else:
                label = "embedding" if emb_trainable else FROZEN
        elif top == "decoder":
            label = "decoder_decay" if leaf.ndim > 1 else "decoder_nodecay"
        elif top == "encoder" and enc_trainable:
            label = "encoder_decay" if leaf.ndim > 1 else "encoder_nodecay"
        else:
            label = FROZEN
        labels[name] = label
    return labels


def build_optimizer(cfg: SATConfig, named_params: NamedParams
                    ) -> Tuple[torch.optim.Optimizer, Dict[str, str]]:
    """(optimizer, labels).  One parameter group per label that has leaves;
    each group's ``lr_group`` names the scheduler's LR it takes."""
    named = list(named_params)
    labels = label_params(cfg, named)
    groups = []
    for label, lr_group in LABEL_TO_LR_GROUP.items():
        params = [p for n, p in named if labels[n] == label]
        if lr_group is None or not params:
            continue
        decay = cfg.weight_decay if label.endswith("_decay") else 0.0
        groups.append({"params": params, "weight_decay": decay, "lr": 0.0,
                       "label": label, "lr_group": lr_group})
    betas = (cfg.adam_b1, cfg.adam_b2)
    if cfg.opt == "sgd":
        opt = torch.optim.SGD(groups, lr=0.0, momentum=cfg.momentum,
                              nesterov=cfg.nesterov and cfg.momentum > 0)
    elif cfg.opt == "adam":
        opt = torch.optim.Adam(groups, lr=0.0, betas=betas, eps=1e-8)
    elif cfg.opt == "adamw":
        opt = torch.optim.AdamW(groups, lr=0.0, betas=betas, eps=1e-8)
    else:
        raise ValueError(f"unknown optimizer {cfg.opt!r}")
    return opt, labels


@torch.no_grad()
def clip_gradients(cfg: SATConfig, params: Iterable[torch.Tensor],
                   mesh: Mesh = ONE_RANK, sliced: Sequence[torch.Tensor] = ()) -> None:
    """Clip the gradients of ``params`` in place, by value or by their
    global norm (``cfg.grad_clip``), where ``cfg.clip_value > 0``.  Under
    vocab TP the norm is the whole model's: the squared norms of the
    ``sliced`` leaves (the vocab slices) are summed over ``mesh``'s model
    axis, the others are alike on every rank."""
    grads = [p for p in params if p.grad is not None]
    if cfg.clip_value <= 0 or not grads:
        return
    if cfg.grad_clip == "value":
        torch.nn.utils.clip_grad_value_(grads, cfg.clip_value)
    elif not sliced:
        torch.nn.utils.clip_grad_norm_(grads, cfg.clip_value)
    else:
        ids = {id(p) for p in sliced}
        sq = lambda ps: sum((torch.linalg.vector_norm(p.grad) ** 2 for p in ps),
                            torch.zeros((), device=grads[0].device))
        total = torch.sqrt(sq([p for p in grads if id(p) not in ids])
                           + mesh.sum(sq([p for p in grads if id(p) in ids]),
                                      MODEL_AXIS))
        coef = torch.clamp(cfg.clip_value / (total + 1e-6), max=1.0)
        for p in grads:
            p.grad.mul_(coef)


def apply_group_lrs(optimizer: torch.optim.Optimizer,
                    lrs: Dict[str, float]) -> None:
    """Set each group's LR to its scheduler group's current value."""
    for group in optimizer.param_groups:
        group["lr"] = lrs[group["lr_group"]]


def step(optimizer: torch.optim.Optimizer) -> None:
    """One update of every leaf of every group: a leaf without a gradient
    steps on zeros, so Adam's step count and moments follow optax's."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    optimizer.step()



class MultiSteps:
    """``optax.MultiSteps(tx, every_k_schedule=k)``'s bookkeeping for the
    torch optimizer: ``acc`` holds the running mean of the gradients since
    the last update (optax's ``acc_grads``, by parameter name, zeros for a
    leaf without a gradient), ``mini_step`` counts the steps into it and
    ``gradient_step`` the updates made."""

    def __init__(self, k: int, named_params: NamedParams):
        self.k = k
        self.mini_step = 0
        self.gradient_step = 0
        self.acc = {n: torch.zeros_like(p) for n, p in named_params}

    @torch.no_grad()
    def add(self, named_params: NamedParams) -> bool:
        """Fold each leaf's gradient into ``acc`` as optax does,
        ``acc + (g - acc) / (mini_step + 1)``.  On the k-th step the mean
        becomes each leaf's gradient, ``acc`` starts again from zeros and
        this returns True: the caller clips and updates.  Otherwise it
        returns False and the weights stay as they are."""
        named: List[Tuple[str, torch.Tensor]] = list(named_params)
        n = self.mini_step
        for name, p in named:
            acc = self.acc[name]
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            acc.add_((g - acc) / (n + 1))
        self.mini_step = (n + 1) % self.k
        if self.mini_step:
            return False
        self.gradient_step += 1
        for name, p in named:
            p.grad, self.acc[name] = self.acc[name], torch.zeros_like(p)
        return True
