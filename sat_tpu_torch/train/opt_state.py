"""The optimizer state in optax's layout, both ways: the ``opt_state`` entry
of a checkpoint, as ``flax.serialization.to_state_dict`` writes the state of
``sat_tpu/train/optim.py::build_optimizer``'s transformation, made from and
loaded into the ``torch.optim`` state of ``train/optim.py``.

That transformation is ``chain(clip, multi_transform(chains, labels))``::

    {"0": {},                                    # the clip's empty state
     "1": {"inner_states": {label: {"inner_state": chain state}}}}

for the labels ``decoder_decay``, ``decoder_nodecay``, ``embedding``,
``encoder_decay``, ``encoder_nodecay`` (each a chain, whose states go by
position: ``{}`` for ``add_decayed_weights`` and ``scale``, ``{"count",
"mu", "nu"}`` for ``scale_by_adam``, ``{"trace"}`` for ``trace``) and
``frozen`` (``{"inner_state": {}}``, ``set_to_zero``).  Each ``mu``, ``nu``
and ``trace`` is the whole params tree: an array at each of the label's own
leaves and ``{}`` (optax's ``MaskedNode``) at every other.  Every label's
``count`` is an int32 that counts every update, a label without leaves
too.

torch's ``exp_avg``, ``exp_avg_sq`` and ``momentum_buffer`` are ``mu``,
``nu`` and ``trace``, its ``step`` is ``count``; leaves change layout
through ``models/jax_import.py::jax_leaf_map``.  Before the first update
torch holds no state, and the tree holds zeros, as ``tx.init`` gives.

With ``accumulate > 1`` JAX wraps that transformation in
``optax.MultiSteps``, whose state is the tree::

    {"mini_step": int32, "gradient_step": int32,
     "inner_opt_state": the tree above, "acc_grads": params tree,
     "skip_state": {}}

``train/optim.py::MultiSteps`` keeps ``mini_step``, ``gradient_step`` and
``acc_grads`` (the running mean of the gradients, at every leaf of the
params tree, frozen ones too); the inner counts are ``gradient_step``."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import SATConfig
from ..models.jax_import import from_jax_layout, jax_leaf_map, nest_leaves, to_jax_layout
from .optim import FROZEN, LABEL_TO_LR_GROUP, MultiSteps, label_params

Tree = Dict[str, Any]
# torch's state key of each array optax keeps
TORCH_KEY = {"mu": "exp_avg", "nu": "exp_avg_sq", "trace": "momentum_buffer"}
# the keys of optax.MultiSteps' state (cfg.accumulate > 1)
_MULTISTEPS = ("mini_step", "gradient_step", "inner_opt_state", "acc_grads",
               "skip_state")


def chain_states(cfg: SATConfig, label: str) -> List[Optional[str]]:
    """The states of ``label``'s chain by position (``_group_chain`` of
    ``sat_tpu/train/optim.py``): ``"adam"``, ``"trace"`` or None for an
    empty state."""
    decay = bool(cfg.weight_decay) and label.endswith("_decay")
    if cfg.opt == "sgd":
        return [None] * decay + ["trace"] * bool(cfg.momentum) + [None]
    if cfg.opt == "adam":
        return [None] * decay + ["adam", None]
    if cfg.opt == "adamw":
        return ["adam"] + [None] * decay + [None]
    raise ValueError(f"unknown optimizer {cfg.opt!r}")


def optax_state_dict(cfg: SATConfig, model, optimizer: torch.optim.Optimizer,
                     n_updates: int, multisteps: Optional[MultiSteps] = None) -> Tree:
    """The ``opt_state`` tree of ``optimizer`` (built by
    ``build_optimizer(cfg, model.named_parameters())``) after ``n_updates``
    updates: numpy leaves, C-contiguous, in JAX's layouts.  With
    ``multisteps`` (``cfg.accumulate > 1``) the tree is ``MultiSteps``'
    around it, and the updates are ``multisteps.gradient_step``."""
    leaf_map = jax_leaf_map(model)
    if multisteps is not None:
        return {"mini_step": np.asarray(multisteps.mini_step, np.int32),
                "gradient_step": np.asarray(multisteps.gradient_step, np.int32),
                "inner_opt_state": optax_state_dict(cfg, model, optimizer,
                                                    multisteps.gradient_step),
                "acc_grads": nest_leaves({path: to_jax_layout(multisteps.acc[n], perm)
                                          for n, (path, perm) in leaf_map.items()}),
                "skip_state": {}}
    named = dict(model.named_parameters())
    labels = label_params(cfg, named.items())
    masked = {path: {} for path, _ in leaf_map.values()}
    inner = {}
    for label in LABEL_TO_LR_GROUP:
        if label == FROZEN:
            inner[label] = {"inner_state": {}}
            continue
        own = [n for n in named if labels[n] == label]
        steps = {float(optimizer.state[named[n]]["step"]) for n in own
                 if "step" in optimizer.state.get(named[n], {})}
        if len(steps) > 1:
            raise ValueError(f"group {label!r}: its leaves have taken different "
                             f"numbers of steps {sorted(steps)}")
        count = np.asarray(int(steps.pop()) if steps else n_updates, np.int32)

        def tree(key: str) -> Tree:
            leaves = dict(masked)
            for n in own:
                p, (path, perm) = named[n], leaf_map[n]
                t = optimizer.state.get(p, {}).get(TORCH_KEY[key])
                leaves[path] = to_jax_layout(torch.zeros_like(p) if t is None else t, perm)
            return nest_leaves(leaves)

        states = {}
        for i, kind in enumerate(chain_states(cfg, label)):
            if kind == "adam":
                states[str(i)] = {"count": count, "mu": tree("mu"), "nu": tree("nu")}
            elif kind == "trace":
                states[str(i)] = {"trace": tree("trace")}
            else:
                states[str(i)] = {}
        inner[label] = {"inner_state": states}
    return {"0": {}, "1": {"inner_states": inner}}


def flatten(tree: Tree, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` of every array leaf and ``{path: {}}`` of every
    empty dict of ``tree``, the path's keys joined by ``/``."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def layout(tree: Tree) -> Dict[str, Any]:
    """``{path: shape}`` of every array leaf and ``{path: {}}`` of every
    empty dict of ``tree``."""
    return {k: v if isinstance(v, dict) else tuple(np.shape(v))
            for k, v in flatten(tree).items()}


def _node(tree: Tree, path) -> Any:
    for k in path:
        tree = tree[k]
    return tree


@torch.no_grad()
def load_optax_state(cfg: SATConfig, model, optimizer: torch.optim.Optimizer,
                     sd: Tree, multisteps: Optional[MultiSteps] = None) -> None:
    """Fill ``optimizer``'s state from an ``opt_state`` tree (numpy or CPU
    tensor leaves) of ``cfg``'s transformation, and ``multisteps``' from
    ``optax.MultiSteps``' tree where ``cfg.accumulate > 1``.  Raises
    ``ValueError`` for a tree of another layout."""
    if not isinstance(sd, dict):
        raise ValueError(f"opt_state is a {type(sd).__name__}, not a tree")
    is_multi = any(k in sd for k in _MULTISTEPS)
    if is_multi != (multisteps is not None):
        raise ValueError(f"opt_state is {'an' if is_multi else 'not an'} optax.MultiSteps "
                         f"state, and cfg.accumulate is {cfg.accumulate}: "
                         "the optimizer needs " + ("one" if multisteps else "none"))
    blank = None if multisteps is None else MultiSteps(multisteps.k, model.named_parameters())
    want, got = layout(optax_state_dict(cfg, model, optimizer, 0, blank)), layout(sd)
    if got != want:
        wrong = sorted(k for k in want.keys() | got.keys() if want.get(k, 0) != got.get(k, 0))
        raise ValueError(f"opt_state is not the layout of cfg's optimizer ({cfg.opt}): "
                         f"{len(wrong)} paths differ, e.g. {wrong[:3]}")
    leaf_map = jax_leaf_map(model)
    named = dict(model.named_parameters())
    if multisteps is not None:
        multisteps.mini_step = int(np.asarray(sd["mini_step"]))
        multisteps.gradient_step = int(np.asarray(sd["gradient_step"]))
        multisteps.acc = {n: from_jax_layout(_node(sd["acc_grads"], path), perm).to(named[n])
                          for n, (path, perm) in leaf_map.items()}
        sd = sd["inner_opt_state"]
    inner = sd["1"]["inner_states"]
    labels = label_params(cfg, named.items())
    scalar = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
    for label in (g["label"] for g in optimizer.param_groups):
        states = inner[label]["inner_state"]
        for n in (n for n in named if labels[n] == label):
            p, (path, perm) = named[n], leaf_map[n]
            st: Dict[str, Any] = {}
            for i, kind in enumerate(chain_states(cfg, label)):
                if kind == "adam":
                    st["step"] = torch.tensor(float(np.asarray(states[str(i)]["count"])),
                                              dtype=scalar)
                for key in {"adam": ("mu", "nu"), "trace": ("trace",)}.get(kind, ()):
                    st[TORCH_KEY[key]] = from_jax_layout(
                        _node(states[str(i)][key], path), perm).to(p)
            optimizer.state[p] = st
