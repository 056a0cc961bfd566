"""Offline torchvision weight import, ported from
``sat_tpu/models/torch_import.py`` for the four ``shufflenet_v2_*`` tables.

A saved torchvision ``state_dict`` (``.pt``/``.pth`` or an ``.npz`` with the
same keys) is converted, as in the JAX package, into the flax-layout tree of
the backbone: ``(params, batch_stats)`` keyed by flax module path, conv
kernels ``HWIO``, BatchNorm ``scale``/``bias`` and running ``mean``/``var``.
``import_pretrained`` merges that tree into a model's tree
(``jax_import.model_to_jax_tree``), which ``jax_import`` loads into the
port's modules: the conversion is the JAX package's, the loading is the one
every checkpoint takes.

The other encoders' converters come with those encoders (``ROADMAP.md`` §1
item 7); ``convert_backbone`` raises ``NotImplementedError`` for them."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

SHUFFLENET_ARCHS = ("shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
                    "shufflenet_v2_x1_5", "shufflenet_v2_x2_0")


def _conv(w) -> np.ndarray:
    return np.asarray(w).transpose(2, 3, 1, 0)  # OIHW -> HWIO


def _take(sd: Dict[str, Any], key: str) -> np.ndarray:
    return np.asarray(sd.pop(key))


def _bn(sd: Dict[str, Any], prefix: str) -> Tuple[Dict, Dict]:
    p = {"scale": _take(sd, f"{prefix}.weight"),
         "bias": _take(sd, f"{prefix}.bias")}
    s = {"mean": _take(sd, f"{prefix}.running_mean"),
         "var": _take(sd, f"{prefix}.running_var")}
    sd.pop(f"{prefix}.num_batches_tracked", None)
    return p, s


def _conv_entry(sd, key) -> Dict:
    p = {"kernel": _conv(_take(sd, f"{key}.weight"))}
    if f"{key}.bias" in sd:
        p["bias"] = _take(sd, f"{key}.bias")
    return p


class _Tree:
    """Accumulates params + batch_stats keyed by flax module path."""

    def __init__(self):
        self.params: Dict[str, Any] = {}
        self.stats: Dict[str, Any] = {}

    def conv(self, flax_name: str, sd, torch_key: str):
        self.params[flax_name] = _conv_entry(sd, torch_key)

    def bn(self, flax_name: str, sd, torch_key: str):
        p, s = _bn(sd, torch_key)
        self.params[flax_name] = p
        self.stats[flax_name] = s


def convert_shufflenet(sd: Dict[str, Any]) -> Tuple[Dict, Dict]:
    t = _Tree()
    t.conv("conv1", sd, "conv1.0")
    t.bn("bn1", sd, "conv1.1")
    for s, repeats in zip((2, 3, 4), (4, 8, 4)):
        for j in range(repeats):
            tp = f"stage{s}.{j}"
            fp = f"stage{s}_{j}"
            blk = _Tree()
            if j == 0:  # stride unit has branch1
                blk.conv("b1_dw", sd, f"{tp}.branch1.0")
                blk.bn("b1_dwbn", sd, f"{tp}.branch1.1")
                blk.conv("b1_pw", sd, f"{tp}.branch1.2")
                blk.bn("b1_pwbn", sd, f"{tp}.branch1.3")
            blk.conv("b2_pw1", sd, f"{tp}.branch2.0")
            blk.bn("b2_pw1bn", sd, f"{tp}.branch2.1")
            blk.conv("b2_dw", sd, f"{tp}.branch2.3")
            blk.bn("b2_dwbn", sd, f"{tp}.branch2.4")
            blk.conv("b2_pw2", sd, f"{tp}.branch2.5")
            blk.bn("b2_pw2bn", sd, f"{tp}.branch2.6")
            t.params[fp] = blk.params
            t.stats[fp] = blk.stats
    t.conv("conv5", sd, "conv5.0")
    t.bn("bn5", sd, "conv5.1")
    return t.params, t.stats


def unported(arch: str) -> NotImplementedError:
    return NotImplementedError(
        f"{arch}: only the shufflenet_v2_* encoders are ported; the other "
        "encoders and their weight converters are ROADMAP.md §1 item 7")


def convert_backbone(arch: str, state_dict: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """torchvision state_dict -> (backbone params, backbone batch_stats).
    Classifier-head keys are ignored (the reference strips them,
    model.py:29-41)."""
    if arch not in SHUFFLENET_ARCHS:
        raise unported(arch)
    sd = {k: v for k, v in state_dict.items()
          if not k.startswith(("fc.", "classifier."))}
    return convert_shufflenet(sd)


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a torchvision state_dict saved as .pt/.pth (torch) or .npz."""
    if path.endswith(".npz"):
        return dict(np.load(path))
    import torch
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: v.numpy() for k, v in obj.items()}


def _merge(dst: Dict[str, Any], src: Dict[str, Any], path: str = "") -> None:
    for k, v in src.items():
        if k not in dst:
            raise ValueError(f"missing {'module' if isinstance(v, dict) else 'leaf'} "
                             f"{path}/{k} in target")
        if isinstance(v, dict):
            _merge(dst[k], v, f"{path}/{k}")
        elif dst[k].shape != v.shape:
            raise ValueError(f"shape mismatch at {path}/{k}: {dst[k].shape} "
                             f"vs {v.shape}")
        else:
            dst[k] = v.astype(np.asarray(dst[k]).dtype)


def import_pretrained(arch: str, path: str, tree: Dict[str, Any]
                      ) -> Dict[str, Any]:
    """Merge converted backbone weights into a model's flax-layout tree
    (``{"params": {"encoder": ...}, "state": {"batch_stats": ...}}``, numpy
    leaves, as ``model_to_jax_tree`` gives it), shape-checked leaf by leaf.
    The tree is updated in place and returned."""
    params, stats = convert_backbone(arch, load_state_dict(path))
    _merge(tree["params"]["encoder"]["backbone"], params)
    _merge(tree["state"]["batch_stats"]["backbone"], stats)
    return tree
