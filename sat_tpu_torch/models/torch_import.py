"""Offline torchvision weight import, ported from
``sat_tpu/models/torch_import.py`` for all 26 tables of
``config.ENCODER_ARCHS``: the ResNet family, ``shufflenet_v2_*``,
``mobilenet_v2``, ``mobilenet_v3_*``, ``mnasnet*``, ``squeezenet1_0/1_1``
and ``densenet121/169/201/161``.

A saved torchvision ``state_dict`` (``.pt``/``.pth`` or an ``.npz`` with the
same keys) is converted, as in the JAX package, into the flax-layout tree of
the backbone: ``(params, batch_stats)`` keyed by flax module path, conv
kernels ``HWIO``, BatchNorm ``scale``/``bias`` and running ``mean``/``var``
(empty for SqueezeNet, which has no BatchNorm).  ``import_pretrained``
merges that tree into a model's tree (``jax_import.model_to_jax_tree``),
which ``jax_import`` loads into the port's modules: the conversion is the
JAX package's, the loading is the one every checkpoint takes."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from .backbones import (_MBV3_LARGE, _MBV3_SMALL, DENSENET_ARCHS, MNASNET_ALPHAS,
                        RESNET_ARCHS, SQUEEZENET_ARCHS)

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


# (stage sizes, bottleneck) of each table: groups and width change shapes only
_RESNET = {arch: (stages, bottleneck)
           for arch, (stages, bottleneck, _, _) in RESNET_ARCHS.items()}


def convert_resnet(sd: Dict[str, Any], stage_sizes, bottleneck: bool
                   ) -> Tuple[Dict, Dict]:
    t = _Tree()
    t.conv("conv1", sd, "conv1")
    t.bn("bn1", sd, "bn1")
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            tp = f"layer{i+1}.{j}"
            fp = f"layer{i+1}_{j}"
            blk = _Tree()
            n_convs = 3 if bottleneck else 2
            for k in range(1, n_convs + 1):
                blk.conv(f"conv{k}", sd, f"{tp}.conv{k}")
                blk.bn(f"bn{k}", sd, f"{tp}.bn{k}")
            if f"{tp}.downsample.0.weight" in sd:
                blk.conv("down_conv", sd, f"{tp}.downsample.0")
                blk.bn("down_bn", sd, f"{tp}.downsample.1")
            t.params[fp] = blk.params
            t.stats[fp] = blk.stats
    return t.params, t.stats


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


def convert_mobilenet_v2(sd: Dict[str, Any]) -> Tuple[Dict, Dict]:
    t = _Tree()
    t.conv("stem", sd, "features.0.0")
    t.bn("stem_bn", sd, "features.0.1")
    for idx, feat in enumerate(range(1, 18)):
        tp = f"features.{feat}.conv"
        blk = _Tree()
        if f"{tp}.0.0.weight" in sd and f"{tp}.1.0.weight" in sd:
            # expand(0) + dw(1) + project(2,3)
            blk.conv("expand", sd, f"{tp}.0.0")
            blk.bn("expand_bn", sd, f"{tp}.0.1")
            blk.conv("dw", sd, f"{tp}.1.0")
            blk.bn("dw_bn", sd, f"{tp}.1.1")
            blk.conv("project", sd, f"{tp}.2")
            blk.bn("project_bn", sd, f"{tp}.3")
        else:
            # first block (t=1): dw(0) + project(1,2)
            blk.conv("dw", sd, f"{tp}.0.0")
            blk.bn("dw_bn", sd, f"{tp}.0.1")
            blk.conv("project", sd, f"{tp}.1")
            blk.bn("project_bn", sd, f"{tp}.2")
        t.params[f"block{idx}"] = blk.params
        t.stats[f"block{idx}"] = blk.stats
    t.conv("head", sd, "features.18.0")
    t.bn("head_bn", sd, "features.18.1")
    return t.params, t.stats


def convert_mobilenet_v3(sd: Dict[str, Any], n_blocks: int) -> Tuple[Dict, Dict]:
    t = _Tree()
    t.conv("stem", sd, "features.0.0")
    t.bn("stem_bn", sd, "features.0.1")
    for i in range(n_blocks):
        tp = f"features.{i+1}.block"
        blk = _Tree()
        # torchvision block layout: [expand?][dw][se?][project]; each
        # Conv2dNormActivation is .0 (conv) + .1 (bn); the expand is there
        # where the block has more sub-layers than dw, SE and project
        sub_keys = [k for k in sd if k.startswith(tp + ".")]
        n_sub = 1 + max(int(k[len(tp) + 1:].split(".")[0]) for k in sub_keys)
        has_se = any(".fc1." in k for k in sub_keys)
        pos = 0
        if n_sub > 2 + has_se:
            blk.conv("expand", sd, f"{tp}.{pos}.0")
            blk.bn("expand_bn", sd, f"{tp}.{pos}.1")
            pos += 1
        blk.conv("dw", sd, f"{tp}.{pos}.0")
        blk.bn("dw_bn", sd, f"{tp}.{pos}.1")
        pos += 1
        if has_se:
            blk.conv("se_fc1", sd, f"{tp}.{pos}.fc1")
            blk.conv("se_fc2", sd, f"{tp}.{pos}.fc2")
            pos += 1
        blk.conv("project", sd, f"{tp}.{pos}.0")
        blk.bn("project_bn", sd, f"{tp}.{pos}.1")
        t.params[f"block{i}"] = blk.params
        t.stats[f"block{i}"] = blk.stats
    t.conv("head", sd, f"features.{n_blocks+1}.0")
    t.bn("head_bn", sd, f"features.{n_blocks+1}.1")
    return t.params, t.stats


# the inverted residuals of each of MNASNet's six stacks
MNASNET_STACKS = (3, 3, 3, 2, 4, 1)


def convert_mnasnet(sd: Dict[str, Any]) -> Tuple[Dict, Dict]:
    t = _Tree()
    t.conv("stem", sd, "layers.0")
    t.bn("stem_bn", sd, "layers.1")
    t.conv("sep_dw", sd, "layers.3")
    t.bn("sep_dw_bn", sd, "layers.4")
    t.conv("sep_pw", sd, "layers.6")
    t.bn("sep_pw_bn", sd, "layers.7")
    idx = 0
    for stack, n in zip(range(8, 14), MNASNET_STACKS):
        for j in range(n):
            tp = f"layers.{stack}.{j}.layers"
            blk = _Tree()
            blk.conv("expand", sd, f"{tp}.0")
            blk.bn("expand_bn", sd, f"{tp}.1")
            blk.conv("dw", sd, f"{tp}.3")
            blk.bn("dw_bn", sd, f"{tp}.4")
            blk.conv("project", sd, f"{tp}.6")
            blk.bn("project_bn", sd, f"{tp}.7")
            t.params[f"block{idx}"] = blk.params
            t.stats[f"block{idx}"] = blk.stats
            idx += 1
    t.conv("head", sd, "layers.14")
    t.bn("head_bn", sd, "layers.15")
    return t.params, t.stats


# the torchvision ``features`` index of fire2..fire9 in each SqueezeNet
SQUEEZENET_FIRES = {"1_0": (3, 4, 5, 7, 8, 9, 10, 12), "1_1": (3, 4, 6, 7, 9, 10, 11, 12)}


def convert_squeezenet(sd: Dict[str, Any], version: str) -> Tuple[Dict, Dict]:
    t = _Tree()
    t.conv("conv1", sd, "features.0")
    for n, feat in enumerate(SQUEEZENET_FIRES[version], start=2):
        tp = f"features.{feat}"
        blk = _Tree()
        blk.conv("squeeze", sd, f"{tp}.squeeze")
        blk.conv("expand1x1", sd, f"{tp}.expand1x1")
        blk.conv("expand3x3", sd, f"{tp}.expand3x3")
        t.params[f"fire{n}"] = blk.params
    return t.params, t.stats


def convert_densenet(sd: Dict[str, Any], block_config) -> Tuple[Dict, Dict]:
    t = _Tree()
    t.conv("conv0", sd, "features.conv0")
    t.bn("norm0", sd, "features.norm0")
    for i, n_layers in enumerate(block_config):
        for j in range(n_layers):
            tp = f"features.denseblock{i+1}.denselayer{j+1}"
            blk = _Tree()
            blk.bn("norm1", sd, f"{tp}.norm1")
            blk.conv("conv1", sd, f"{tp}.conv1")
            blk.bn("norm2", sd, f"{tp}.norm2")
            blk.conv("conv2", sd, f"{tp}.conv2")
            t.params[f"dense{i+1}_{j}"] = blk.params
            t.stats[f"dense{i+1}_{j}"] = blk.stats
        if i != len(block_config) - 1:
            t.bn(f"trans{i+1}_norm", sd, f"features.transition{i+1}.norm")
            t.conv(f"trans{i+1}_conv", sd, f"features.transition{i+1}.conv")
    t.bn("norm5", sd, "features.norm5")
    return t.params, t.stats


# blocks of each MobileNetV3 table
MBV3_N = {"mobilenet_v3_large": len(_MBV3_LARGE), "mobilenet_v3_small": len(_MBV3_SMALL)}


def convert_backbone(arch: str, state_dict: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """torchvision state_dict -> (backbone params, backbone batch_stats).
    Classifier-head keys are ignored (the reference strips them,
    model.py:29-41)."""
    sd = {k: v for k, v in state_dict.items()
          if not k.startswith(("fc.", "classifier."))}
    if arch in _RESNET:
        return convert_resnet(sd, *_RESNET[arch])
    if arch in SHUFFLENET_ARCHS:
        return convert_shufflenet(sd)
    if arch == "mobilenet_v2":
        return convert_mobilenet_v2(sd)
    if arch in MBV3_N:
        return convert_mobilenet_v3(sd, MBV3_N[arch])
    if arch in MNASNET_ALPHAS:
        return convert_mnasnet(sd)
    if arch in SQUEEZENET_ARCHS:
        return convert_squeezenet(sd, SQUEEZENET_ARCHS[arch])
    if arch in DENSENET_ARCHS:
        return convert_densenet(sd, DENSENET_ARCHS[arch][0])
    raise ValueError(f"no converter for {arch}")


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
    if stats:   # a BatchNorm-free backbone (squeezenet) has no batch_stats tree
        _merge(tree["state"]["batch_stats"]["backbone"], stats)
    return tree
