"""Export the port's model or a ``SATTPU1`` checkpoint into the reference's
Lightning format, ported from ``sat_tpu/models/lightning_export.py``.

The inverse of ``models/lightning_import.py``: a ``.ckpt`` that the
reference's ``SAT.load_from_checkpoint`` can consume (state_dict keyed by the
reference's module names, model.py:154-199, plus the full hparams dict
including the vocabulary, model.py:142 save_hyperparameters).  It works on
the flax-layout variables tree (``jax_import.model_to_jax_tree`` of a model,
or a checkpoint's tree), so it needs no JAX.

Weight-layout inverses (import conventions in models/torch_import.py):
  flax conv kernel (kH, kW, I/g, O) -> torch (O, I/g, kH, kW)
  flax Linear w (in, out)           -> torch weight (out, in)
  flax BN scale/bias + stats        -> torch weight/bias/running_mean/var
                                       (+ num_batches_tracked zeros)

    python -m sat_tpu_torch.models.lightning_export --input sat.ckpt \\
        --output ref.ckpt
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..config import SATConfig
from .lightning_import import _CHILD_MAPS, _family
from .backbones import DENSENET_ARCHS, MNASNET_ALPHAS, SQUEEZENET_ARCHS
from .torch_import import _RESNET, MBV3_N, MNASNET_STACKS, SHUFFLENET_ARCHS, SQUEEZENET_FIRES


def _host(tree: Any) -> Any:
    """The tree with numpy leaves (tensors moved to the host)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _inv_conv(sd: Dict[str, np.ndarray], torch_key: str, entry: Dict) -> None:
    sd[f"{torch_key}.weight"] = np.asarray(entry["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in entry:
        sd[f"{torch_key}.bias"] = np.asarray(entry["bias"])


def _inv_bn(sd: Dict[str, np.ndarray], torch_key: str, p: Dict, s: Dict) -> None:
    sd[f"{torch_key}.weight"] = np.asarray(p["scale"])
    sd[f"{torch_key}.bias"] = np.asarray(p["bias"])
    sd[f"{torch_key}.running_mean"] = np.asarray(s["mean"])
    sd[f"{torch_key}.running_var"] = np.asarray(s["var"])
    sd[f"{torch_key}.num_batches_tracked"] = np.asarray(0, np.int64)


class _Inv:
    """Mirror of torch_import._Tree that EMITS torch keys from flax trees."""

    def __init__(self, sd: Dict, params: Dict, stats: Optional[Dict]):
        self.sd, self.params, self.stats = sd, params, stats or {}

    def conv(self, flax_name: str, torch_key: str) -> None:
        _inv_conv(self.sd, torch_key, self.params[flax_name])

    def bn(self, flax_name: str, torch_key: str) -> None:
        _inv_bn(self.sd, torch_key, self.params[flax_name],
                self.stats[flax_name])

    def sub(self, flax_name: str) -> "_Inv":
        return _Inv(self.sd, self.params[flax_name],
                    self.stats.get(flax_name))


def _export_resnet(t: _Inv, stage_sizes, bottleneck: bool) -> None:
    t.conv("conv1", "conv1")
    t.bn("bn1", "bn1")
    n_convs = 3 if bottleneck else 2
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            tp, blk = f"layer{i+1}.{j}", t.sub(f"layer{i+1}_{j}")
            for k in range(1, n_convs + 1):
                blk.conv(f"conv{k}", f"{tp}.conv{k}")
                blk.bn(f"bn{k}", f"{tp}.bn{k}")
            if "down_conv" in blk.params:
                blk.conv("down_conv", f"{tp}.downsample.0")
                blk.bn("down_bn", f"{tp}.downsample.1")


def _export_shufflenet(t: _Inv) -> None:
    t.conv("conv1", "conv1.0")
    t.bn("bn1", "conv1.1")
    for s in (2, 3, 4):
        reps = len([k for k in t.params if k.startswith(f"stage{s}_")])
        for j in range(reps):
            tp, blk = f"stage{s}.{j}", t.sub(f"stage{s}_{j}")
            if "b1_dw" in blk.params:
                blk.conv("b1_dw", f"{tp}.branch1.0")
                blk.bn("b1_dwbn", f"{tp}.branch1.1")
                blk.conv("b1_pw", f"{tp}.branch1.2")
                blk.bn("b1_pwbn", f"{tp}.branch1.3")
            blk.conv("b2_pw1", f"{tp}.branch2.0")
            blk.bn("b2_pw1bn", f"{tp}.branch2.1")
            blk.conv("b2_dw", f"{tp}.branch2.3")
            blk.bn("b2_dwbn", f"{tp}.branch2.4")
            blk.conv("b2_pw2", f"{tp}.branch2.5")
            blk.bn("b2_pw2bn", f"{tp}.branch2.6")
    t.conv("conv5", "conv5.0")
    t.bn("bn5", "conv5.1")


def _export_mobilenet_v2(t: _Inv) -> None:
    t.conv("stem", "features.0.0")
    t.bn("stem_bn", "features.0.1")
    for feat in range(1, 18):
        tp, blk = f"features.{feat}.conv", t.sub(f"block{feat-1}")
        if "expand" in blk.params:
            blk.conv("expand", f"{tp}.0.0")
            blk.bn("expand_bn", f"{tp}.0.1")
            blk.conv("dw", f"{tp}.1.0")
            blk.bn("dw_bn", f"{tp}.1.1")
            blk.conv("project", f"{tp}.2")
            blk.bn("project_bn", f"{tp}.3")
        else:
            blk.conv("dw", f"{tp}.0.0")
            blk.bn("dw_bn", f"{tp}.0.1")
            blk.conv("project", f"{tp}.1")
            blk.bn("project_bn", f"{tp}.2")
    t.conv("head", "features.18.0")
    t.bn("head_bn", "features.18.1")


def _export_mobilenet_v3(t: _Inv, n_blocks: int) -> None:
    t.conv("stem", "features.0.0")
    t.bn("stem_bn", "features.0.1")
    for i in range(n_blocks):
        tp, blk = f"features.{i+1}.block", t.sub(f"block{i}")
        pos = 0
        if "expand" in blk.params:
            blk.conv("expand", f"{tp}.{pos}.0")
            blk.bn("expand_bn", f"{tp}.{pos}.1")
            pos += 1
        blk.conv("dw", f"{tp}.{pos}.0")
        blk.bn("dw_bn", f"{tp}.{pos}.1")
        pos += 1
        if "se_fc1" in blk.params:
            blk.conv("se_fc1", f"{tp}.{pos}.fc1")
            blk.conv("se_fc2", f"{tp}.{pos}.fc2")
            pos += 1
        blk.conv("project", f"{tp}.{pos}.0")
        blk.bn("project_bn", f"{tp}.{pos}.1")
    t.conv("head", f"features.{n_blocks+1}.0")
    t.bn("head_bn", f"features.{n_blocks+1}.1")


def _export_mnasnet(t: _Inv) -> None:
    t.conv("stem", "layers.0")
    t.bn("stem_bn", "layers.1")
    t.conv("sep_dw", "layers.3")
    t.bn("sep_dw_bn", "layers.4")
    t.conv("sep_pw", "layers.6")
    t.bn("sep_pw_bn", "layers.7")
    idx = 0
    for stack, n in zip(range(8, 14), MNASNET_STACKS):
        for j in range(n):
            tp, blk = f"layers.{stack}.{j}.layers", t.sub(f"block{idx}")
            blk.conv("expand", f"{tp}.0")
            blk.bn("expand_bn", f"{tp}.1")
            blk.conv("dw", f"{tp}.3")
            blk.bn("dw_bn", f"{tp}.4")
            blk.conv("project", f"{tp}.6")
            blk.bn("project_bn", f"{tp}.7")
            idx += 1
    t.conv("head", "layers.14")
    t.bn("head_bn", "layers.15")


def _export_squeezenet(t: _Inv, version: str) -> None:
    t.conv("conv1", "features.0")
    for n, feat in enumerate(SQUEEZENET_FIRES[version], start=2):
        tp, blk = f"features.{feat}", t.sub(f"fire{n}")
        blk.conv("squeeze", f"{tp}.squeeze")
        blk.conv("expand1x1", f"{tp}.expand1x1")
        blk.conv("expand3x3", f"{tp}.expand3x3")


def _export_densenet(t: _Inv, block_config) -> None:
    t.conv("conv0", "features.conv0")
    t.bn("norm0", "features.norm0")
    for i, n_layers in enumerate(block_config):
        for j in range(n_layers):
            tp = f"features.denseblock{i+1}.denselayer{j+1}"
            blk = t.sub(f"dense{i+1}_{j}")
            blk.bn("norm1", f"{tp}.norm1")
            blk.conv("conv1", f"{tp}.conv1")
            blk.bn("norm2", f"{tp}.norm2")
            blk.conv("conv2", f"{tp}.conv2")
        if i != len(block_config) - 1:
            t.bn(f"trans{i+1}_norm", f"features.transition{i+1}.norm")
            t.conv(f"trans{i+1}_conv", f"features.transition{i+1}.conv")
    t.bn("norm5", "features.norm5")


def export_backbone(arch: str, params: Dict, stats: Optional[Dict]
                    ) -> Dict[str, np.ndarray]:
    """Flax backbone (params, batch_stats) -> torchvision-keyed state_dict;
    the exact inverse of ``torch_import.convert_backbone``."""
    sd: Dict[str, np.ndarray] = {}
    t = _Inv(sd, params, stats)
    if arch in _RESNET:
        _export_resnet(t, *_RESNET[arch])
    elif arch in SHUFFLENET_ARCHS:
        _export_shufflenet(t)
    elif arch == "mobilenet_v2":
        _export_mobilenet_v2(t)
    elif arch in MBV3_N:
        _export_mobilenet_v3(t, MBV3_N[arch])
    elif arch in MNASNET_ALPHAS:
        _export_mnasnet(t)
    elif arch in SQUEEZENET_ARCHS:
        _export_squeezenet(t, SQUEEZENET_ARCHS[arch])
    elif arch in DENSENET_ARCHS:
        _export_densenet(t, DENSENET_ARCHS[arch][0])
    else:
        raise ValueError(f"no exporter for {arch}")
    return sd


def export_decoder(dec: Dict[str, Any], cfg: SATConfig) -> Dict[str, np.ndarray]:
    """Inverse of lightning_import.convert_decoder (reference module names,
    model.py:154-199)."""
    sd: Dict[str, np.ndarray] = {}

    def lin(name, p):
        sd[f"{name}.weight"] = np.asarray(p["w"]).T
        if "b" in p:
            sd[f"{name}.bias"] = np.asarray(p["b"])

    sd["embedding.weight"] = np.asarray(dec["embedding"])
    lin("init_lstm.factorize", dec["init_factorize"])
    lin("init_lstm.init", dec["init_proj"])
    lin("attention.encoder_att", dec["att_enc"])
    lin("attention.decoder_att", dec["att_dec"])
    lin("attention.f_att", dec["f_att"])
    lin("beta.0", dec["beta"])
    lin("output.hidden", dec["out_hidden"])
    if cfg.deep_output:
        lin("output.context", dec["out_context"])
    if cfg.weight_tying and cfg.deep_output:
        # the reference shares the tensors (model.py:198-199); its state_dict
        # still carries the tied weight under the output module's name
        sd["output.output.weight"] = np.asarray(dec["embedding"])
    else:
        lin("output.output", dec["out_proj"])
    for lname, lp in dec["lstm"].items():
        l = lname.split("_")[1]
        sd[f"lstm.weight_ih_l{l}"] = np.asarray(lp["w_ih"]).T
        sd[f"lstm.weight_hh_l{l}"] = np.asarray(lp["w_hh"]).T
        sd[f"lstm.bias_ih_l{l}"] = np.asarray(lp["b_ih"])
        sd[f"lstm.bias_hh_l{l}"] = np.asarray(lp["b_hh"])
    return sd


def build_lightning_checkpoint(cfg: SATConfig, variables: Dict[str, Any],
                               step: int = 0, epoch: int = 0
                               ) -> Dict[str, Any]:
    """(cfg, flax-layout variables tree with numpy or tensor leaves) ->
    reference-format Lightning checkpoint dict (numpy-valued; ``main``
    saves it with ``torch.save``)."""
    host = _host(variables)
    enc = host["params"]["encoder"]
    enc_stats = (host.get("state", {}).get("batch_stats", {}) or {}).get(
        "backbone")
    tv_sd = export_backbone(cfg.encoder_arch, enc["backbone"], enc_stats)

    # torchvision keys -> the reference's nn.Sequential child indices
    # (inverse of lightning_import.split_reference_state_dict)
    fam, _ = _family(cfg.encoder_arch)
    idx_map = {prefix: idx for idx, prefix in _CHILD_MAPS[fam]}
    max_idx = max(int(i) for i in idx_map.values())
    sd: Dict[str, np.ndarray] = {}
    for k, v in tv_sd.items():
        top, rest = k.split(".", 1)
        sd[f"encoder.{idx_map[top]}.{rest}"] = v
    if "proj" in enc:  # appended 1x1 encoder_dim conv (model.py:50-53)
        sd[f"encoder.{max_idx + 1}.weight"] = np.asarray(
            enc["proj"]["kernel"]).transpose(3, 2, 0, 1)
        sd[f"encoder.{max_idx + 1}.bias"] = np.asarray(enc["proj"]["bias"])

    sd.update(export_decoder(host["params"]["decoder"], cfg))

    hparams = cfg.to_dict()
    if cfg.vocab_stoi:
        hparams["vocab_itos"] = {str(i): w for w, i in cfg.vocab_stoi.items()}
    return {
        "state_dict": sd,
        "hyper_parameters": hparams,
        "epoch": epoch,
        "global_step": step,
        "pytorch-lightning_version": "1.4.0",
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Convert a SAT-TPU .ckpt into a reference-loadable Lightning .ckpt
    (a file conversion on the host: no device is involved)."""
    import argparse

    from ..train.checkpoints import load_checkpoint

    p = argparse.ArgumentParser(
        description="SAT-TPU checkpoint -> reference Lightning checkpoint")
    p.add_argument("--input", required=True, help="SAT-TPU .ckpt path")
    p.add_argument("--output", required=True, help="Lightning .ckpt path")
    a = p.parse_args(argv)
    cfg, raw = load_checkpoint(a.input)
    ckpt = build_lightning_checkpoint(
        cfg, {"params": raw["params"], "state": raw.get("state", {})},
        step=int(raw.get("step", 0)), epoch=int(raw.get("epoch", 0)))
    ckpt["state_dict"] = {
        k: torch.from_numpy((np.asarray(v, np.float32)
                             if v.dtype != np.int64 else v).copy())
        for k, v in ckpt["state_dict"].items()}
    torch.save(ckpt, a.output)
    print(f"exported {a.input} -> {a.output} (arch={cfg.encoder_arch}, "
          f"{len(ckpt['state_dict'])} tensors)")


if __name__ == "__main__":
    main()
