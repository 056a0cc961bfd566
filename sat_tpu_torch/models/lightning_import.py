"""Import a reference PyTorch-Lightning SAT checkpoint into the port, ported
from ``sat_tpu/models/lightning_import.py``.

A reference user's deployment artifact is a Lightning ``.ckpt`` holding the
full hparams (including the vocabulary) and the module state_dict (reference:
model.py:142 save_hyperparameters).  This module converts it, as the JAX
package does, into the flax-layout variables tree, and loads that tree into
the port's ``SATModel`` through ``models/jax_import.py``.

Decoder mapping (torch Linear stores (out, in); the tree stores (in, out)):
  embedding.weight                 -> decoder.embedding
  init_lstm.factorize / .init      -> init_factorize / init_proj
  attention.encoder_att/.decoder_att/.f_att -> att_enc / att_dec / f_att
  beta.0                           -> beta
  lstm.weight_ih_l{k}/hh + biases  -> lstm.layer_{k} (same i,f,g,o gate order)
  output.hidden/.context/.output   -> out_hidden / out_context / out_proj

Encoder mapping: the reference encoder is ``nn.Sequential(Normalize,
*backbone_children[, proj_conv])`` (model.py:59-62); the ``encoder.<idx>.*``
keys go back to torchvision's key layout and through
``models/torch_import.py``'s converters: the nine ResNet-family tables
(``resnet`` children 1, 2, 5-8 after Normalize), the four
``shufflenet_v2_*`` ones, ``mobilenet_v2``, both ``mobilenet_v3_*``, both
``squeezenet*`` and the four ``densenet*`` (child 1, ``features``) and the
four ``mnasnet*`` (child 1, ``layers``).  A SqueezeNet's tree has an empty
``batch_stats``, as JAX's importer gives it.

    python -m sat_tpu_torch.models.lightning_import --input ref.ckpt \\
        --output sat.ckpt
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import SATConfig
from .torch_import import convert_backbone

# family -> list of (sequential child index after Normalize, torchvision prefix)
_CHILD_MAPS = {
    "resnet": [("1", "conv1"), ("2", "bn1"), ("5", "layer1"), ("6", "layer2"),
               ("7", "layer3"), ("8", "layer4")],
    "shufflenet": [("1", "conv1"), ("3", "stage2"), ("4", "stage3"),
                   ("5", "stage4"), ("6", "conv5")],
    "single_features": [("1", "features")],   # squeezenet/densenet/mobilenet_v2/v3
    "mnasnet": [("1", "layers")],
}


def _family(arch: str) -> Tuple[str, int]:
    """Returns (child-map key, n_backbone_children incl. skipped non-param ones)."""
    if "resnet" in arch or "resnext" in arch:
        return "resnet", 9
    if "shufflenet" in arch:
        return "shufflenet", 7
    if "mnasnet" in arch:
        return "mnasnet", 2
    return "single_features", 2


def _np(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def split_reference_state_dict(state_dict: Dict[str, Any], arch: str):
    """Split a reference SAT state_dict into (torchvision-keyed encoder sd,
    optional 1x1 proj conv sd, decoder sd)."""
    fam, _ = _family(arch)
    enc_sd, dec_sd, proj = {}, {}, {}
    idx_map = dict(_CHILD_MAPS[fam])
    max_idx = max(int(i) for i in idx_map)
    for k, v in state_dict.items():
        v = _np(v)
        if k.startswith("encoder."):
            rest = k[len("encoder."):]
            idx, sub = rest.split(".", 1)
            if idx in idx_map:
                enc_sd[f"{idx_map[idx]}.{sub}"] = v
            elif int(idx) > max_idx:
                proj[sub] = v             # appended encoder_dim 1x1 conv
        else:
            dec_sd[k] = v
    return enc_sd, proj, dec_sd


def _lin(dec_sd, key, bias=True):
    p = {"w": np.asarray(dec_sd[f"{key}.weight"]).T}
    if bias and f"{key}.bias" in dec_sd:
        p["b"] = np.asarray(dec_sd[f"{key}.bias"])
    return p


def convert_decoder(dec_sd: Dict[str, Any], cfg: SATConfig) -> Dict[str, Any]:
    params: Dict[str, Any] = {
        "embedding": np.asarray(dec_sd["embedding.weight"]),
        "init_factorize": _lin(dec_sd, "init_lstm.factorize"),
        "init_proj": _lin(dec_sd, "init_lstm.init"),
        "att_enc": _lin(dec_sd, "attention.encoder_att", bias=False),
        "att_dec": _lin(dec_sd, "attention.decoder_att", bias=False),
        "f_att": _lin(dec_sd, "attention.f_att", bias=False),
        "beta": _lin(dec_sd, "beta.0"),
        "out_hidden": _lin(dec_sd, "output.hidden", bias=False),
    }
    lstm = {}
    for l in range(cfg.decoder_layers):
        lstm[f"layer_{l}"] = {
            "w_ih": np.asarray(dec_sd[f"lstm.weight_ih_l{l}"]).T,
            "w_hh": np.asarray(dec_sd[f"lstm.weight_hh_l{l}"]).T,
            "b_ih": np.asarray(dec_sd[f"lstm.bias_ih_l{l}"]),
            "b_hh": np.asarray(dec_sd[f"lstm.bias_hh_l{l}"]),
        }
    params["lstm"] = lstm
    if cfg.deep_output:
        params["out_context"] = _lin(dec_sd, "output.context", bias=False)
    if not (cfg.weight_tying and cfg.deep_output):
        params["out_proj"] = _lin(dec_sd, "output.output",
                                  bias=not cfg.weight_tying)
    return params


def config_from_hparams(hparams: Dict[str, Any]) -> SATConfig:
    """Reference hparams dict -> SATConfig (field names match by design)."""
    known = {f.name for f in dataclasses.fields(SATConfig)}
    kw = {}
    for k, v in hparams.items():
        if k == "vocab_itos":
            continue
        if k in known:
            if isinstance(v, list):
                v = tuple(v)
            kw[k] = v
    return SATConfig(**kw)


def reference_tree(ckpt: Dict[str, Any], arch: Optional[str] = None
                   ) -> Tuple[SATConfig, Dict[str, Any]]:
    """A loaded Lightning checkpoint dict -> (cfg, the flax-layout variables
    tree with numpy leaves), as the JAX package's importer builds it."""
    hparams = ckpt.get("hyper_parameters", ckpt.get("hparams", {}))
    cfg = config_from_hparams(dict(hparams))
    arch = arch or cfg.encoder_arch
    enc_sd, proj_sd, dec_sd = split_reference_state_dict(ckpt["state_dict"], arch)
    backbone_params, backbone_stats = convert_backbone(arch, enc_sd)
    enc_params: Dict[str, Any] = {"backbone": backbone_params}
    if proj_sd:
        enc_params["proj"] = {
            "kernel": np.asarray(proj_sd["weight"]).transpose(2, 3, 1, 0),
            "bias": np.asarray(proj_sd["bias"])}
    tree = {"params": {"encoder": enc_params,
                       "decoder": convert_decoder(dec_sd, cfg)},
            "state": {"batch_stats": ({"backbone": backbone_stats}
                                      if backbone_stats else {})}}
    return cfg, tree


def load_reference_checkpoint(path_or_ckpt: Union[str, Dict[str, Any]],
                              arch: Optional[str] = None,
                              device: Union[str, torch.device, None] = None):
    """Lightning .ckpt (path or loaded dict) -> (cfg, model, grid_hw), the
    model in eval mode on ``device`` (``None``: the CUDA card; raises where
    there is none)."""
    from ..utils.platform import resolve_device
    from .jax_import import model_from_jax_tree

    device = resolve_device(device)
    if isinstance(path_or_ckpt, str):
        ckpt = torch.load(path_or_ckpt, map_location="cpu", weights_only=False)
    else:
        ckpt = path_or_ckpt
    cfg, tree = reference_tree(ckpt, arch)
    model = model_from_jax_tree(cfg, tree).to(device)
    return cfg, model, model.grid_hw


def main(argv: Optional[Sequence[str]] = None,
         device: Union[str, torch.device, None] = None) -> None:
    """Convert a reference Lightning .ckpt into a ``SATTPU1`` .ckpt; the
    model is built on ``device`` (the card unless ``device="cpu"``)."""
    import argparse

    from ..train.checkpoints import save_checkpoint
    from .jax_import import model_to_jax_tree

    p = argparse.ArgumentParser(
        description="reference Lightning checkpoint -> SAT-TPU checkpoint")
    p.add_argument("--input", required=True, help="Lightning .ckpt path")
    p.add_argument("--output", required=True, help="SAT-TPU .ckpt path")
    p.add_argument("--arch", default=None,
                   help="override encoder arch (default: from hparams)")
    a = p.parse_args(argv)
    cfg, model, grid = load_reference_checkpoint(a.input, arch=a.arch,
                                                 device=device)
    save_checkpoint(a.output, cfg, dict(model_to_jax_tree(model), step=0, epoch=0))
    print(f"converted {a.input} -> {a.output} "
          f"(arch={cfg.encoder_arch}, vocab={cfg.vocab_size}, grid={grid})")


if __name__ == "__main__":
    main()
