"""Carry the JAX package's variables tree into the port's modules, and the
port's model back into that tree (``model_to_jax_tree``).

The tree is ``{"params": {"encoder": ..., "decoder": ...},
"state": {"batch_stats": ...}}`` with numpy arrays or CPU tensors as leaves,
as ``train/checkpoints.py`` reads it or a test hands it over from JAX.

* flax conv kernels ``HWIO`` become torch ``OIHW``; a depthwise ``(3, 3, 1, C)``
  kernel becomes ``(C, 1, 3, 3)`` for ``groups=C`` by the same transpose;
* flax BatchNorm ``scale``/``bias`` and the running ``mean``/``var`` fill
  ``nn.BatchNorm2d`` (eps 1e-5 on both sides);
* the decoder dict becomes a ``ParamTree`` as it is: linear weights stay
  ``(in, out)``."""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from ..config import SATConfig
from .decoder import ParamTree
from .encoder import SATEncoder, encoder_from_config, probe_encoder


def _tensor(x: Any) -> torch.Tensor:
    """A contiguous copy: a transposed array (a converted torch Linear
    weight) keeps no strides that would change the products' rounding."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone(memory_format=torch.contiguous_format)
    return torch.from_numpy(np.array(x, order="C"))


def _modules(tree: Dict[str, Any], prefix: str = ""
             ) -> Iterator[Tuple[str, Dict[str, Any]]]:
    """(dotted path, leaf dict) of every flax module that owns leaves."""
    leaves = {k: v for k, v in tree.items() if not isinstance(v, dict)}
    if leaves:
        yield prefix.rstrip("."), leaves
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _modules(v, prefix + k + ".")


@torch.no_grad()
def load_encoder_weights(encoder: SATEncoder, params: Dict[str, Any],
                         batch_stats: Dict[str, Any]) -> SATEncoder:
    """Copy flax encoder params + batch stats into ``encoder``; every torch
    parameter and buffer must be filled exactly once."""
    filled = set()
    stats = dict(_modules(batch_stats))
    for path, leaves in _modules(params):
        mod = encoder.get_submodule(path)
        if isinstance(mod, nn.Conv2d):
            mod.weight.copy_(_tensor(leaves["kernel"]).permute(3, 2, 0, 1))
            filled.add(path + ".weight")
            if "bias" in leaves:
                mod.bias.copy_(_tensor(leaves["bias"]))
                filled.add(path + ".bias")
        elif isinstance(mod, nn.BatchNorm2d):
            mod.weight.copy_(_tensor(leaves["scale"]))
            mod.bias.copy_(_tensor(leaves["bias"]))
            mod.running_mean.copy_(_tensor(stats[path]["mean"]))
            mod.running_var.copy_(_tensor(stats[path]["var"]))
            filled.update(path + s for s in (".weight", ".bias",
                                             ".running_mean", ".running_var"))
        else:
            raise ValueError(f"no torch counterpart for flax module {path}")
    wanted = {k for k in encoder.state_dict() if not k.endswith("num_batches_tracked")}
    if wanted != filled:
        raise ValueError(f"encoder weights do not match: missing "
                         f"{sorted(wanted - filled)[:5]}, extra "
                         f"{sorted(filled - wanted)[:5]}")
    return encoder


def decoder_from_jax(params: Dict[str, Any]) -> ParamTree:
    """The decoder param dict as a ParamTree (layouts unchanged)."""
    def conv(t):
        return {k: conv(v) if isinstance(v, dict) else _tensor(v)
                for k, v in t.items()}
    return ParamTree(conv(params))


def model_from_jax_tree(cfg: SATConfig, tree: Dict[str, Any]):
    """SATModel (on the CPU, eval mode) from a JAX variables tree."""
    from .model import SATModel

    _, grid = probe_encoder(cfg)
    encoder = load_encoder_weights(encoder_from_config(cfg),
                                   tree["params"]["encoder"],
                                   tree["state"]["batch_stats"])
    decoder = decoder_from_jax(tree["params"]["decoder"])
    return SATModel(cfg, grid, encoder, decoder).eval()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _nest(tree: Dict[str, Any], path: str, leaves: Dict[str, Any]) -> None:
    node = tree
    for k in path.split("."):
        node = node.setdefault(k, {})
    node.update(leaves)


def encoder_to_jax(encoder: SATEncoder) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, batch_stats) of the encoder in flax's layout: conv kernels
    ``HWIO``, BatchNorm ``scale``/``bias`` and running ``mean``/``var``."""
    params, stats = {}, {}
    for path, mod in encoder.named_modules():
        if isinstance(mod, nn.Conv2d):
            leaves = {"kernel": _np(mod.weight.permute(2, 3, 1, 0))}
            if mod.bias is not None:
                leaves["bias"] = _np(mod.bias)
            _nest(params, path, leaves)
        elif isinstance(mod, nn.BatchNorm2d):
            _nest(params, path, {"scale": _np(mod.weight),
                                 "bias": _np(mod.bias)})
            _nest(stats, path, {"mean": _np(mod.running_mean),
                                "var": _np(mod.running_var)})
    return params, stats


def decoder_to_jax(decoder: ParamTree) -> Dict[str, Any]:
    """The decoder's ParamTree as the JAX param dict (layouts unchanged)."""
    tree = {k: _np(v) for k, v in decoder.named_parameters(recurse=False)}
    tree.update({k: decoder_to_jax(m) for k, m in decoder.named_children()})
    return tree


def model_to_jax_tree(model) -> Dict[str, Any]:
    """The inverse of ``model_from_jax_tree``: ``{"params": {"encoder",
    "decoder"}, "state": {"batch_stats"}}`` with numpy leaves."""
    enc_params, stats = encoder_to_jax(model.encoder)
    return {"params": {"encoder": enc_params,
                       "decoder": decoder_to_jax(model.decoder)},
            "state": {"batch_stats": stats}}
