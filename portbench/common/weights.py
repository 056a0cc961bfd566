"""The benchmark's own seeded weights, drawn on the device in two calls.

Every tensor of a configuration (named as the port's ``SATModel``
``state_dict``) is cut from one normal and one uniform draw of the total
size, in a fixed order, so a seed gives the same weights on every run:
convolutions N(0, 1 / fan_in); BatchNorm scale U(0.5, 1.5), bias N(0, 0.1),
running mean N(0, 0.1), running variance U(0.5, 2), as
``chip_smoke.py::randomise_bn`` draws them, so eval-mode BatchNorm is not
the identity; decoder matrices (in, out) and their biases U(+-1/sqrt(in));
the embedding N(0, 1) with the <PAD> row zero."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference import encoders as RE

PAD = 0


def decoder_spec(V: int, E: int, D: int, A: int, H: int) -> List[Tuple[str, Tuple, int]]:
    """(name, shape, fan_in) of the decoder's tensors; fan_in 0 for the
    embedding."""
    lin = lambda name, i, o, bias=True: ([(name + ".w", (i, o), i)]
                                         + ([(name + ".b", (o,), i)] if bias else []))
    out = [("embedding", (V, E), 0)]
    out += lin("init_factorize", D, E) + lin("init_proj", E, 2 * H)
    out += lin("att_enc", D, A, False) + lin("att_dec", H, A, False)
    out += lin("f_att", A, 1, False) + lin("beta", H, D)
    out += [("lstm.layer_0.w_ih", (E + D, 4 * H), H), ("lstm.layer_0.w_hh", (H, 4 * H), H),
            ("lstm.layer_0.b_ih", (4 * H,), H), ("lstm.layer_0.b_hh", (4 * H,), H)]
    out += lin("out_hidden", H, E, False) + lin("out_context", D, E, False)
    out += lin("out_proj", E, V)
    return [("decoder." + n, s, f) for n, s, f in out]


def draw(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every tensor of the configuration ``cfg`` (its ``sat`` block) from
    ``seed``, on ``device``."""
    s = cfg["sat"]
    arch = s["encoder_arch"]
    D = RE.out_channels(arch)
    enc = list(RE.spec(arch))
    dec = decoder_spec(s["vocab_size"], s["embed_dim"], D, s["attention_dim"],
                       s["decoder_dim"])
    sizes = [torch.Size(sh).numel() * (4 if kind == "bn" else 1) for _, kind, sh in enc]
    sizes += [torch.Size(sh).numel() for _, sh, _ in dec]
    g = torch.Generator(device).manual_seed(seed)
    total = sum(sizes)
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    out, at = {}, 0

    def take(shape):
        nonlocal at
        k = torch.Size(shape).numel()
        n, u = normal[at:at + k].view(shape), uniform[at:at + k].view(shape)
        at += k
        return n, u
    for name, kind, shape in enc:
        key = RE.PREFIX + name
        if kind == "conv":
            n, _ = take(shape)
            fan = shape[1] * shape[2] * shape[3]
            out[key + ".weight"] = n * fan ** -0.5
            continue
        n, u = take(shape)
        out[key + ".weight"] = 0.5 + u
        n, _ = take(shape)
        out[key + ".bias"] = 0.1 * n
        n, _ = take(shape)
        out[key + ".running_mean"] = 0.1 * n
        _, u = take(shape)
        out[key + ".running_var"] = 0.5 + 1.5 * u
        out[key + ".num_batches_tracked"] = torch.zeros((), dtype=torch.long,
                                                        device=device)
    for name, shape, fan in dec:
        n, u = take(shape)
        if fan == 0:
            t = n.clone()
            t[PAD] = 0.0
        else:
            t = (2.0 * u - 1.0) * fan ** -0.5
        out[name] = t
    return {k: v.contiguous() for k, v in out.items()}
