"""ShuffleNetV2 backbones of ``sat_tpu/models/backbones.py`` as torch modules.

Submodule names follow the JAX parameter paths (``conv1``, ``bn1``,
``stage2_0.b1_dw``, ``conv5``, ...) so ``models/jax_import.py`` can map the
flax weights by name.  The modules run NCHW, PyTorch's layout; the encoder
converts at its boundary.  BatchNorm follows flax's (``BatchNorm`` below),
in eval and in train mode; the other 22 encoders of
``config.ENCODER_ARCHS`` come later.

The JAX package folds the input normalisation into ``conv1``
(``FoldedStemConv``) and permutes channels to avoid TPU relayouts
(``models/shufflenet_folded.py``, ``models/packed_stem.py``).  Those are the
same math as normalise -> conv1, which is what runs here."""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn


FLAX_MOMENTUM = 0.9
# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class BatchNorm(nn.BatchNorm2d):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` on NCHW.

    Eval mode normalises with the running statistics, as torch does.  Train
    mode follows flax step for step:
    * the batch statistics are one-pass, ``var = max(E[x^2] - E[x]^2, 0)``:
      at float32 that differs from a two-pass variance by far more than
      rounding where a channel's mean dwarfs its spread, as it does on the
      few samples of a late stage's small map;
    * ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias``;
    * ``running = 0.9 * running + 0.1 * batch``, with the BIASED variance,
      where ``nn.BatchNorm2d`` takes the unbiased one (a factor n / (n - 1),
      1.14 at a 2 x 2 map of two images).

    Under float32 running statistics, a lower-precision input (bf16
    training casts the weights, not the statistics) is normalised as flax
    does it: the statistics at float32, the whole normalisation in float32
    on the promoted input, weight and bias, and one rounding back to the
    input's type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training and x.dtype == self.running_mean.dtype:
            return super().forward(x)
        xs = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
        if self.training:
            mean = xs.mean(dim=(0, 2, 3))
            var = torch.clamp((xs * xs).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                for run, new in ((self.running_mean, mean), (self.running_var, var)):
                    run.mul_(FLAX_MOMENTUM).add_(new, alpha=1.0 - FLAX_MOMENTUM)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xs - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def _bn(ch: int) -> BatchNorm:
    return BatchNorm(ch, eps=1e-5)


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, groups=groups,
                     bias=False)


class ShuffleUnit(nn.Module):
    """Stride 1: split channels, first half = left (identity), second half
    through the right branch.  Stride 2: both branches see all channels.
    The output riffles the branches: out[2i] = left[i], out[2i+1] = right[i]."""

    def __init__(self, in_ch: int, out_ch: int, stride: int):
        super().__init__()
        self.stride = stride
        branch = out_ch // 2
        right_in = in_ch // 2 if stride == 1 else in_ch
        if stride != 1:
            self.b1_dw = _conv(in_ch, in_ch, 3, 2, groups=in_ch)
            self.b1_dwbn = _bn(in_ch)
            self.b1_pw = _conv(in_ch, branch, 1)
            self.b1_pwbn = _bn(branch)
        self.b2_pw1 = _conv(right_in, branch, 1)
        self.b2_pw1bn = _bn(branch)
        self.b2_dw = _conv(branch, branch, 3, stride, groups=branch)
        self.b2_dwbn = _bn(branch)
        self.b2_pw2 = _conv(branch, branch, 1)
        self.b2_pw2bn = _bn(branch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            left, right = x.chunk(2, dim=1)
        else:
            left = F.relu(self.b1_pwbn(self.b1_pw(self.b1_dwbn(self.b1_dw(x)))))
            right = x
        y = F.relu(self.b2_pw1bn(self.b2_pw1(right)))
        y = self.b2_dwbn(self.b2_dw(y))
        y = F.relu(self.b2_pw2bn(self.b2_pw2(y)))
        b, c, h, w = left.shape
        return torch.stack([left, y], dim=2).reshape(b, 2 * c, h, w)


class ShuffleNetV2(nn.Module):
    def __init__(self, stage_out: Sequence[int]):
        super().__init__()
        self.out_channels = stage_out[3]
        self.conv1 = _conv(3, 24, 3, 2)
        self.bn1 = _bn(24)
        cin = 24
        for s, (out_ch, repeats) in enumerate(zip(stage_out[:3], (4, 8, 4))):
            for j in range(repeats):
                self.add_module(f"stage{s + 2}_{j}",
                                ShuffleUnit(cin, out_ch, 2 if j == 0 else 1))
                cin = out_ch
        self.stage_names = [n for n, _ in self.named_children()
                            if n.startswith("stage")]
        self.conv5 = _conv(cin, stage_out[3], 1)
        self.bn5 = _bn(stage_out[3])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 3, H, W), already normalised -> (B, C, H/32, W/32)."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.stage_names:
            x = getattr(self, name)(x)
        return F.relu(self.bn5(self.conv5(x)))


_STAGES: Dict[str, Sequence[int]] = {
    "shufflenet_v2_x0_5": (48, 96, 192, 1024),
    "shufflenet_v2_x1_0": (116, 232, 464, 1024),
    "shufflenet_v2_x1_5": (176, 352, 704, 1024),
    "shufflenet_v2_x2_0": (244, 488, 976, 2048),
}

BACKBONES = {name: (lambda st=st: ShuffleNetV2(st)) for name, st in _STAGES.items()}


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default initialisers, in place, drawing from ``generator``:
    conv kernels ``lecun_normal`` (a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in), conv biases zero, BatchNorm
    scale 1, bias 0, running mean 0 and variance 1."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()           # in / groups x kh x kw
            std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.reset_parameters()
    return module
