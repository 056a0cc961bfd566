"""The encoder zoo of ``sat_tpu/models/backbones.py`` as torch modules: the
ResNet family, ShuffleNetV2, MobileNetV2 / V3, MNASNet, SqueezeNet and
DenseNet, all 26 archs of ``config.ENCODER_ARCHS``.

Submodule names follow the JAX parameter paths (``conv1``, ``bn1``,
``layer2_0.conv3``, ``layer2_0.down_bn``, ``stage2_0.b1_dw``, ``conv5``,
``stem``, ``stem_bn``, ``block3.expand``, ``block3.dw_bn``,
``block3.se_fc1``, ``sep_pw``, ``head_bn``, ``fire2.expand3x3``,
``conv0``, ``dense2_5.norm1``, ``trans1_conv``, ``norm5``, ...) so
``models/jax_import.py`` can map the flax weights by name.  The modules run
NCHW, PyTorch's layout; the encoder converts at its boundary.  BatchNorm
follows flax's (``BatchNorm`` below), in eval and in train mode.

The JAX package folds the input normalisation into the stem conv
(``FoldedStemConv``) and permutes channels to avoid TPU relayouts
(``models/shufflenet_folded.py``, ``models/packed_stem.py``).  Those are the
same math as normalise -> stem conv, which is what runs here."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import ONE_RANK, Mesh


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
    input's type.

    With ``mesh`` set (``batch_stats_over``) and more than one rank, train
    mode takes the statistics of the global batch, as JAX's GSPMD step
    does: ``sum x``, ``sum x^2`` and the count are summed over every rank
    through autograd (a finetuned encoder backpropagates through them), so
    the running statistics move alike on every rank."""

    mesh = ONE_RANK

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training and x.dtype == self.running_mean.dtype:
            return super().forward(x)
        xs = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
        if self.training and self.mesh.size > 1:
            count = torch.full((1,), xs.numel() // xs.shape[1], dtype=xs.dtype,
                               device=xs.device)
            sums = self.mesh.sum(torch.cat([xs.sum(dim=(0, 2, 3)),
                                            (xs * xs).sum(dim=(0, 2, 3)), count]))
            c = xs.shape[1]
            mean = sums[:c] / sums[-1]
            var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
        elif self.training:
            mean = xs.mean(dim=(0, 2, 3))
            var = torch.clamp((xs * xs).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        if self.training:
            with torch.no_grad():
                for run, new in ((self.running_mean, mean), (self.running_var, var)):
                    run.mul_(FLAX_MOMENTUM).add_(new, alpha=1.0 - FLAX_MOMENTUM)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xs - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


@contextlib.contextmanager
def batch_stats_over(module: nn.Module, mesh: Mesh) -> Iterator[None]:
    """Within the block, every ``BatchNorm`` of ``module`` in train mode
    takes the statistics of the global batch over ``mesh``'s ranks."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.mesh = mesh
    try:
        yield
    finally:
        for m in bns:
            m.mesh = ONE_RANK


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

class BasicBlock(nn.Module):
    """Two 3 x 3 convs; a 1 x 1 projection of the identity where the stride
    or the width changes."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = _bn(planes)
        self.out_channels = planes
        if stride != 1 or cin != planes:
            self.down_conv = _conv(cin, planes, 1, stride)
            self.down_bn = _bn(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = self.down_bn(self.down_conv(x)) if hasattr(self, "down_conv") else x
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    """1 x 1 -> 3 x 3 (strided, grouped) -> 1 x 1 to 4 x planes, with
    width = int(planes * base_width / 64) * groups (ResNeXt, Wide ResNet)."""

    def __init__(self, cin: int, planes: int, stride: int = 1, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * 4
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = _bn(width)
        self.conv2 = _conv(width, width, 3, stride, groups=groups)
        self.bn2 = _bn(width)
        self.conv3 = _conv(width, out, 1)
        self.bn3 = _bn(out)
        self.out_channels = out
        if stride != 1 or cin != out:
            self.down_conv = _conv(cin, out, 1, stride)
            self.down_bn = _bn(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = self.down_bn(self.down_conv(x)) if hasattr(self, "down_conv") else x
        return F.relu(y + identity)


class ResNet(nn.Module):
    """Stem (7 x 7 / 2 conv, padding 3, BN, ReLU, 3 x 3 / 2 max-pool with
    padding 1), then four stages of ``stage_sizes`` blocks at 64, 128, 256
    and 512 planes, the first block of stages 2-4 at stride 2; blocks are
    ``layer{i}_{j}``.  JAX's stem folds the normalisation into conv1
    (``FoldedStemConv``), the same math, exact at the borders."""

    def __init__(self, stage_sizes: Sequence[int], bottleneck: bool = False,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = _bn(64)
        cin = 64
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                planes = 64 * 2 ** i
                blk = (Bottleneck(cin, planes, stride, groups, base_width)
                       if bottleneck else BasicBlock(cin, planes, stride))
                self.add_module(f"layer{i + 1}_{j}", blk)
                cin = blk.out_channels
        self.block_names = [n for n, _ in self.named_children()
                            if n.startswith("layer")]
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 3, H, W), already normalised -> (B, C, H/32, W/32)."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x


# (stage sizes, bottleneck, groups, base width) of JAX's BACKBONES registry
RESNET_ARCHS: Dict[str, Tuple[Sequence[int], bool, int, int]] = {
    "resnet18": ((2, 2, 2, 2), False, 1, 64),
    "resnet34": ((3, 4, 6, 3), False, 1, 64),
    "resnet50": ((3, 4, 6, 3), True, 1, 64),
    "resnet101": ((3, 4, 23, 3), True, 1, 64),
    "resnet152": ((3, 8, 36, 3), True, 1, 64),
    "resnext50_32x4d": ((3, 4, 6, 3), True, 32, 4),
    "resnext101_32x8d": ((3, 4, 23, 3), True, 32, 8),
    "wide_resnet50_2": ((3, 4, 6, 3), True, 1, 128),
    "wide_resnet101_2": ((3, 4, 23, 3), True, 1, 128),
}


def hswish(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``x * relu6(x + 3) / 6``, not ``F.hardswish``, as XLA compiles
    it: the division by 6 is a product with float32's 1/6, and under bf16
    each operation rounds (bit for bit with JAX's jitted function on the
    CPU, ``tests/test_torch_mobilenet.py``)."""
    return x * F.relu6(x + 3.0) * (1.0 / 6.0)


def hsigmoid(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``relu6(x + 3) / 6``, compiled as ``hswish``."""
    return F.relu6(x + 3.0) * (1.0 / 6.0)


def _make_divisible(v: float) -> int:
    """``v`` rounded to a multiple of 8, at least 8, and up where rounding
    loses more than 10 %: JAX's ``_make_divisible`` and ``_round8``."""
    new_v = max(8, int(v + 4) // 8 * 8)
    if new_v < 0.9 * v:
        new_v += 8
    return new_v


class InvertedResidual(nn.Module):
    """1 x 1 ``expand`` to ``hidden`` channels (where the ratio is not 1, or
    for MobileNetV3 where the width changes), a k x k depthwise ``dw`` at
    ``stride``, optional squeeze-excite (``se_fc1`` -> ReLU -> ``se_fc2`` ->
    hard-sigmoid, on the mean over H and W), a 1 x 1 ``project``; the
    input added where the stride is 1 and the width stays.  JAX's
    ``InvertedResidual`` (MobileNetV2, MNASNet) and ``MobileNetV3Block``
    are this block with ``hidden`` given."""

    def __init__(self, cin: int, out: int, stride: int, hidden: int,
                 kernel: int = 3, use_se: bool = False,
                 act: Callable[[torch.Tensor], torch.Tensor] = F.relu6):
        super().__init__()
        self.act = act
        self.use_res = stride == 1 and cin == out
        if hidden != cin:
            self.expand = _conv(cin, hidden, 1)
            self.expand_bn = _bn(hidden)
        self.dw = _conv(hidden, hidden, kernel, stride, groups=hidden)
        self.dw_bn = _bn(hidden)
        if use_se:
            se = _make_divisible(hidden // 4)
            self.se_fc1 = nn.Conv2d(hidden, se, 1)
            self.se_fc2 = nn.Conv2d(se, hidden, 1)
        self.project = _conv(hidden, out, 1)
        self.project_bn = _bn(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if hasattr(self, "expand"):
            y = self.act(self.expand_bn(self.expand(y)))
        y = self.act(self.dw_bn(self.dw(y)))
        if hasattr(self, "se_fc1"):
            # a bf16 mean sums in float32 and rounds once, as jnp.mean
            s = y.mean(dim=(2, 3), keepdim=True)
            s = self.se_fc2(F.relu(self.se_fc1(s)))
            y = y * hsigmoid(s)
        y = self.project_bn(self.project(y))
        return x + y if self.use_res else y


class _Blocks(nn.Module):
    """The 3 x 3 / 2 ``stem`` (padding 1) -> BN -> ``act``, ``block{i}`` in
    order, the 1 x 1 ``head`` -> BN -> ``act``."""

    def __init__(self, stem: int, act: Callable[[torch.Tensor], torch.Tensor]):
        super().__init__()
        self.stem = _conv(3, stem, 3, 2)
        self.stem_bn = _bn(stem)
        self.act = act

    def _finish(self, cin: int, head: int) -> None:
        self.block_names = [n for n, _ in self.named_children()
                            if n.startswith("block")]
        self.head = _conv(cin, head, 1)
        self.head_bn = _bn(head)
        self.out_channels = head

    def _after_stem(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 3, H, W), already normalised -> (B, C, H/32, W/32)."""
        x = self._after_stem(self.act(self.stem_bn(self.stem(x))))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.act(self.head_bn(self.head(x)))


# (expand ratio, out, repeats, stride) of JAX's MobileNetV2.settings
_MBV2 = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
         (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


class MobileNetV2(_Blocks):
    """Stem 32 -> 17 inverted residuals (ReLU6) -> head 1280 -> ReLU6."""

    def __init__(self):
        super().__init__(32, F.relu6)
        cin, idx = 32, 0
        for t, ch, n, s in _MBV2:
            for j in range(n):
                hidden = _make_divisible(cin * t) if t != 1 else cin
                self.add_module(f"block{idx}", InvertedResidual(
                    cin, ch, s if j == 0 else 1, hidden))
                cin, idx = ch, idx + 1
        self._finish(cin, 1280)


# (kernel, expanded, out, SE, hard-swish, stride) of JAX's tables
_MBV3_LARGE = (
    (3, 16, 16, False, False, 1), (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1), (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1), (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2), (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1), (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1), (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2), (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1))
_MBV3_SMALL = (
    (3, 16, 16, True, False, 2), (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1), (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1), (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1), (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2), (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1))


class MobileNetV3(_Blocks):
    """Stem 16 -> hard-swish, the table's blocks (ReLU or hard-swish, SE
    where marked), head ``last`` (960 large, 576 small) -> hard-swish."""

    def __init__(self, settings: Sequence[Tuple[int, int, int, bool, bool, int]],
                 last: int):
        super().__init__(16, hswish)
        cin = 16
        for i, (k, e, c, se, hs, s) in enumerate(settings):
            self.add_module(f"block{i}", InvertedResidual(
                cin, c, s, e, k, se, hswish if hs else F.relu))
            cin = c
        self._finish(cin, last)


class MNASNet(_Blocks):
    """Stem -> ReLU, the separable ``sep_dw`` -> BN -> ReLU -> ``sep_pw``
    -> BN, six stacks of inverted residuals (ReLU, kernels 3 and 5), head
    1280 -> ReLU; widths ``d * alpha`` rounded as JAX's ``_round8`` (which
    is ``_make_divisible``)."""

    def __init__(self, alpha: float):
        d = [_make_divisible(v * alpha) for v in (32, 16, 24, 40, 80, 96, 192, 320)]
        super().__init__(d[0], F.relu)
        self.sep_dw = _conv(d[0], d[0], 3, groups=d[0])
        self.sep_dw_bn = _bn(d[0])
        self.sep_pw = _conv(d[0], d[1], 1)
        self.sep_pw_bn = _bn(d[1])
        cin, idx = d[1], 0
        # (expand ratio, kernel, out, repeats, stride)
        for t, k, ch, n, s in ((3, 3, d[2], 3, 2), (3, 5, d[3], 3, 2),
                               (6, 5, d[4], 3, 2), (6, 3, d[5], 2, 1),
                               (6, 5, d[6], 4, 2), (6, 3, d[7], 1, 1)):
            for j in range(n):
                self.add_module(f"block{idx}", InvertedResidual(
                    cin, ch, s if j == 0 else 1, _make_divisible(cin * t), k,
                    act=F.relu))
                cin, idx = ch, idx + 1
        self._finish(cin, 1280)

    def _after_stem(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.sep_dw_bn(self.sep_dw(x)))
        return self.sep_pw_bn(self.sep_pw(x))


class Fire(nn.Module):
    """1 x 1 ``squeeze`` -> ReLU, then ``expand1x1`` and ``expand3x3``
    (padding 1), each -> ReLU, concatenated in that order; every conv has a
    bias."""

    def __init__(self, cin: int, squeeze: int, expand1: int, expand3: int):
        super().__init__()
        self.squeeze = nn.Conv2d(cin, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand1, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand3, 3, padding=1)
        self.out_channels = expand1 + expand3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)), F.relu(self.expand3x3(s))], dim=1)


# (squeeze, expand) of fire2..fire9; the expand widths are equal
_FIRES = ((16, 64), (16, 64), (32, 128), (32, 128), (48, 192), (48, 192),
          (64, 256), (64, 256))
# (stem width, stem kernel, the fires each 3 x 3 / 2 max-pool follows)
_SQUEEZE = {"1_0": (96, 7, (4, 8)), "1_1": (64, 3, (3, 5))}


class SqueezeNet(nn.Module):
    """``conv1`` (stride 2, no padding, bias) -> ReLU -> pool, then
    ``fire2``..``fire9`` with a pool after fire4 and fire8 (1_0) or after
    fire3 and fire5 (1_1).  No BatchNorm.  The pools are torch's
    ``ceil_mode=True``, which keeps a last partial window as JAX's
    ``_max_pool_ceil`` does by padding with -inf."""

    def __init__(self, version: str):
        super().__init__()
        stem, k, self.pool_after = _SQUEEZE[version]
        self.conv1 = nn.Conv2d(3, stem, k, 2)
        cin = stem
        for n, (sq, ex) in enumerate(_FIRES, start=2):
            fire = Fire(cin, sq, ex, ex)
            self.add_module(f"fire{n}", fire)
            cin = fire.out_channels
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 3, H, W), already normalised -> (B, 512, h, w)."""
        pool = lambda t: F.max_pool2d(t, 3, 2, ceil_mode=True)
        x = pool(F.relu(self.conv1(x)))
        for n in range(2, 10):
            x = getattr(self, f"fire{n}")(x)
            if n in self.pool_after:
                x = pool(x)
        return x


class DenseLayer(nn.Module):
    """``norm1`` -> ReLU -> 1 x 1 ``conv1`` to bn_size x growth ->
    ``norm2`` -> ReLU -> 3 x 3 ``conv2`` to growth; the output follows the
    input in the concatenation."""

    def __init__(self, cin: int, growth: int, bn_size: int = 4):
        super().__init__()
        self.norm1 = _bn(cin)
        self.conv1 = _conv(cin, bn_size * growth, 1)
        self.norm2 = _bn(bn_size * growth)
        self.conv2 = _conv(bn_size * growth, growth, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class DenseNet(nn.Module):
    """Stem (7 x 7 / 2 ``conv0``, padding 3, ``norm0``, ReLU, 3 x 3 / 2
    max-pool with padding 1), dense blocks of ``dense{i}_{j}`` layers, and
    between blocks ``trans{i}_norm`` -> ReLU -> 1 x 1 ``trans{i}_conv`` to
    half the channels -> 2 x 2 / 2 average pool (no padding: an odd map
    loses its last row and column); ``norm5`` last, with no ReLU after it
    (the reference keeps torchvision's ``features``, which end there)."""

    def __init__(self, block_config: Sequence[int], growth: int = 32,
                 init_features: int = 64):
        super().__init__()
        self.conv0 = _conv(3, init_features, 7, 2)
        self.norm0 = _bn(init_features)
        self.block_config = tuple(block_config)
        ch = init_features
        for i, n_layers in enumerate(self.block_config):
            for j in range(n_layers):
                self.add_module(f"dense{i + 1}_{j}", DenseLayer(ch, growth))
                ch += growth
            if i != len(self.block_config) - 1:
                self.add_module(f"trans{i + 1}_norm", _bn(ch))
                self.add_module(f"trans{i + 1}_conv", _conv(ch, ch // 2, 1))
                ch //= 2
        self.norm5 = _bn(ch)
        self.out_channels = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 3, H, W), already normalised -> (B, C, H/32, W/32)."""
        x = F.relu(self.norm0(self.conv0(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for i, n_layers in enumerate(self.block_config):
            for j in range(n_layers):
                x = getattr(self, f"dense{i + 1}_{j}")(x)
            if i != len(self.block_config) - 1:
                x = F.relu(getattr(self, f"trans{i + 1}_norm")(x))
                x = F.avg_pool2d(getattr(self, f"trans{i + 1}_conv")(x), 2, 2)
        return self.norm5(x)


# (block config, growth, initial features) of JAX's BACKBONES registry
DENSENET_ARCHS: Dict[str, Tuple[Sequence[int], int, int]] = {
    "densenet121": ((6, 12, 24, 16), 32, 64),
    "densenet169": ((6, 12, 32, 32), 32, 64),
    "densenet201": ((6, 12, 48, 32), 32, 64),
    "densenet161": ((6, 12, 36, 24), 48, 96),
}
SQUEEZENET_ARCHS = {"squeezenet1_0": "1_0", "squeezenet1_1": "1_1"}


BACKBONES = {name: (lambda a=a: ResNet(*a)) for name, a in RESNET_ARCHS.items()}
BACKBONES.update({name: (lambda st=st: ShuffleNetV2(st))
                  for name, st in _STAGES.items()})
BACKBONES.update({
    "mobilenet_v2": MobileNetV2,
    "mobilenet_v3_large": lambda: MobileNetV3(_MBV3_LARGE, 960),
    "mobilenet_v3_small": lambda: MobileNetV3(_MBV3_SMALL, 576),
})
MNASNET_ALPHAS = {"mnasnet0_5": 0.5, "mnasnet0_75": 0.75, "mnasnet1_0": 1.0,
                  "mnasnet1_3": 1.3}
BACKBONES.update({name: (lambda a=a: MNASNet(a)) for name, a in MNASNET_ALPHAS.items()})
BACKBONES.update({name: (lambda v=v: SqueezeNet(v)) for name, v in SQUEEZENET_ARCHS.items()})
BACKBONES.update({name: (lambda a=a: DenseNet(*a)) for name, a in DENSENET_ARCHS.items()})


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
