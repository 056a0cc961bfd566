"""Plain PyTorch references of the benchmark's two encoders, in eval mode.

Provenance: torchvision's ``shufflenet_v2_x0_5`` and ``resnet50`` (the
reference repository's encoders), written as functions over a dict of
tensors whose names are the port's ``SATModel.state_dict`` keys, so that the
harness loads one set of drawn tensors into both.  Departures from
torchvision, each the port's and the JAX package's as well: images enter
NHWC in [0, 1] and are normalised here; a ShuffleNet unit interleaves its
two branches (channel shuffle with 2 groups); eval-mode BatchNorm with eps
1e-5; ``encoder_size`` resizes the final map bilinearly with half-pixel
centres (upsampling) or by adaptive average pooling (downsampling); no
classifier.  The output is the annotations (B, L, D).  Nothing here
imports the port."""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

PREFIX = "encoder.backbone."
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
BN_EPS = 1e-5
SHUFFLE_STAGES = {"shufflenet_v2_x0_5": (48, 96, 192, 1024)}
RESNET_BLOCKS = {"resnet50": (3, 4, 6, 3)}

# (name, kind, shape): kind "conv" (weight (out, in/groups, kh, kw)) or "bn"
Spec = Iterator[Tuple[str, str, Tuple[int, ...]]]


def _shuffle_spec(stages) -> Spec:
    yield "conv1", "conv", (24, 3, 3, 3)
    yield "bn1", "bn", (24,)
    cin = 24
    for s, (out, reps) in enumerate(zip(stages[:3], (4, 8, 4))):
        for j in range(reps):
            u, br = f"stage{s + 2}_{j}.", out // 2
            right = cin if j == 0 else cin // 2
            if j == 0:
                yield u + "b1_dw", "conv", (cin, 1, 3, 3)
                yield u + "b1_dwbn", "bn", (cin,)
                yield u + "b1_pw", "conv", (br, cin, 1, 1)
                yield u + "b1_pwbn", "bn", (br,)
            yield u + "b2_pw1", "conv", (br, right, 1, 1)
            yield u + "b2_pw1bn", "bn", (br,)
            yield u + "b2_dw", "conv", (br, 1, 3, 3)
            yield u + "b2_dwbn", "bn", (br,)
            yield u + "b2_pw2", "conv", (br, br, 1, 1)
            yield u + "b2_pw2bn", "bn", (br,)
            cin = out
    yield "conv5", "conv", (stages[3], cin, 1, 1)
    yield "bn5", "bn", (stages[3],)


def _resnet_spec(blocks) -> Spec:
    yield "conv1", "conv", (64, 3, 7, 7)
    yield "bn1", "bn", (64,)
    cin = 64
    for i, n in enumerate(blocks):
        planes = 64 * 2 ** i
        for j in range(n):
            b, out = f"layer{i + 1}_{j}.", 4 * planes
            stride = 2 if i > 0 and j == 0 else 1
            yield b + "conv1", "conv", (planes, cin, 1, 1)
            yield b + "bn1", "bn", (planes,)
            yield b + "conv2", "conv", (planes, planes, 3, 3)
            yield b + "bn2", "bn", (planes,)
            yield b + "conv3", "conv", (out, planes, 1, 1)
            yield b + "bn3", "bn", (out,)
            if stride != 1 or cin != out:
                yield b + "down_conv", "conv", (out, cin, 1, 1)
                yield b + "down_bn", "bn", (out,)
            cin = out


def spec(arch: str) -> Spec:
    """The backbone's layers, in the order the port registers them."""
    if arch in SHUFFLE_STAGES:
        return _shuffle_spec(SHUFFLE_STAGES[arch])
    if arch in RESNET_BLOCKS:
        return _resnet_spec(RESNET_BLOCKS[arch])
    raise ValueError(f"no reference encoder for {arch}")


def out_channels(arch: str) -> int:
    return SHUFFLE_STAGES[arch][3] if arch in SHUFFLE_STAGES else 2048


def shapes_state_dict(arch: str) -> Dict[str, torch.Tensor]:
    """Zero tensors of the backbone's shapes (on the current device)."""
    sd = {}
    for name, kind, shape in spec(arch):
        if kind == "conv":
            sd[PREFIX + name + ".weight"] = torch.zeros(shape)
        else:
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                sd[PREFIX + name + "." + leaf] = torch.zeros(shape)
    return sd


def plain_conv(x, w, stride, padding, groups):
    return F.conv2d(x, w, None, stride, padding, 1, groups)


def encode(sd: Dict[str, torch.Tensor], arch: str, images: torch.Tensor,
           encoder_size: Optional[int], conv: Callable = plain_conv) -> torch.Tensor:
    """images (B, H, W, 3) in [0, 1] -> annotations (B, L, D)."""
    def cv(name, x, stride=1, groups=1):
        w = sd[PREFIX + name + ".weight"]
        return conv(x, w, stride, w.shape[-1] // 2, groups)

    def bn(name, x):
        g = lambda leaf: sd[PREFIX + name + "." + leaf]
        return F.batch_norm(x, g("running_mean"), g("running_var"), g("weight"),
                            g("bias"), False, 0.0, BN_EPS)

    mean = torch.tensor(MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(STD, dtype=images.dtype, device=images.device)
    x = ((images - mean) / std).permute(0, 3, 1, 2)
    if arch in SHUFFLE_STAGES:
        x = _shufflenet(SHUFFLE_STAGES[arch], x, cv, bn)
    else:
        x = _resnet(RESNET_BLOCKS[arch], x, cv, bn, sd)
    if encoder_size is not None and encoder_size != x.shape[-1]:
        s = (encoder_size, encoder_size)
        x = (F.interpolate(x, size=s, mode="bilinear", align_corners=False)
             if encoder_size > x.shape[-1] else F.adaptive_avg_pool2d(x, s))
    b, c = x.shape[:2]
    return x.permute(0, 2, 3, 1).reshape(b, -1, c).contiguous()


def _shufflenet(stages, x, cv, bn):
    x = F.max_pool2d(F.relu(bn("bn1", cv("conv1", x, 2))), 3, 2, 1)
    for s, (out, reps) in enumerate(zip(stages[:3], (4, 8, 4))):
        for j in range(reps):
            u = f"stage{s + 2}_{j}."
            if j == 0:
                c = x.shape[1]
                left = bn(u + "b1_dwbn", cv(u + "b1_dw", x, 2, c))
                left = F.relu(bn(u + "b1_pwbn", cv(u + "b1_pw", left)))
                right = x
            else:
                left, right = x.chunk(2, dim=1)
            y = F.relu(bn(u + "b2_pw1bn", cv(u + "b2_pw1", right)))
            y = bn(u + "b2_dwbn", cv(u + "b2_dw", y, 2 if j == 0 else 1, y.shape[1]))
            y = F.relu(bn(u + "b2_pw2bn", cv(u + "b2_pw2", y)))
            b, c, h, w = left.shape
            x = torch.stack([left, y], dim=2).reshape(b, 2 * c, h, w)
    return F.relu(bn("bn5", cv("conv5", x)))


def _resnet(blocks, x, cv, bn, sd):
    x = F.max_pool2d(F.relu(bn("bn1", cv("conv1", x, 2))), 3, 2, 1)
    for i, n in enumerate(blocks):
        for j in range(n):
            b = f"layer{i + 1}_{j}."
            stride = 2 if i > 0 and j == 0 else 1
            y = F.relu(bn(b + "bn1", cv(b + "conv1", x)))
            y = F.relu(bn(b + "bn2", cv(b + "conv2", y, stride)))
            y = bn(b + "bn3", cv(b + "conv3", y))
            idn = (bn(b + "down_bn", cv(b + "down_conv", x, stride))
                   if PREFIX + b + "down_conv.weight" in sd else x)
            x = F.relu(y + idn)
    return x

