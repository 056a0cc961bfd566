"""The SAT encoder's eval path, ported from ``sat_tpu/models/encoder.py``:
normalize -> backbone -> optional 1x1 ``proj`` to ``encoder_dim`` ->
``encoder_size`` pool or upsample -> flatten to (B, L, D).

Images enter NHWC in [0, 1], as in the JAX package; the backbone runs NCHW."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..config import SATConfig
from ..ops.image_ops import adaptive_avg_pool2d, bilinear_resize, normalize_image
from .backbones import BACKBONES


class SATEncoder(nn.Module):
    def __init__(self, arch: str, mean: Sequence[float] = (0.485, 0.456, 0.406),
                 std: Sequence[float] = (0.229, 0.224, 0.225),
                 encoder_dim: Optional[int] = None,
                 encoder_size: Optional[int] = None):
        super().__init__()
        if arch not in BACKBONES:
            raise ValueError(f"Encoder not supported : {arch}")
        self.mean, self.std = tuple(mean), tuple(std)
        self.encoder_size = encoder_size
        self.backbone = BACKBONES[arch]()
        c = self.backbone.out_channels
        # 1x1 conv forcing encoder_dim features, as flax's "proj"
        self.proj = (nn.Conv2d(c, encoder_dim, 1, bias=True)
                     if encoder_dim is not None and encoder_dim != c else None)

    def forward(self, x: torch.Tensor, flatten: bool = True) -> torch.Tensor:
        """x (B, H, W, 3) in [0, 1] -> annotations (B, L, D), or the NHWC
        feature map when ``flatten=False``."""
        x = normalize_image(x, self.mean, self.std)
        x = self.backbone(x.permute(0, 3, 1, 2).contiguous())
        if self.proj is not None:
            x = self.proj(x)
        x = x.permute(0, 2, 3, 1)
        if self.encoder_size is not None:
            h, s = x.shape[1], self.encoder_size
            if s < h:
                x = adaptive_avg_pool2d(x, (s, s))
            elif s > h:
                x = bilinear_resize(x, (s, s))
        if not flatten:
            return x.contiguous()
        b, h, w, c = x.shape
        return x.reshape(b, h * w, c).contiguous()


def encoder_from_config(cfg: SATConfig) -> SATEncoder:
    return SATEncoder(cfg.encoder_arch, cfg.mean, cfg.std,
                      encoder_dim=cfg.encoder_dim,
                      encoder_size=cfg.encoder_size)


def probe_encoder(cfg: SATConfig) -> Tuple[int, Tuple[int, int]]:
    """Shape probe on the meta device (no memory, no FLOPs):
    returns (final_dim, (grid_h, grid_w))."""
    with torch.device("meta"):
        enc = encoder_from_config(cfg).eval()
        fake = torch.zeros(1, cfg.input_size, cfg.input_size, 3)
        _, h, w, c = enc(fake, flatten=False).shape
    return int(c), (int(h), int(w))
