"""Training augmentation on the device, ported from
``sat_tpu/data/transforms.py``: uint8 images -> float32 in [0, 1], then the
random-resized crop and horizontal flip as one axis-aligned bilinear
resample (two products with interpolation matrices, the math of
``sat_tpu/ops/image_ops.py::separable_resample_mxu``), then Gaussian noise.
At ``precision 16`` all of it runs in bfloat16, as JAX's: the pixels become
bf16 after the uint8 load, the resample multiplies bf16 with float32 sums
and rounds each product back to bf16, and the noise is bf16.

  aug_scale      -> RandomResizedCrop(scale=(aug_scale, 1)), where != 1
  aug_hflip      -> RandomHorizontalFlip(p), only where 0 < p < 1
  aug_noise_std  -> additive N(0, std) noise, where > 0

Colour jitter and the optical warps (``aug_color_jitter``,
``aug_optical_strength``) are not ported yet and raise."""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..config import SATConfig

Augment = Callable[[torch.Generator, torch.Tensor], torch.Tensor]


def _rrc_theta(generator: torch.Generator, b: int, lo_scale: float,
               device: torch.device) -> torch.Tensor:
    """RandomResizedCrop as a (B, 3, 3) homography on coordinates in
    [-1, 1]: area U(lo, 1), log-uniform aspect in (3/4, 4/3), the crop's
    centre uniform where the crop stays inside (one draw, no retry)."""
    u = lambda lo, hi: torch.empty(b, device=device).uniform_(
        lo, hi, generator=generator)
    area = u(lo_scale, 1.0)
    ratio = torch.exp(u(math.log(3 / 4), math.log(4 / 3)))
    cw = torch.clamp(torch.sqrt(area * ratio), max=1.0)   # crop width, a fraction
    ch = torch.clamp(torch.sqrt(area / ratio), max=1.0)
    tx = u(-1.0, 1.0) * (1.0 - cw)
    ty = u(-1.0, 1.0) * (1.0 - ch)
    zeros, ones = torch.zeros_like(cw), torch.ones_like(cw)
    return torch.stack([torch.stack([cw, zeros, tx], -1),
                        torch.stack([zeros, ch, ty], -1),
                        torch.stack([zeros, zeros, ones], -1)], dim=1)


def _bilinear_weight_matrix(p: torch.Tensor, n: int) -> torch.Tensor:
    """(B, O) coordinates -> (B, O, n) matrix of the bilinear hat
    relu(1 - |p - i|); rows sum to 1 for p in [0, n - 1]."""
    idx = torch.arange(n, dtype=torch.float32, device=p.device)
    return torch.clamp(1.0 - (p[:, :, None] - idx).abs(), min=0.0)


def separable_resample(x: torch.Tensor, py: torch.Tensor, px: torch.Tensor
                       ) -> torch.Tensor:
    """Bilinear resampling of x (B, H, W, C) at rows py (B, OH) and columns
    px (B, OW), pixel coordinates clamped to the image, as two batched
    products: rows first, then columns, each in x's type (the weights are
    rounded to it; a bf16 product sums in float32 and rounds once)."""
    b, h, w, c = x.shape
    oh, ow = py.shape[1], px.shape[1]
    wy = _bilinear_weight_matrix(py.clamp(0.0, h - 1.0), h).to(x.dtype)   # (B, OH, H)
    wx = _bilinear_weight_matrix(px.clamp(0.0, w - 1.0), w).to(x.dtype)   # (B, OW, W)
    rows = torch.matmul(wy, x.reshape(b, h, w * c))             # (B, OH, W*C)
    # columns as one (OW, W) x (W, OH*C) product per image: a broadcast
    # (B, 1, OW, W) x (B, OH, W, C) matmul would expand wx OH-fold
    cols = torch.matmul(wx, rows.reshape(b, oh, w, c).transpose(1, 2)
                        .reshape(b, w, oh * c))                 # (B, OW, OH*C)
    return cols.reshape(b, ow, oh, c).transpose(1, 2)           # (B, OH, OW, C)


def build_train_augment(cfg: SATConfig) -> Augment:
    """augment(generator, images uint8 (B, S, S, 3)) -> images in [0, 1]
    plus noise, on the images' device, float32 (bf16 at precision 16)."""
    if 0.0 < cfg.aug_optical_strength <= 1.0:
        raise NotImplementedError("aug_optical_strength (perspective, affine "
                                  "and rotation warps) is not ported yet")
    if cfg.aug_color_jitter != 0 and cfg.aug_color_jitter <= 1.0:
        raise NotImplementedError("aug_color_jitter is not ported yet")
    size = cfg.input_size
    use_crop = cfg.aug_scale != 1.0
    # the reference adds RandomHorizontalFlip only where 0 < p < 1
    use_flip = 0.0 < cfg.aug_hflip < 1.0
    dtype = torch.bfloat16 if cfg.precision == 16 else torch.float32
    # JAX multiplies by the standard deviation cast to the images' type
    noise_std = torch.tensor(cfg.aug_noise_std).to(dtype).item()

    def augment(generator: torch.Generator, images: torch.Tensor) -> torch.Tensor:
        x = images.to(dtype) / 255.0
        b, dev = x.shape[0], x.device
        if use_crop:
            theta = _rrc_theta(generator, b, cfg.aug_scale, dev)
            centers = (torch.arange(size, dtype=torch.float32, device=dev)
                       + 0.5) / size * 2 - 1
            mx = theta[:, 0, 0, None] * centers + theta[:, 0, 2, None]
            my = theta[:, 1, 1, None] * centers + theta[:, 1, 2, None]
            px = (mx + 1.0) * 0.5 * size - 0.5
            py = (my + 1.0) * 0.5 * size - 0.5
            if use_flip:
                # mirroring the output is sampling the reversed column row
                flip = _coin(generator, b, cfg.aug_hflip, dev)
                px = torch.where(flip[:, None], px.flip(-1), px)
            x = separable_resample(x, py, px)
        elif use_flip:
            flip = _coin(generator, b, cfg.aug_hflip, dev)
            x = torch.where(flip[:, None, None, None], x.flip(2), x)
        if cfg.aug_noise_std > 0:
            x = x + torch.randn(x.shape, device=dev, generator=generator,
                                dtype=dtype) * noise_std
        return x

    return augment


def _coin(generator: torch.Generator, b: int, p: float,
          device: torch.device) -> torch.Tensor:
    return torch.rand(b, device=device, generator=generator) < p


def val_preprocess(images: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1]; the model normalises."""
    return images.float() / 255.0
