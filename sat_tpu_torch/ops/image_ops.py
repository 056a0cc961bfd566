"""Image ops on NHWC tensors, ported from ``sat_tpu/ops/image_ops.py``: the
encoder's eval path (normalise, resize, pool) and the training augment's
geometry (one bilinear grid sample through a per-image homography) and
colour jitter (torchvision ``ColorJitter`` semantics).

The colour ops keep the image's type, as JAX's do: a bf16 image stays bf16,
each op rounding its result once (a grey level, a blend) where JAX's fused
program rounds it."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def normalize_image(x: torch.Tensor, mean: Sequence[float],
                    std: Sequence[float]) -> torch.Tensor:
    """Channel-wise (x - mean) / std over the last axis."""
    mean = torch.tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def bilinear_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (align_corners=False).  The
    encoder calls it only to upsample, where it equals ``jax.image.resize``."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


def adaptive_avg_pool2d(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """torch AdaptiveAvgPool2d bins on NHWC: bin i covers rows
    [floor(i*H/oh), ceil((i+1)*H/oh))."""
    y = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), tuple(out_hw))
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Grid sampling: every optical warp is one per-image homography
# ---------------------------------------------------------------------------

def grid_sample_bilinear(x: torch.Tensor, grid_y: torch.Tensor,
                         grid_x: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Sample x (B, H, W, C) at pixel coordinates grid_y / grid_x (B, OH, OW).

    Each of the four corners that lies outside the image contributes
    ``fill``.  The corner weights have the grid's type, so a bf16 image
    sampled on a float32 grid gives float32, as in JAX."""
    b, h, w, c = x.shape
    oh, ow = grid_y.shape[1:]
    y0, x0 = torch.floor(grid_y), torch.floor(grid_x)
    wy = (grid_y - y0)[..., None]
    wx = (grid_x - x0)[..., None]
    y0i, x0i = y0.long(), x0.long()
    flat = x.reshape(b, h * w, c)
    fill_t = torch.tensor(fill, dtype=x.dtype, device=x.device)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = torch.gather(flat, 1, idx.reshape(b, oh * ow, 1).expand(b, oh * ow, c))
        return torch.where(valid[..., None], vals.reshape(b, oh, ow, c), fill_t)

    v00, v01 = gather(y0i, x0i), gather(y0i, x0i + 1)
    v10, v11 = gather(y0i + 1, x0i), gather(y0i + 1, x0i + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def affine_grid(theta: torch.Tensor, out_hw: Tuple[int, int],
                in_hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sampling grids from (B, 3, 3) homographies that map normalised output
    coordinates in [-1, 1]^2 (x first, half-pixel centres) to normalised
    input coordinates, with the perspective divide.  Returns the pixel
    coordinates (grid_y, grid_x), each (B, OH, OW)."""
    oh, ow = out_hw
    ih, iw = in_hw
    dev = theta.device
    ys = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) / oh * 2.0 - 1.0
    xs = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) / ow * 2.0 - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    # XLA's dot: t0 x rounded, then t1 y and t2 added by fused multiply-adds;
    # float64 holds a product of two float32 exactly, so adding it there and
    # rounding once is the fused multiply-add's result
    t = theta.float()[:, :, :, None, None].double()
    mapped = ((t[:, :, 0] * gx).float().double() + t[:, :, 1] * gy).float()
    mapped = (mapped.double() + t[:, :, 2]).float()               # (B, 3, OH, OW)
    mx = mapped[:, 0] / mapped[:, 2]
    my = mapped[:, 1] / mapped[:, 2]
    return (my + 1.0) * 0.5 * ih - 0.5, (mx + 1.0) * 0.5 * iw - 0.5


def warp_affine(x: torch.Tensor, theta: torch.Tensor,
                out_hw: Tuple[int, int]) -> torch.Tensor:
    gy, gx = affine_grid(theta, out_hw, x.shape[1:3])
    return grid_sample_bilinear(x, gy, gx)


# ---------------------------------------------------------------------------
# Colour ops (torchvision ColorJitter semantics, reference: train.py:223-224)
# ---------------------------------------------------------------------------

_GRAY = np.array([0.299, 0.587, 0.114], np.float32)


def _gray(x: torch.Tensor) -> torch.Tensor:
    """The luma (B, H, W) of x in x's type: the weights rounded to x's type,
    the three products summed in float32 and rounded once."""
    g = torch.from_numpy(_GRAY).to(x.dtype).float().tolist()
    xf = x.float()
    return (xf[..., 0] * g[0] + xf[..., 1] * g[1] + xf[..., 2] * g[2]).to(x.dtype)


def _per_image(factor: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return factor.to(device=x.device, dtype=x.dtype)[:, None, None, None]


def adjust_brightness(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x * _per_image(factor, x), 0.0, 1.0)


def adjust_contrast(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Blend with the image's mean grey level, taken in float32."""
    mean = _gray(x).float().mean(dim=(1, 2))[:, None, None, None].to(x.dtype)
    f = _per_image(factor, x)
    return torch.clamp(f * x + (1 - f) * mean, 0.0, 1.0)


def adjust_saturation(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Blend with each pixel's grey level."""
    f = _per_image(factor, x)
    return torch.clamp(f * x + (1 - f) * _gray(x)[..., None], 0.0, 1.0)


def adjust_hue(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Hue shift by delta (a fraction of a full turn, per image) through
    RGB -> HSV -> RGB; grey pixels stay as they are."""
    delta = delta.to(device=x.device, dtype=x.dtype)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = x.amax(dim=-1)
    minc = x.amin(dim=-1)
    v = maxc
    rng_ = maxc - minc
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    s = torch.where(maxc > 0, rng_ / torch.clamp(maxc, min=1e-8), zero)
    safe = torch.clamp(rng_, min=1e-8)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    # floor-mod, as Python's % and jnp's: the result takes the divisor's sign
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.remainder(h + delta[:, None, None], 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    # jnp.choose(mode="clip") on i % 6: every index is in range
    i = torch.remainder(i.long(), 6)[..., None]
    pick = lambda *opts: torch.gather(torch.stack(opts, -1), -1, i)[..., 0]
    out = torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                       pick(p, p, t, v, v, q)], dim=-1)
    return torch.where(rng_[..., None] > 0, out, x)
