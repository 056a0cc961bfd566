"""Training augmentation on the device, ported from
``sat_tpu/data/transforms.py``: uint8 images -> float32 in [0, 1], the
geometry, colour jitter, then Gaussian noise.

Geometry.  Without the optical warps, the random-resized crop and the
horizontal flip are one axis-aligned bilinear resample (two products with
interpolation matrices, the math of
``sat_tpu/ops/image_ops.py::separable_resample_mxu``).  With them, crop,
flip and one of the three warps (perspective, affine, rotation, chosen per
image) compose into one 3 x 3 homography per image, applied by one
``affine_grid`` + ``grid_sample_bilinear`` pass; corners outside the image
sample black.

Colour jitter.  Brightness, contrast, saturation, then hue, always in that
order (torchvision shuffles it), with factors U(max(0, 1 - v), 1 + v) and a
hue shift U(-0.03, 0.03) of a turn.

At ``precision 16`` the pixels are bf16 after the uint8 load and the
separable resample, the jitter and the noise stay bf16, as in JAX; the
warp's corner weights are float32, so with the optical warps on the
augment returns float32 there, as JAX's does.

  aug_scale            -> RandomResizedCrop(scale=(aug_scale, 1)), where != 1
  aug_hflip            -> RandomHorizontalFlip(p), only where 0 < p < 1
  aug_color_jitter     -> ColorJitter(b=c=s=v, hue=0.03), where 0 < v <= 1
  aug_optical_strength -> RandomChoice[Perspective(0.5 s) | Affine(45 s deg,
                          shear 45 s deg) | Rotation(45 s deg)], where 0 < s <= 1
  aug_noise_std        -> additive N(0, std) noise, where > 0

Every random number of a call comes from ``_draws``, in one place: a test
hands the augment JAX's draws there, and the card can take the CPU's."""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

from ..config import SATConfig
from ..ops.image_ops import (adjust_brightness, adjust_contrast, adjust_hue,
                             adjust_saturation, affine_grid, grid_sample_bilinear)

Augment = Callable[[torch.Generator, torch.Tensor], torch.Tensor]
Draws = Dict[str, torch.Tensor]


def _settings(cfg: SATConfig) -> Dict[str, bool]:
    """Which parts of the augment run, by the reference's rules."""
    return {"crop": cfg.aug_scale != 1.0,
            # the reference adds RandomHorizontalFlip only where 0 < p < 1
            "flip": 0.0 < cfg.aug_hflip < 1.0,
            "jitter": cfg.aug_color_jitter != 0 and cfg.aug_color_jitter <= 1.0,
            "optical": 0.0 < cfg.aug_optical_strength <= 1.0,
            "noise": cfg.aug_noise_std > 0}


def _out_dtype(cfg: SATConfig) -> torch.dtype:
    """The augment's result type (module docstring)."""
    if cfg.precision == 16 and not _settings(cfg)["optical"]:
        return torch.bfloat16
    return torch.float32


def _draws(generator: torch.Generator, b: int, hw: Tuple[int, int],
           cfg: SATConfig, device: torch.device) -> Draws:
    """Every random number of one augment call on b images of output size
    hw, by name, on ``device``: the crop's area, log-aspect and centre
    (``area``, ``log_ratio``, ``crop_x``, ``crop_y``), the flip coins, the
    jitter factors (``brightness``, ``contrast``, ``saturation``, ``hue``),
    the warps' parameters (``perspective`` (B, 4, 2) corner shifts,
    ``affine_angle``, ``shear_angle``, ``rotation`` in radians, ``choice``
    in {0, 1, 2}: perspective, affine, rotation) and the ``noise``."""
    on = _settings(cfg)
    u = lambda lo, hi, *shape: torch.empty((b,) + shape, device=device).uniform_(
        lo, hi, generator=generator)
    d: Draws = {}
    if on["crop"]:
        d["area"] = u(cfg.aug_scale, 1.0)
        d["log_ratio"] = u(math.log(3 / 4), math.log(4 / 3))
        d["crop_x"], d["crop_y"] = u(-1.0, 1.0), u(-1.0, 1.0)
    if on["flip"]:
        d["flip"] = torch.rand(b, device=device, generator=generator) < cfg.aug_hflip
    if on["jitter"]:
        v = cfg.aug_color_jitter
        for k in ("brightness", "contrast", "saturation"):
            d[k] = u(max(0.0, 1.0 - v), 1.0 + v)
        d["hue"] = u(-0.03, 0.03)
    if on["optical"]:
        s = cfg.aug_optical_strength
        rad = math.radians(45.0 * s)
        d["perspective"] = u(0.0, 0.5 * s, 4, 2)
        d["affine_angle"], d["shear_angle"], d["rotation"] = (
            u(-rad, rad), u(-rad, rad), u(-rad, rad))
        d["choice"] = torch.randint(0, 3, (b,), device=device, generator=generator)
    if on["noise"]:
        d["noise"] = torch.randn((b,) + tuple(hw) + (3,), device=device,
                                 generator=generator, dtype=_out_dtype(cfg))
    return d


def _stack33(rows) -> torch.Tensor:
    """A (B, 3, 3) matrix from three rows of three (B,) tensors."""
    return torch.stack([torch.stack(r, -1) for r in rows], dim=1)


def _matmul33(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched float32 3 x 3 products summed as XLA's dot sums them: the
    first product rounded, the next two added by fused multiply-adds (a
    product of two float32 is exact in float64, so one rounding there is
    the fused multiply-add's)."""
    a, b = a.double(), b.double()
    acc = (a[:, :, 0, None] * b[:, None, 0]).float()
    for k in (1, 2):
        acc = (acc.double() + a[:, :, k, None] * b[:, None, k]).float()
    return acc


def _rrc_theta(area: torch.Tensor, log_ratio: torch.Tensor, crop_x: torch.Tensor,
               crop_y: torch.Tensor) -> torch.Tensor:
    """RandomResizedCrop as a (B, 3, 3) homography on coordinates in
    [-1, 1]: a crop of ``area`` of the image at aspect exp(log_ratio),
    clamped to fit, its centre at crop_x / crop_y in [-1, 1] of the room
    left (one draw, no retry)."""
    ratio = torch.exp(log_ratio)
    cw = torch.clamp(torch.sqrt(area * ratio), max=1.0)   # crop width, a fraction
    ch = torch.clamp(torch.sqrt(area / ratio), max=1.0)
    tx, ty = crop_x * (1.0 - cw), crop_y * (1.0 - ch)
    z, o = torch.zeros_like(cw), torch.ones_like(cw)
    return _stack33([(cw, z, tx), (z, ch, ty), (z, z, o)])


def _rotation_theta(angle: torch.Tensor) -> torch.Tensor:
    ca, sa = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(angle), torch.ones_like(angle)
    return _stack33([(ca, -sa, z), (sa, ca, z), (z, z, o)])


def _affine_theta(angle: torch.Tensor, shear_angle: torch.Tensor) -> torch.Tensor:
    """RandomAffine(degrees, shear): a rotation by ``angle`` composed with
    an x-shear of tan(shear_angle)."""
    shear = torch.tan(shear_angle)
    z, o = torch.zeros_like(shear), torch.ones_like(shear)
    return _matmul33(_rotation_theta(angle), _stack33([(o, shear, z), (z, o, z),
                                                        (z, z, o)]))


# the output's corners (x, y) in [-1, 1]^2, clockwise from the top left
_CORNERS = ((-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0))


def _perspective_theta(shift: torch.Tensor) -> torch.Tensor:
    """RandomPerspective: the homography (B, 3, 3) that maps the output's
    corners to the corners moved inward by ``shift`` (B, 4, 2), each along
    x and y; one batched 8 x 8 solve."""
    b = shift.shape[0]
    dst = torch.tensor(_CORNERS, dtype=torch.float32, device=shift.device)
    src = dst - torch.sign(dst) * shift                          # (B, 4, 2)
    x, y = dst[:, 0].expand(b, 4), dst[:, 1].expand(b, 4)
    u, v = src[..., 0], src[..., 1]
    z, o = torch.zeros_like(u), torch.ones_like(u)
    # H [x, y, 1] ~ [u, v, 1]: two rows per corner
    rows_u = torch.stack([x, y, o, z, z, z, -u * x, -u * y], -1)
    rows_v = torch.stack([z, z, z, x, y, o, -v * x, -v * y], -1)
    a = torch.stack([rows_u, rows_v], 2).reshape(b, 8, 8)
    h8 = torch.linalg.solve(a, src.reshape(b, 8))
    return torch.cat([h8, torch.ones(b, 1, device=shift.device)], 1).reshape(b, 3, 3)


def _optical_theta(d: Draws) -> torch.Tensor:
    """The per-image warp: perspective, affine or rotation by ``choice``."""
    choice = d["choice"][:, None, None]
    return torch.where(choice == 0, _perspective_theta(d["perspective"]),
                       torch.where(choice == 1,
                                   _affine_theta(d["affine_angle"], d["shear_angle"]),
                                   _rotation_theta(d["rotation"])))


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
    plus noise, on the images' device, in float32 (bf16 at precision 16
    without the optical warps)."""
    size = cfg.input_size
    on = _settings(cfg)
    dtype = torch.bfloat16 if cfg.precision == 16 else torch.float32
    # JAX multiplies by the standard deviation cast to the images' type
    noise_std = torch.tensor(cfg.aug_noise_std).to(_out_dtype(cfg)).item()

    def augment(generator: torch.Generator, images: torch.Tensor) -> torch.Tensor:
        x = images.to(dtype) / 255.0
        b, dev = x.shape[0], x.device
        hw = (size, size) if on["crop"] or on["optical"] else tuple(x.shape[1:3])
        d = _draws(generator, b, hw, cfg, dev)
        if on["optical"]:
            # crop . flip . warp as one homography, one resampling pass
            theta = (_rrc_theta(d["area"], d["log_ratio"], d["crop_x"], d["crop_y"])
                     if on["crop"] else torch.eye(3, device=dev).expand(b, 3, 3))
            if on["flip"]:
                sign = torch.where(d["flip"], -1.0, 1.0)
                theta = theta * torch.stack([sign, torch.ones_like(sign),
                                             torch.ones_like(sign)], -1)[:, None, :]
            theta = _matmul33(theta, _optical_theta(d))
            x = grid_sample_bilinear(x, *affine_grid(theta, (size, size), (size, size)))
        elif on["crop"]:
            theta = _rrc_theta(d["area"], d["log_ratio"], d["crop_x"], d["crop_y"])
            centers = (torch.arange(size, dtype=torch.float32, device=dev)
                       + 0.5) / size * 2 - 1
            mx = theta[:, 0, 0, None] * centers + theta[:, 0, 2, None]
            my = theta[:, 1, 1, None] * centers + theta[:, 1, 2, None]
            px = (mx + 1.0) * 0.5 * size - 0.5
            py = (my + 1.0) * 0.5 * size - 0.5
            if on["flip"]:
                # mirroring the output is sampling the reversed column row
                px = torch.where(d["flip"][:, None], px.flip(-1), px)
            x = separable_resample(x, py, px)
        elif on["flip"]:
            x = torch.where(d["flip"][:, None, None, None], x.flip(2), x)
        if on["jitter"]:
            x = adjust_brightness(x, d["brightness"])
            x = adjust_contrast(x, d["contrast"])
            x = adjust_saturation(x, d["saturation"])
            x = adjust_hue(x, d["hue"])
        if on["noise"]:
            x = x + d["noise"] * noise_std
        return x

    return augment


def val_preprocess(images: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1]; the model normalises."""
    return images.float() / 255.0
