"""Seeded inputs: the scenes.

``scenes`` draws the scenes of ``chip_smoke.py::scenes`` (``:469-493``):
one or two striped red shapes (8 outlines, 8 stripe textures, two sizes)
in the cells of a 3 x 3 grid on grey, with pixel noise N(0, 6), cut to
uint8 and scaled to [0, 1].  The copy draws every image at once on the
device from a ``torch.Generator``, in place of one numpy loop per image,
so its pixels are the same kind of scene, not the same pixels."""

from __future__ import annotations

import math

import torch

RED = (200.0, 40.0, 40.0)
CHUNK = 128


def _shape_masks(x, y, r):
    """The 8 outlines of ``chip_smoke._shape_mask`` at offsets x, y from the
    centre, (8, ...) bool."""
    rr = torch.hypot(x, y)
    ax, ay = x.abs(), y.abs()
    return torch.stack([
        rr < r, torch.maximum(ax, ay) < r * 0.82,
        (y < r * 0.55) & (ax < (y + r) * 0.55), ax + ay < r * 1.05,
        (rr < r) & (rr > r * 0.55), (ax < r * 0.3) | (ay < r * 0.3),
        ay < r * 0.35, ax < r * 0.35])


def scenes(n: int, size: int, gen: torch.Generator) -> torch.Tensor:
    """n images (n, size, size, 3) float32 in [0, 1] on ``gen``'s device."""
    dev = gen.device
    cell = size // 3
    out = torch.empty((n, size, size, 3), device=dev)
    red = torch.tensor(RED, device=dev)
    coords = torch.arange(size, device=dev, dtype=torch.float32)
    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        count = torch.randint(1, 3, (m,), generator=gen, device=dev)
        cells = torch.rand((m, 9), generator=gen, device=dev).argsort(1)[:, :2]
        img = torch.full((m, size, size, 3), 105.0, device=dev)
        for q in range(2):
            big = torch.randint(0, 2, (m,), generator=gen, device=dev)
            r = torch.where(big == 1, min(int(cell * 0.42), cell // 2 - 1),
                            min(int(cell * 0.22), cell // 2 - 1)).clamp(min=2)
            c = cells[:, q]
            jit = (cell // 2 - r - 1).clamp(min=0)
            u = torch.rand((m, 2), generator=gen, device=dev)
            off = (u * (2 * jit + 1)[:, None]).floor() - jit[:, None]
            cy = (c // 3) * cell + cell // 2 + off[:, 0]
            cx = (c % 3) * cell + cell // 2 + off[:, 1]
            tex = torch.randint(0, 8, (m,), generator=gen, device=dev)
            kind = torch.randint(0, 8, (m,), generator=gen, device=dev)
            rf = r.float()[:, None, None]
            y = coords[None, :, None] - cy[:, None, None] + 0.5
            x = coords[None, None, :] - cx[:, None, None] + 0.5
            y, x = torch.broadcast_tensors(y, x)
            box = (y >= -rf) & (y < rf) & (x >= -rf) & (x < rf)
            ang = ((tex % 4).float() * math.pi / 4)[:, None, None]
            freq = (torch.where(tex < 4, 1.6, 3.6) * math.pi / r.float())[:, None, None]
            field = 0.775 + 0.225 * torch.sign(torch.sin(
                (x * torch.cos(ang) + y * torch.sin(ang)) * freq))
            shape = _shape_masks(x, y, rf)
            mask = shape.gather(0, kind[None, :, None, None].expand(1, *x.shape))[0]
            mask = mask & box & (q < count)[:, None, None]
            img = torch.where(mask[..., None], field[..., None] * red, img)
        img = img + 6.0 * torch.randn(img.shape, generator=gen, device=dev)
        out[lo:lo + m] = img.clamp(0, 255).floor() / 255.0
    return out

