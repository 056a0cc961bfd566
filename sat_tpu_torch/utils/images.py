"""Standalone image helpers, ported from ``sat_tpu/utils/images.py``
(reference: util.py:133-164).  PIL is imported inside the functions, so the
module imports where PIL does not."""

from __future__ import annotations

import json
from typing import Optional

import numpy as np


def json_loader(path: str):
    with open(path) as f:
        return json.load(f)


def pil_loader(path: str):
    from PIL import Image
    with open(path, "rb") as f:
        return Image.open(f).convert("RGB")


def crop_center(pil_img, crop_width: int, crop_height: int):
    w, h = pil_img.size
    return pil_img.crop(((w - crop_width) // 2, (h - crop_height) // 2,
                         (w + crop_width) // 2, (h + crop_height) // 2))


def crop_max_square(pil_img, size: Optional[int]):
    pil_img = crop_center(pil_img, min(pil_img.size), min(pil_img.size))
    if size:
        pil_img = pil_img.resize((size, size))
    return pil_img


def load_square(path: str, size: Optional[int] = None):
    return crop_max_square(pil_loader(path), size)


def prepare_image(img, size: Optional[int] = None) -> np.ndarray:
    """PIL image -> (1, H, W, 3) float32 array in [0, 1], NHWC as
    ``SATModel.encode`` and ``caption`` take it."""
    if size:
        img = crop_max_square(img, int(size))
    return np.asarray(img, np.float32)[None] / 255.0


def time_to_string(t: float) -> str:
    """(reference: util.py:115-118)"""
    if t > 3600:
        return f"{t/3600:.2f} hours"
    if t > 60:
        return f"{t/60:.2f} minutes"
    return f"{t:.2f} seconds"
