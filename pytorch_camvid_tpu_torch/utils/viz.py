"""Mask colorization (counterpart of pytorch_camvid_tpu/utils/viz.py:21)."""

from __future__ import annotations

import numpy as np

# BGR palette for up to 21 classes (CamVid uses the first 12)
_PALETTE = np.array([
    [255, 206, 128], [0, 0, 128], [192, 192, 192], [64, 64, 128],
    [64, 64, 0], [0, 128, 128], [128, 128, 192], [128, 64, 64],
    [128, 0, 64], [0, 64, 64], [192, 128, 0], [0, 0, 0],
    [128, 128, 0], [0, 128, 0], [128, 0, 128], [0, 0, 255],
    [255, 0, 0], [0, 255, 0], [255, 255, 0], [0, 255, 255],
    [255, 0, 255]], np.uint8)


def colorize_mask(mask: np.ndarray, num_classes: int = 12) -> np.ndarray:
    """(H, W) class indices -> (H, W, 3) BGR color image; indices at or
    above ``num_classes`` (ignore labels) are black."""
    pal = _PALETTE[:num_classes]
    out = pal[np.clip(mask, 0, len(pal) - 1)]
    out[mask >= num_classes] = 0
    return out
