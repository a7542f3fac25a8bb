"""Dataset and prediction visualization (counterpart of
pytorch_camvid_tpu/utils/viz.py): ``colorize_mask`` (class maps to BGR
colors) and ``plot_dataset`` (a grid of image | colorized mask rows, the
working version of the reference's utils.plot_dataset, utils.py:230-246).
cv2 is imported only to write the grid."""

from __future__ import annotations

from typing import Optional

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


def dataset_grid(images: np.ndarray, masks: np.ndarray, count: int = 9,
                 num_classes: int = 12,
                 rng_seed: Optional[int] = 0) -> np.ndarray:
    """(image | colorized mask) pairs stacked into one BGR grid: ``count``
    samples drawn by ``default_rng(rng_seed).permutation``, or the first
    ``count`` when ``rng_seed`` is None."""
    n = len(images)
    idx = (np.random.default_rng(rng_seed).permutation(n)[:count]
           if rng_seed is not None else np.arange(min(count, n)))
    return np.concatenate(
        [np.concatenate([images[i], colorize_mask(masks[i], num_classes)],
                        axis=1) for i in idx], axis=0)


def plot_dataset(images: np.ndarray, masks: np.ndarray, out_path: str,
                 count: int = 9, num_classes: int = 12,
                 rng_seed: Optional[int] = 0) -> str:
    """Write ``dataset_grid`` to ``out_path`` (any cv2 image format);
    returns the path."""
    import cv2
    cv2.imwrite(out_path, dataset_grid(images, masks, count, num_classes,
                                       rng_seed))
    return out_path
