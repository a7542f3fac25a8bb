"""Dataset statistics (reference: utils.compute_mean_and_std, utils.py:50-93
— produced the constants in conf/settings.py:8-9).

A copy of pytorch_camvid_tpu/utils/stats.py, which the port cannot import
(the JAX package's ``utils`` pulls in jax)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def compute_mean_and_std(images: np.ndarray) -> Tuple[Tuple[float, ...],
                                                      Tuple[float, ...]]:
    """Per-channel mean/std in [0,1] over an (N,H,W,C) uint8 array, BGR
    channel order preserved (utils.py:50-93 iterates a torch Dataset; here
    the packed cache array is reduced directly)."""
    x = images.astype(np.float64) / 255.0
    mean = x.mean(axis=(0, 1, 2))
    std = x.std(axis=(0, 1, 2))
    return tuple(mean.tolist()), tuple(std.tolist())
