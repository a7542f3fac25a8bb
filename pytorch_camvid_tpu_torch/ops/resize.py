"""Bilinear resampling with the reference's two conventions (counterpart of
pytorch_camvid_tpu/ops/resize.py:71-88). NHWC in and out.

1. ``nn.Upsample(scale_factor=2, mode='bilinear', align_corners=True)``
   (models/unet.py:25): src = dst * (H_in - 1) / (H_out - 1).
2. ``cv2.resize`` default bilinear (transforms.py:58): half-pixel
   src = (dst + 0.5) * H_in / H_out - 0.5, clamped at the edges, no
   antialiasing on downscale.

The 2x upsample is two matmuls with (out, in) interpolation matrices, as
in the JAX package: on the H100 that took 0.87 ms over UNet's four levels
at batch 8 in bf16, against 2.89 ms for ``F.interpolate``'s NHWC kernel
(PERF.md). As in JAX, the matrices are cast to the activation dtype and
the H pass is rounded to it before the W pass. The cv2 resize, once per
request on 3 channels, is ``F.interpolate(align_corners=False)``.

The JAX package's bucketed dynamic-extent resize
(``resize_bilinear_cv2_dynamic``) exists only to bound jit's compile cache;
eager PyTorch has none, so any source size is resized directly.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _interp_matrix_align_corners(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation matrix, align_corners=True."""
    a = np.zeros((n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        a[:, 0] = 1.0
        return a
    src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
    frac = (src - lo).astype(np.float32)
    a[np.arange(n_out), lo] = 1.0 - frac
    a[np.arange(n_out), lo + 1] += frac
    return a


@functools.lru_cache(maxsize=64)
def _upsample_matrices(h: int, w: int, dtype: torch.dtype,
                       device: torch.device):
    """(A_h, A_w) for a 2x upsample of an (h, w) plane, kept on the device
    (a few KB each; one pair per UNet level)."""
    return tuple(torch.from_numpy(_interp_matrix_align_corners(n, 2 * n))
                 .to(device, dtype) for n in (h, w))


def upsample2x_bilinear_align_corners(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale=2, bilinear, align_corners=True) on NHWC."""
    n, h, w, c = x.shape
    a_h, a_w = _upsample_matrices(h, w, x.dtype, x.device)
    y = torch.matmul(a_h, x.reshape(n, h, w * c))          # (n, 2h, w*c)
    y = torch.matmul(a_w, y.reshape(n * 2 * h, w, c))      # (n*2h, 2w, c)
    return y.reshape(n, 2 * h, 2 * w, c)


def resize_bilinear_cv2(x: torch.Tensor,
                        out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2.resize default bilinear (half-pixel) on NHWC float input."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)
