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
the H pass is rounded to it before the W pass. The cv2 resize uses the
JAX package's half-pixel matrices: source coordinates in f64, weights
rounded once to f32 (JAX resize.py:44-68). Each row has at most two
nonzero weights; the port applies them as two gathers and
``w0 * x0 + w1 * x1``, which rounds each product and then the sum, exactly
as XLA's f32 dot does. A CPU matmul contracts with FMA instead and lands an
ulp away on 12% of the H pass's values, which flips 0.26% of the uint8
bytes the serving path rounds to (480x640 -> 360x480).

``resize_nearest_cv2`` is cv2's INTER_NEAREST (``floor(dst * in / out)``),
the mask's resize (JAX resize.py:134-148).

The JAX package's bucketed dynamic-extent resize
(``resize_bilinear_cv2_dynamic``) exists only to bound jit's compile cache;
eager PyTorch has none, so any source size is resized directly.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


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
    (a few KB each; one pair per UNet level). Made outside inference mode
    even when first asked for while serving, so that training can save
    them for its backward."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(
            _interp_matrix_align_corners(n, 2 * n)).to(device, dtype)
            for n in (h, w))


def upsample2x_bilinear_align_corners(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale=2, bilinear, align_corners=True) on NHWC."""
    n, h, w, c = x.shape
    a_h, a_w = _upsample_matrices(h, w, x.dtype, x.device)
    y = torch.matmul(a_h, x.reshape(n, h, w * c))          # (n, 2h, w*c)
    y = torch.matmul(a_w, y.reshape(n * 2 * h, w, c))      # (n*2h, 2w, c)
    return y.reshape(n, 2 * h, 2 * w, c)


@functools.lru_cache(maxsize=64)
def _half_pixel_taps(n_in: int, n_out: int, dtype: torch.dtype,
                     device: torch.device):
    """The two taps of each row of cv2's half-pixel matrix, edge taps
    clamped: (i0, i1) source indices and (w0, w1) weights. Where both taps
    clamp to one index, w0 is the matrix entry (1 - frac) + frac and w1 = 0.
    Made outside inference mode, like the upsample matrices."""
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = (src - lo).astype(np.float32)
    i0 = np.clip(lo, 0, n_in - 1)
    i1 = np.clip(lo + 1, 0, n_in - 1)
    one_tap = i0 == i1
    w0 = (np.float32(1.0) - frac) + np.where(one_tap, frac, np.float32(0))
    w1 = np.where(one_tap, np.float32(0), frac)
    with torch.inference_mode(False):
        return (torch.from_numpy(i0).to(device),
                torch.from_numpy(i1).to(device),
                torch.from_numpy(w0).to(device, dtype),
                torch.from_numpy(w1).to(device, dtype))


def _two_tap(x: torch.Tensor, dim: int, taps) -> torch.Tensor:
    i0, i1, w0, w1 = taps
    shape = [1] * x.dim()
    shape[dim] = -1
    return (x.index_select(dim, i0) * w0.view(shape)
            + x.index_select(dim, i1) * w1.view(shape))


def resize_bilinear_cv2(x: torch.Tensor,
                        out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2.resize default bilinear (half-pixel) on NHWC float input."""
    (h, w), (ho, wo) = x.shape[1:3], out_hw
    if (h, w) == (ho, wo):
        return x
    y = _two_tap(x, 1, _half_pixel_taps(h, ho, x.dtype, x.device))
    return _two_tap(y, 2, _half_pixel_taps(w, wo, x.dtype, x.device))


@functools.lru_cache(maxsize=64)
def _nearest_indices_cv2(n_in: int, n_out: int,
                         device: torch.device) -> torch.Tensor:
    """cv2 INTER_NEAREST's source index of each output position,
    ``floor(dst * n_in / n_out)`` in f64, clamped (JAX resize.py:134-138).
    Made outside inference mode, like the taps above."""
    idx = np.floor(np.arange(n_out) * (n_in / n_out)).astype(np.int64)
    with torch.inference_mode(False):
        return torch.from_numpy(np.clip(idx, 0, n_in - 1)).to(device)


def resize_nearest_cv2(x: torch.Tensor,
                       out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2.resize INTER_NEAREST on NHW[C] tensors of any dtype (masks)."""
    (h, w), (ho, wo) = x.shape[1:3], out_hw
    if (h, w) == (ho, wo):
        return x
    y = x.index_select(1, _nearest_indices_cv2(h, ho, x.device))
    return y.index_select(2, _nearest_indices_cv2(w, wo, x.device))
