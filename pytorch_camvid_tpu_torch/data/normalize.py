"""Eval-time normalize (counterpart of pytorch_camvid_tpu/data/augment.py
``to_tensor_normalize`` / ``make_eval_normalize``, :476-483, :545-552):
the reference's ToTensor + Normalize (transforms.py:485-539) on NHWC."""

from __future__ import annotations

import torch


def to_tensor_normalize(images: torch.Tensor, mean, std,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(x - mean*255) / (std*255) per channel in f32, then cast to
    ``dtype``. images: (N,H,W,C) uint8 or float in [0, 255]; mean, std:
    per-channel sequences, or f32 tensors already on the images' device
    (no host-to-device copy per call)."""
    m = torch.as_tensor(mean, dtype=torch.float32,
                        device=images.device) * 255.0
    s = torch.as_tensor(std, dtype=torch.float32,
                        device=images.device) * 255.0
    return ((images.float() - m) / s).to(dtype)
