"""2x2/stride-2 max pool (counterpart of
pytorch_camvid_tpu/ops/pooling.py:32 ``max_pool_2x2``; reference
``nn.MaxPool2d(2, 2)``, models/unet.py:92). SegNet's pool with indices and
the unpool come with SegNet (ROADMAP.md)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """NHWC max pool; odd spatial sizes floor like torch (45 -> 22)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
