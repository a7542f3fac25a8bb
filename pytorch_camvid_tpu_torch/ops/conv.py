"""Conv3x3 + BatchNorm + ReLU block (counterpart of
pytorch_camvid_tpu/ops/conv.py:93-198).

Parameters live in ``self.conv = Sequential(Conv2d, BatchNorm2d, ReLU)``,
the reference's ``BasicConv2d`` layout (models/unet.py:5-17), so a reference
state_dict loads with ``strict=True``.

- Eval mode: one fused pass, ``ops/fused_conv.py::conv3x3_bn_relu``, with BN
  folded into (A, B). On CUDA that is always the Hopper kernel. The weight
  in the kernel's layout (HWIO, compute dtype, contiguous) and the folded
  (A, B) are prepared once and cached: ``prepare(dtype)`` fills the cache
  ahead of serving, and ``train()`` / ``eval()`` or loading a state_dict
  clears it. Edit weights in place only in train mode, or call ``eval()``
  again afterwards.
- Train mode: the plain conv plus ``F.batch_norm`` with batch statistics
  (torch's biased/unbiased variance convention, momentum 0.1). It is kept
  for the parity tests; training is not ported yet (ROADMAP.md).

Tensors are NHWC at this interface, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from pytorch_camvid_tpu_torch.ops.fused_conv import (
    conv3x3_bn_relu, conv3x3_bn_relu_plain, fold_bn_affine)
from pytorch_camvid_tpu_torch.ops.initializers import conv_init_


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1),
                                  nn.BatchNorm2d(cout), nn.ReLU())
        conv_init_(self.conv[0], generator)
        self._kernel_args: Optional[Tuple[torch.Tensor, ...]] = None

    def train(self, mode: bool = True):
        self._kernel_args = None
        return super().train(mode)

    def _load_from_state_dict(self, *args, **kwargs):
        self._kernel_args = None
        super()._load_from_state_dict(*args, **kwargs)

    @torch.no_grad()
    def prepare(self, dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
        """(w HWIO in ``dtype``, A, B f32) for the fused kernel, cached."""
        conv, bn = self.conv[0], self.conv[1]
        cached = self._kernel_args
        if (cached is None or cached[0].dtype != dtype
                or cached[0].device != conv.weight.device):
            w = conv.weight.permute(2, 3, 1, 0).to(dtype).contiguous()
            a, b = fold_bn_affine(conv.bias, bn.weight, bn.bias,
                                  bn.running_mean, bn.running_var, bn.eps)
            cached = self._kernel_args = (w, a, b)
        return cached

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """x: (N,H,W,Cin) -> (N,H,W,Cout) in x's dtype. ``plain=True``
        (eval only) runs the plain version on any device: the reference the
        kernel path is checked against."""
        if self.training:
            y = self.conv(x.permute(0, 3, 1, 2))
            return y.permute(0, 2, 3, 1)
        w, a, b = self.prepare(x.dtype)
        fn = conv3x3_bn_relu_plain if plain else conv3x3_bn_relu
        return fn(x.contiguous(), w, a, b)
