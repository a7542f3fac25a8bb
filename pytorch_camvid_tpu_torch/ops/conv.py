"""Conv3x3 + BatchNorm + ReLU block (counterpart of
pytorch_camvid_tpu/ops/conv.py:93-198).

Two parameter layouts, one forward: ``ConvBNReLU`` keeps UNet's
``self.conv = Sequential(Conv2d, BatchNorm2d, ReLU)``, the reference's
``BasicConv2d`` (models/unet.py:5-17); ``BasicConv`` keeps SegNet's
``self.conv = Conv2d`` and ``self.bn = BatchNorm2d``, the reference's
``BasicConv`` (models/segnet.py). So a reference state_dict of either model
loads with ``strict=True``. Neither module is ever called: both modes below
compute from the (conv, bn) pair that ``conv_bn()`` returns.

- Eval mode: one fused pass, ``ops/fused_conv.py::conv3x3_bn_relu``, with BN
  folded into (A, B). On CUDA that is always the Hopper kernel. The weight
  in the kernel's layout (HWIO, compute dtype, contiguous) and the folded
  (A, B) are prepared once and cached: ``prepare(dtype)`` fills the cache
  ahead of serving, and ``train()`` / ``eval()`` or loading a state_dict
  clears it. Edit weights in place only in train mode, or call ``eval()``
  again afterwards.
- Train mode: JAX's arithmetic at JAX's dtype boundaries
  (``conv_bn_relu_apply(train=True, use_pallas=True)``): the conv on
  ``ops/conv_train.py::conv3x3_train`` (K1) in the input's dtype, the conv
  bias added in that dtype, then in f32 the batch moments
  ``mean = E[y]``, ``var = E[y^2] - E[y]^2``, the normalization
  ``(y - mean) * rsqrt(var + eps) * scale + bias`` and the ReLU, cast back
  to the input's dtype. The ReLU is ``maximum(y, 0)``, whose gradient at a
  tie is split in half in both frameworks. The running stats are updated in
  place with momentum 0.1 and the unbiased variance ``var * n / (n - 1)``,
  except inside ``recomputing()``: there the block is a checkpoint's
  recompute of a forward that already updated them (``models/common.py::
  remat_call``), with the same batch, so the same statistics.

Tensors are NHWC at this interface, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch
import torch.nn as nn

from pytorch_camvid_tpu_torch.ops.conv_train import conv3x3_train
from pytorch_camvid_tpu_torch.ops.fused_conv import (
    conv3x3_bn_relu, conv3x3_bn_relu_plain, fold_bn_affine)
from pytorch_camvid_tpu_torch.ops.initializers import conv_init_

BN_MOMENTUM = 0.1  # torch: running = (1 - m) * running + m * batch

_recompute = threading.local()


@contextlib.contextmanager
def recomputing():
    """Inside the block, train-mode blocks compute as before but leave
    their BN running stats and counts alone. The flag is the thread's: the
    autograd engine recomputes on the thread of the backward."""
    before = getattr(_recompute, "on", False)
    _recompute.on = True
    try:
        yield
    finally:
        _recompute.on = before


def is_recomputing() -> bool:
    return getattr(_recompute, "on", False)


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._build(cin, cout)
        conv_init_(self.conv_bn()[0], generator)
        self._kernel_args: Optional[Tuple[torch.Tensor, ...]] = None

    def _build(self, cin: int, cout: int) -> None:
        self.conv = nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1),
                                  nn.BatchNorm2d(cout), nn.ReLU())

    def conv_bn(self) -> Tuple[nn.Conv2d, nn.BatchNorm2d]:
        return self.conv[0], self.conv[1]

    def train(self, mode: bool = True):
        self._kernel_args = None
        return super().train(mode)

    def _load_from_state_dict(self, *args, **kwargs):
        self._kernel_args = None
        super()._load_from_state_dict(*args, **kwargs)

    @torch.no_grad()
    def prepare(self, dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
        """(w HWIO in ``dtype``, A, B f32) for the fused kernel, cached."""
        conv, bn = self.conv_bn()
        cached = self._kernel_args
        if (cached is None or cached[0].dtype != dtype
                or cached[0].device != conv.weight.device):
            w = conv.weight.permute(2, 3, 1, 0).to(dtype).contiguous()
            a, b = fold_bn_affine(conv.bias, bn.weight, bn.bias,
                                  bn.running_mean, bn.running_var, bn.eps)
            cached = self._kernel_args = (w, a, b)
        return cached

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """x: (N,H,W,Cin) -> (N,H,W,Cout) in x's dtype. ``plain=True`` runs
        the plain versions of the kernels on any device: the reference the
        kernel path is checked against."""
        if self.training:
            return self._train_forward(x, plain)
        w, a, b = self.prepare(x.dtype)
        fn = conv3x3_bn_relu_plain if plain else conv3x3_bn_relu
        return fn(x.contiguous(), w, a, b)

    def _train_forward(self, x: torch.Tensor, plain: bool) -> torch.Tensor:
        conv, bn = self.conv_bn()
        dt = x.dtype
        w = conv.weight.permute(2, 3, 1, 0).to(dt).contiguous()
        y = conv3x3_train(x.contiguous(), w, plain)
        y = (y + conv.bias.to(dt)).float()
        mean = y.mean(dim=(0, 1, 2))
        var = (y * y).mean(dim=(0, 1, 2)) - mean * mean
        if not is_recomputing():
            with torch.no_grad():
                n = y.shape[0] * y.shape[1] * y.shape[2]
                bn.running_mean.copy_((1 - BN_MOMENTUM) * bn.running_mean
                                      + BN_MOMENTUM * mean)
                bn.running_var.copy_(
                    (1 - BN_MOMENTUM) * bn.running_var
                    + BN_MOMENTUM * (var * (n / max(n - 1, 1))))
                bn.num_batches_tracked += 1
        inv = torch.rsqrt(var + bn.eps) * bn.weight
        y = (y - mean) * inv + bn.bias
        return torch.maximum(y, y.new_zeros(())).to(dt)


class BasicConv(ConvBNReLU):
    """SegNet's block: the same forward under ``.conv`` (Conv2d) and
    ``.bn`` (BatchNorm2d)."""

    def _build(self, cin: int, cout: int) -> None:
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)
        self.bn = nn.BatchNorm2d(cout)

    def conv_bn(self) -> Tuple[nn.Conv2d, nn.BatchNorm2d]:
        return self.conv, self.bn
