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
- Sync-BN (JAX ``ops/conv.py:172-179``, ``axis_name``): inside
  ``syncing(mesh)`` a train-mode block takes the mean of its E[y] and
  E[y^2] over the mesh's ranks as one 2·Cout f32 vector
  (``parallel/mesh.py::Mesh.pmean``: a sum in the forward, a sum of the
  gradient in the backward, each divided by the world), and the running
  variance's n counts every rank's pixels. The mesh reaches the blocks
  through this context, not through the models' arguments; a stage's
  recompute under remat runs in the same context (``models/common.py::
  remat_contexts``), so it issues the forward's all-reduces again.
- Calibration (JAX ``ops/conv.py:188-193``): inside ``calibrating()`` an
  eval-mode block runs its ordinary forward and also records the running
  max|input| in f32 (``calib_amax``, which ``ops/quant.py::calibrate``
  sets up and reads).
- int8 (``set_quantized``, from ``ops/quant.py::quantize_model``; JAX's
  ``w_q`` dispatch, ``ops/conv.py:137-141``): the block keeps ``w_q``
  (HWIO int8), ``s_w``, ``s_x``, ``b_eff``, the optional ``s_out`` and the
  kernel's packed weights ``w_k`` as non-persistent buffers, so
  ``.to(device)`` moves them and the reference-named state_dict stays as it
  is, and runs ``quant.quantized_block_apply`` (``conv3x3_int8`` on CUDA).
  It takes an int8 input from its producer as it is and emits int8 where it
  has ``s_out``, else the compute dtype: the input's, or for an int8 input
  the one the model's forward set (``computing_in``). In train mode it
  raises; loading a state_dict makes it a float block again.

Tensors are NHWC at this interface, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch
import torch.nn as nn

from pytorch_camvid_tpu_torch.ops import library  # noqa: F401 (camvid:: ops)
from pytorch_camvid_tpu_torch.ops.conv_train import conv3x3_train
from pytorch_camvid_tpu_torch.ops.fused_conv import (
    conv3x3_bn_relu, conv3x3_bn_relu_plain, fold_bn_affine)
from pytorch_camvid_tpu_torch.ops.initializers import conv_init_

BN_MOMENTUM = 0.1  # torch: running = (1 - m) * running + m * batch

_recompute = threading.local()
_calibrate = threading.local()
_compute = threading.local()
_sync = threading.local()


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


@contextlib.contextmanager
def syncing(mesh):
    """Inside the block, train-mode blocks take their batch moments over
    the ranks of ``mesh`` (sync-BN); ``None`` keeps them local."""
    before = getattr(_sync, "mesh", None)
    _sync.mesh = mesh
    try:
        yield
    finally:
        _sync.mesh = before


def sync_mesh():
    """The mesh of the enclosing ``syncing`` block, or None."""
    return getattr(_sync, "mesh", None)


@contextlib.contextmanager
def calibrating():
    """Inside the block, eval-mode float blocks also record the running
    max|input| (``ops/quant.py::calibrate``)."""
    before = getattr(_calibrate, "on", False)
    _calibrate.on = True
    try:
        yield
    finally:
        _calibrate.on = before


@contextlib.contextmanager
def computing_in(dtype: torch.dtype):
    """The compute dtype of a model's forward, for int8 blocks whose
    input is int8 and whose output is not (the models enter this with
    their input's dtype)."""
    before = getattr(_compute, "dtype", None)
    _compute.dtype = dtype
    try:
        yield
    finally:
        _compute.dtype = before


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._build(cin, cout)
        conv_init_(self.conv_bn()[0], generator)
        self._kernel_args: Optional[Tuple[torch.Tensor, ...]] = None
        self.calib_amax: Optional[torch.Tensor] = None
        self.quantized = False

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
        self.clear_quantized()
        super()._load_from_state_dict(*args, **kwargs)

    _QBUFFERS = ("w_q", "s_w", "s_x", "b_eff", "s_out", "w_k")

    @torch.no_grad()
    def set_quantized(self, w_q: torch.Tensor, s_w: torch.Tensor,
                      s_x: torch.Tensor, b_eff: torch.Tensor,
                      s_out: Optional[torch.Tensor] = None) -> None:
        """Make this an int8 block: ``w_q`` (3,3,Cin,Cout) int8, ``s_w``
        and ``b_eff`` (Cout,) f32, ``s_x`` and ``s_out`` f32 scalars; the
        kernel's packed weights are made here, once."""
        from pytorch_camvid_tpu_torch.ops.fused_conv_int8 import pack_weights
        conv = self.conv_bn()[0]
        if tuple(w_q.shape) != (3, 3, conv.in_channels, conv.out_channels):
            raise ValueError(f"w_q {tuple(w_q.shape)} does not fit the "
                             f"block's {conv.in_channels}->"
                             f"{conv.out_channels}")
        dev = conv.weight.device
        for name, t in (("w_q", w_q), ("s_w", s_w), ("s_x", s_x),
                        ("b_eff", b_eff), ("s_out", s_out)):
            if t is not None:
                t = t.to(dev, torch.int8 if name == "w_q"
                         else torch.float32).contiguous()
            self.register_buffer(name, t, persistent=False)
        self.register_buffer("w_k", pack_weights(self.w_q), persistent=False)
        self.quantized = True
        self._kernel_args = None   # K4's layout is not used any more

    def clear_quantized(self) -> None:
        """Back to the float block (its float weights were kept)."""
        if self.quantized:
            for name in self._QBUFFERS:
                delattr(self, name)
            self.quantized = False

    def qparams(self) -> dict:
        """The int8 block's params as ``quant.quantized_block_apply``
        takes them."""
        p = {name: getattr(self, name) for name in self._QBUFFERS}
        if p["s_out"] is None:
            del p["s_out"]
        return p

    def prepare(self, dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
        """(w HWIO in ``dtype``, A, B f32) for the fused kernel, cached. A
        traced forward takes the cached tensors as they are (its program's
        constants); where there are none it builds them in its graph and
        caches nothing."""
        conv, bn = self.conv_bn()
        cached = self._kernel_args
        if (cached is not None and cached[0].dtype == dtype
                and cached[0].device == conv.weight.device):
            return cached
        with torch.no_grad():
            w = conv.weight.permute(2, 3, 1, 0).to(dtype).contiguous()
            a, b = fold_bn_affine(conv.bias, bn.weight, bn.bias,
                                  bn.running_mean, bn.running_var, bn.eps)
        if not torch.compiler.is_compiling():
            self._kernel_args = (w, a, b)
        return w, a, b

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """x: (N,H,W,Cin) -> (N,H,W,Cout) in x's dtype. ``plain=True`` runs
        the plain versions of the kernels on any device: the reference the
        kernel path is checked against."""
        if self.quantized:
            return self._int8_forward(x, plain)
        if self.training:
            return self._train_forward(x, plain)
        if getattr(_calibrate, "on", False):
            self.calib_amax = torch.maximum(self.calib_amax,
                                            x.abs().amax().float())
        w, a, b = self.prepare(x.dtype)
        fn = conv3x3_bn_relu_plain if plain else conv3x3_bn_relu
        return fn(x.contiguous(), w, a, b)

    def _int8_forward(self, x: torch.Tensor, plain: bool) -> torch.Tensor:
        from pytorch_camvid_tpu_torch.ops.quant import quantized_block_apply
        if self.training:
            raise RuntimeError("int8-quantized blocks are serving-only: "
                               "call eval() first")
        dtype = x.dtype
        if dtype == torch.int8:
            dtype = getattr(_compute, "dtype", None)
            if dtype is None and self.s_out is None:
                raise ValueError("an int8 input to a block that emits the "
                                 "compute dtype needs computing_in(dtype) "
                                 "(the models' forwards set it)")
        return quantized_block_apply(self.qparams(), x, dtype, plain)

    def _train_forward(self, x: torch.Tensor, plain: bool) -> torch.Tensor:
        conv, bn = self.conv_bn()
        dt = x.dtype
        w = conv.weight.permute(2, 3, 1, 0).to(dt).contiguous()
        y = conv3x3_train(x.contiguous(), w, plain)
        y = (y + conv.bias.to(dt)).float()
        mean = y.mean(dim=(0, 1, 2))
        sq = (y * y).mean(dim=(0, 1, 2))
        n = y.shape[0] * y.shape[1] * y.shape[2]
        mesh = sync_mesh()
        if mesh is not None:
            mean, sq = mesh.pmean(torch.cat([mean, sq])).chunk(2)
            n *= mesh.world
        var = sq - mean * mean
        if not is_recomputing():
            # on detached moments, so no grad mode is switched (a traced
            # forward records no set_grad_enabled around the update)
            m, v = mean.detach(), var.detach()
            bn.running_mean.copy_((1 - BN_MOMENTUM) * bn.running_mean
                                  + BN_MOMENTUM * m)
            bn.running_var.copy_((1 - BN_MOMENTUM) * bn.running_var
                                 + BN_MOMENTUM * (v * (n / max(n - 1, 1))))
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
