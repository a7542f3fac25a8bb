"""Fused conv3x3(pad 1) + folded BatchNorm + ReLU: the serving block.

Counterpart of ``pytorch_camvid_tpu/ops/pallas_conv.py`` (the TPU kernel
``_conv3x3_impl`` / ``_conv_kernel``). In eval mode BatchNorm is a
per-channel affine of the conv output, so the block is one pass:

    out = relu( conv3x3(x, W) * A + B ),   A = gamma / sqrt(var + eps)
                                           B = (b - mean) * A + beta

- ``conv3x3_bn_relu`` is the dispatching wrapper. A CUDA tensor goes to the
  hand-written Hopper kernel (``csrc/conv3x3_bn_relu.cu``), built with nvcc
  at first use and bound with ctypes; a CPU tensor goes to the plain
  version. Nothing falls back: a failed build or launch raises.
  ``flip=True`` computes the input gradient of a conv with weights ``w``
  (the taps reversed and the channel axes swapped, read in place by the
  kernel): the training conv's dx (``ops/conv_train.py``).
- The source has three paths, chosen by ``conv_path(Cin, Cout)`` (the
  .cu's ``conv3x3_bn_relu_path`` holds the same rule): "wgmma" (wgmma fed
  by TMA, for Cin % 8 == 0 with Cout % 8 == 0, or Cout <= 16 with Cin <=
  128: the head), "packed" (Cin % 8 != 0 with 9 * Cin <= ``K_MAX`` and Cout
  % 8 == 0: the Cin = 3 stem and the head's dx with Cin = 12, on the 9 taps
  x Cin packed into K with weights resident per block) and "narrow" (the
  first mma.sync design, for what neither takes, e.g. 64->20).
- ``conv3x3_bn_relu_plain`` is the same function from stock PyTorch ops.
  The CPU tests run it, and the card check compares the kernel with it.
- ``conv3x3_bn_relu.launches`` counts kernel launches, and
  ``conv3x3_bn_relu.path_launches`` counts them per path, so a run can show
  that its main path went through the kernel.

Tolerance against the JAX package's unfused eval path: JAX computes
``(conv + b - mean) * inv + bias`` (pytorch_camvid_tpu/ops/conv.py:195-198)
while this block computes ``conv * A + B`` with A and B folded once. The two
are algebraically equal and differ only in f32 rounding, a few ulps of the
largest intermediate per block, which sets the CPU tolerance between the JAX
``use_pallas=False`` model and the port (tests/test_torch_unet_serving.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from pytorch_camvid_tpu_torch.ops import cuda_build

BN_EPS = 1e-5  # torch.nn.BatchNorm2d default

SOURCE = cuda_build.CSRC / "conv3x3_bn_relu.cu"
PATHS = ("narrow", "wgmma", "packed")   # by the .cu's path code
RES_MAX_CIN = 128   # the wgmma path's N = 16 tile keeps 9 x Cin x 16 weights
K_MAX = 144         # the packed path's K: 9 taps x Cin


def conv_path(cin: int, cout: int) -> str:
    """The kernel path that takes a (Cin, Cout) call: "wgmma" where TMA can
    describe the input (Cin % 8 == 0) and the weights (Cout % 8 == 0), or
    where Cout <= 16 and Cin <= RES_MAX_CIN (resident weights, the 64->12
    head); "packed" where Cin % 8 != 0, 9 * Cin <= K_MAX and Cout % 8 == 0
    (the stem, the head's dx); "narrow" otherwise."""
    if cin % 8 == 0:
        tma = cin <= RES_MAX_CIN if cout <= 16 else cout % 8 == 0
        return "wgmma" if tma else "narrow"
    return "packed" if 9 * cin <= K_MAX and cout % 8 == 0 else "narrow"


def flipped(w: torch.Tensor) -> torch.Tensor:
    """(3,3,Cout,Cin) -> the (3,3,Cin,Cout) weight of the conv that
    ``flip=True`` computes: taps reversed, channel axes swapped (a copy;
    the plain version's, the kernel reads ``w`` in place)."""
    return w.flip((0, 1)).transpose(2, 3)


def fold_bn_affine(b: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor,
                   eps: float = BN_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold conv bias ``b`` and BN (``scale``=gamma, ``bias``=beta, running
    ``mean``/``var``) into the per-channel (A, B), in f32."""
    b, scale, bias, mean, var = (t.float() for t in (b, scale, bias, mean,
                                                     var))
    a = scale * torch.rsqrt(var + eps)
    return a, (b - mean) * a + bias


def conv3x3_bn_relu_plain(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                          b: torch.Tensor, relu: bool = True,
                          flip: bool = False) -> torch.Tensor:
    """relu(conv3x3_pad1(x, w) * a + b) from stock ops. x: (N,H,W,Cin);
    w: (3,3,Cin,Cout) HWIO, or with ``flip`` (3,3,Cout,Cin) taken as
    ``flipped(w)``; a, b: (Cout,) f32. Returns (N,H,W,Cout) in x's dtype;
    the conv runs in x's dtype, the epilogue in f32."""
    if flip:
        w = flipped(w)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 padding=1)
    y = y.permute(0, 2, 3, 1).float() * a + b
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    fn = lib.conv3x3_bn_relu_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.conv3x3_bn_relu_path.argtypes = [ctypes.c_int] * 2
    lib.conv3x3_bn_relu_path.restype = ctypes.c_int
    return lib


def kernel_path(cin: int, cout: int) -> str:
    """The path the built library takes for (Cin, Cout) (``conv_path``'s
    rule as the .cu holds it; chip_smoke checks that the two agree)."""
    return PATHS[_library().conv3x3_bn_relu_path(cin, cout)]


def _check(x, w, a, b, flip=False):
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"conv3x3_bn_relu kernel takes bf16 x and w, got "
                        f"{x.dtype} and {w.dtype}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("conv3x3_bn_relu kernel takes f32 a and b")
    if x.dim() != 4:
        raise ValueError(f"x must be (N,H,W,Cin), got {tuple(x.shape)}")
    cin = x.shape[3]
    cdim = 3 if flip else 2   # the axis of w that holds Cin
    if w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or w.shape[cdim] != cin:
        raise ValueError(
            f"w must be " + (f"(3,3,Cout,{cin}) with flip" if flip
                             else f"(3,3,{cin},Cout) HWIO")
            + f", got {tuple(w.shape)}")
    cout = w.shape[5 - cdim]
    if a.shape != (cout,) or b.shape != (cout,):
        raise ValueError(f"a and b must be ({cout},)")
    for name, t in (("x", x), ("w", w), ("a", a), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (x in NHWC)")
    if min(x.shape) == 0 or max(*x.shape, 9 * cin * cout) >= 2 ** 31:
        raise ValueError(f"unsupported shape x {tuple(x.shape)}, "
                         f"Cout {cout}")
    path = conv_path(cin, cout)
    if path == "wgmma" and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("x and w must be 16-byte aligned (TMA)")
    if path == "packed" and x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the packed path reads "
                         "its rows in 16-byte vectors)")


def conv3x3_bn_relu(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, relu: bool = True,
                    flip: bool = False) -> torch.Tensor:
    """Fused relu(conv3x3_pad1(x, w) * a + b). x: (N,H,W,Cin) NHWC
    contiguous; w: (3,3,Cin,Cout) HWIO contiguous, or with ``flip``
    (3,3,Cout,Cin), the weights of the conv whose input gradient this is;
    a, b: (Cout,) f32.

    On a CPU tensor this is ``conv3x3_bn_relu_plain``. On a CUDA tensor it
    launches the Hopper kernel (bf16 x and w, f32 accumulation, bf16 out)
    on ``conv_path(Cin, Cout)``, or raises."""
    if x.device.type == "cpu":
        return conv3x3_bn_relu_plain(x, w, a, b, relu, flip)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_bn_relu: no kernel for {x.device}")
    _check(x, w, a, b, flip)
    n, h, wd, cin = x.shape
    cout = a.shape[0]
    lib = _library()
    with torch.cuda.device(x.device):
        out = torch.empty((n, h, wd, cout), dtype=torch.bfloat16,
                          device=x.device)
        err = lib.conv3x3_bn_relu_bf16(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, h, wd, cin, cout, int(relu), int(flip),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_bn_relu kernel launch failed: CUDA "
                           f"error {err} at x {tuple(x.shape)}, Cout {cout}")
    conv3x3_bn_relu.launches += 1
    conv3x3_bn_relu.path_launches[conv_path(cin, cout)] += 1
    return out


def reset_launches() -> None:
    conv3x3_bn_relu.launches = 0
    conv3x3_bn_relu.path_launches = dict.fromkeys(PATHS, 0)


reset_launches()
