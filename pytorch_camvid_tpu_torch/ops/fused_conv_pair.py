"""The shallow conv3x3 (pad 1) + per-channel affine + ReLU on the H-pair
kernel K5: counterpart of ``pytorch_camvid_tpu/ops/pallas_conv_pair.py``.

Same function as ``ops/fused_conv.py`` (K4), relu(conv3x3(x, W) * A + B),
computed by a kernel specialised for the full-resolution C <= 64 family
(``csrc/conv3x3_pair_bn_relu.cu``, wgmma fed by TMA): the whole weight
tensor stays in shared memory, each tile is two pairs of output rows, and
each A fragment of an input row feeds the three taps dy that read it. No
model path calls it, in the JAX package or here; ``perf_probe --pair``
times it.

- ``conv3x3_pair_bn_relu(x, w, a, b, relu=True)`` is the dispatching
  wrapper: a CPU tensor goes to the plain version; a CUDA tensor launches
  the kernel or raises (it never falls back to K4 or to the plain version);
  any other device raises. H must be even on every device, as the JAX
  function asserts.
- ``conv3x3_pair(x, w, bias)``: the raw conv plus bias (a = 1, no ReLU).
- ``conv3x3_pair_bn_relu_plain``: the plain version, K4's (``F.conv2d`` in
  x's dtype, then the affine and ReLU in f32).
- ``conv3x3_pair_bn_relu.launches`` counts kernel launches.
- ``tile_plan(cin)``: the kernel's shared-memory plan at ``cin`` (input
  channels per patch stage, stages, bytes), the figures the source's
  ``smem_bytes`` computes and its ``static_assert``s hold.

The kernel takes bf16 x and w, f32 a and b, Cin a multiple of 16 up to 128,
Cout a multiple of 16 up to 64, any W, and returns bf16. The TPU function's
``interpret``, ``tile_h2`` (its VMEM tile picker) and ``control_aligned``
(two measurement arms with deliberately wrong math, and "kstack", a second
TPU formulation of the same math) are not carried over, nor is
``_build_pair_taps``: the Hopper kernel reads the HWIO weight as it is.

Against JAX on the CPU: JAX's interpret-mode kernel accumulates in f32 and
rounds once, after the affine. The plain version's bf16 conv rounds its
output to bf16 before the f32 epilogue, so in bf16 the two differ by about
two bf16 roundings (2**-8 each) of the output's scale; in f32 only the
summation order differs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pytorch_camvid_tpu_torch.ops import cuda_build
from pytorch_camvid_tpu_torch.ops.fused_conv import (
    conv3x3_bn_relu_plain as conv3x3_pair_bn_relu_plain)

SOURCE = cuda_build.CSRC / "conv3x3_pair_bn_relu.cu"
MAX_CIN, MAX_COUT = 128, 64   # the kernel's limits (multiples of 16)
SMEM_LIMIT = 232448           # shared bytes one block may have on Hopper


def tile_plan(cin: int) -> dict:
    """The kernel's shared-memory plan at ``cin``: ``kc`` input channels
    per patch stage (32 up to Cin 64, 16 above), ``stages`` (two per
    consumer warpgroup) and ``bytes``: alignment slack, the resident
    weights (9 taps x 64 x 64 bf16 per 64 input channels), the output
    staging (8 warps x 2048), the stages (6 x 66 pixels x kc bf16 each,
    1024-aligned) and 9 mbarriers."""
    kc = 32 if cin <= 64 else 16
    stage = -(-6 * 66 * kc * 2 // 1024) * 1024
    stages = 4
    nbytes = (1024 + -(-cin // 64) * 9 * 64 * 64 * 2 + 8 * 2048
              + stages * stage + 9 * 8)
    return {"kc": kc, "stages": stages, "bytes": nbytes}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    fn = lib.conv3x3_pair_bn_relu_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check_even_h(x: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[1] % 2:
        raise ValueError(f"conv3x3_pair takes NHWC x with even H, got "
                         f"{tuple(x.shape)}")


def _check(x, w, a, b) -> None:
    """What the kernel takes; raises on anything else."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"conv3x3_pair kernel takes bf16 x and w, got "
                        f"{x.dtype} and {w.dtype}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("conv3x3_pair kernel takes f32 a and b")
    n, h, wd, cin = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be (3,3,{cin},Cout) HWIO, got "
                         f"{tuple(w.shape)}")
    cout = w.shape[3]
    if not (cin % 16 == 0 and 16 <= cin <= MAX_CIN and cout % 16 == 0
            and 16 <= cout <= MAX_COUT):
        raise ValueError(f"conv3x3_pair kernel takes Cin a multiple of 16 "
                         f"up to {MAX_CIN} and Cout a multiple of 16 up to "
                         f"{MAX_COUT}, got x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    if a.shape != (cout,) or b.shape != (cout,):
        raise ValueError(f"a and b must be ({cout},)")
    for name, t in (("x", x), ("w", w), ("a", a), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (x in NHWC)")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned")
    if min(n, h, wd) == 0 or max(n, h, wd) >= 2 ** 31:
        raise ValueError(f"unsupported shape x {tuple(x.shape)}")


def _launch(x, w, a, b, relu: bool) -> torch.Tensor:
    """One launch of the kernel on checked inputs; returns its output."""
    n, h, wd, _ = x.shape
    cout = w.shape[3]
    with torch.cuda.device(x.device):
        out = torch.empty((n, h, wd, cout), dtype=torch.bfloat16,
                          device=x.device)
        err = _library().conv3x3_pair_bn_relu_bf16(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, h, wd, x.shape[3], cout, int(relu),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_pair kernel launch failed: CUDA error "
                           f"{err} at x {tuple(x.shape)}, Cout {cout}")
    return out


def conv3x3_pair_bn_relu(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """Fused relu(conv3x3_pad1(x, w) * a + b). x: (N,H,W,Cin) NHWC
    contiguous with H even; w: (3,3,Cin,Cout) HWIO contiguous; a, b: (Cout,)
    f32.

    On a CPU tensor this is ``conv3x3_pair_bn_relu_plain``. On a CUDA tensor
    it launches K5 (bf16 in and out, f32 accumulation) or raises."""
    _check_even_h(x)
    if x.device.type == "cpu":
        return conv3x3_pair_bn_relu_plain(x, w, a, b, relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_pair_bn_relu: no kernel for {x.device}")
    _check(x, w, a, b)
    out = _launch(x, w, a, b, relu)
    conv3x3_pair_bn_relu.launches += 1
    return out


conv3x3_pair_bn_relu.launches = 0


def conv3x3_pair(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Raw conv3x3(pad 1) + bias on the pair kernel: no affine, no ReLU."""
    ones = torch.ones(w.shape[3], dtype=torch.float32, device=x.device)
    return conv3x3_pair_bn_relu(x, w, ones, bias.float(), relu=False)
