"""The shallow conv3x3 (pad 1) + per-channel affine + ReLU on the H-pair
kernel K5: counterpart of ``pytorch_camvid_tpu/ops/pallas_conv_pair.py``.

Same function as ``ops/fused_conv.py`` (K4), relu(conv3x3(x, W) * A + B),
computed by a kernel specialised for the full-resolution C <= 64 family,
in two instances by dtype:
- bf16 (``csrc/conv3x3_pair_bn_relu.cu``, wgmma fed by TMA): the whole
  weight tensor stays in shared memory, each tile is two pairs of output
  rows, and each A fragment of an input row feeds the three taps dy that
  read it;
- float32 (``csrc/conv3x3_f32.cu``, namespace ``k5``): the same reuse on
  the split-TF32 products of the f32 kernels (each operand split into a
  TF32 high part and residual, three products summed, step sums of four
  k8 steps added in f32), a block tile two pairs of output rows, one a
  consumer warpgroup, its weights split once per call into a workspace
  the wrapper allocates and streamed per (chunk, tap column) through a
  ring in shared memory (``tile_plan``).
No model path calls it, in the JAX package or here; ``perf_probe --pair``
times it.

- ``conv3x3_pair_bn_relu(x, w, a, b, relu=True)`` is the dispatching
  wrapper: a CPU tensor goes to the plain version; a CUDA tensor launches
  the kernel of its dtype or raises (it never falls back to K4 or to the
  plain version); any other device raises. H must be even on every
  device, as the JAX function asserts.
- ``conv3x3_pair(x, w, bias)``: the raw conv plus bias (a = 1, no ReLU).
- ``conv3x3_pair_bn_relu_plain``: the plain version, K4's (``F.conv2d`` in
  x's dtype, then the affine and ReLU in f32).
- ``conv3x3_pair_bn_relu.launches`` counts kernel launches, of both
  instances; ``.dtype_launches`` counts them by instance ("bf16", "f32").
- ``tile_plan(cin, dtype, cout)``: the kernel's shared-memory plan at
  ``cin`` (bf16) or ``cout`` (f32), the figures its source's
  ``static_assert``s hold.

The bf16 kernel takes bf16 x and w, f32 a and b, Cin a multiple of 16 up to
128, Cout a multiple of 16 up to 64, any W, and returns bf16. The f32 one
takes f32 x, w, a and b, Cin and Cout multiples of 4 (TMA's 16-byte rows)
with Cin <= 128 and Cout <= 64, any W, and returns f32. The TPU function's
``interpret``, ``tile_h2`` (its VMEM tile picker) and ``control_aligned``
(two measurement arms with deliberately wrong math, and "kstack", a second
TPU formulation of the same math) are not carried over, nor is
``_build_pair_taps``: the bf16 kernel reads the HWIO weight as it is.

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

from pytorch_camvid_tpu_torch.ops import cuda_build, fused_conv
from pytorch_camvid_tpu_torch.ops.fused_conv import (
    conv3x3_bn_relu_plain as conv3x3_pair_bn_relu_plain)

SOURCE = cuda_build.CSRC / "conv3x3_pair_bn_relu.cu"
F32_SOURCE = fused_conv.F32_SOURCE   # the f32 instance, namespace k5
MAX_CIN, MAX_COUT = 128, 64   # the kernels' limits
SMEM_LIMIT = 232448           # shared bytes one block may have on Hopper
DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}   # the instances
# the f32 instance's patch stage: 6 rows x 66 columns x 32 channels of f32,
# 1024-aligned
F32_PATCH = -(-6 * 66 * 32 * 4 // 1024) * 1024


def tile_plan(cin: int, dtype: torch.dtype = torch.bfloat16,
              cout: int = MAX_COUT) -> dict:
    """The kernel's shared-memory plan at ``cin`` (bf16) or ``cout``
    (float32).

    bf16: ``kc`` input channels per patch stage (32 up to Cin 64, 16
    above), ``stages`` (two per consumer warpgroup) and ``bytes``:
    alignment slack, the resident weights (9 taps x 64 x 64 bf16 per 64
    input channels), the output staging (8 warps x 2048), the stages (6 x
    66 pixels x kc bf16 each, 1024-aligned) and 9 mbarriers.

    float32: ``bn``, the tile N (all of Cout in 16, 32 or 64 channels),
    ``kc`` = 32 input channels a chunk, ``stages``, the patch stages and
    the weight stages, and ``bytes``: alignment slack, the patch stages (6
    x 66 pixels x 32 f32 each, 1024-aligned), the weight stages (a chunk's
    three taps dy of one tap column, hi and lo, bn x 32 f32 each) and 8
    mbarriers; no Cin limit of its own (the weights stream)."""
    if dtype == torch.float32:
        bn = 16 if cout <= 16 else 32 if cout <= 32 else 64
        stages = 2
        nbytes = (1024 + stages * F32_PATCH + stages * 6 * bn * 128
                  + 2 * 2 * stages * 8)
        return {"bn": bn, "kc": 32, "stages": stages, "bytes": nbytes}
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
    """What the kernel of x's dtype takes; raises on anything else."""
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"conv3x3_pair kernel takes bf16 or f32 x and w of "
                        f"one dtype, got {x.dtype} and {w.dtype}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("conv3x3_pair kernel takes f32 a and b")
    n, h, wd, cin = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be (3,3,{cin},Cout) HWIO, got "
                         f"{tuple(w.shape)}")
    cout = w.shape[3]
    m = 4 if x.dtype == torch.float32 else 16   # channels of 16 bytes
    if not (cin % m == 0 and m <= cin <= MAX_CIN and cout % m == 0
            and m <= cout <= MAX_COUT):
        raise ValueError(f"conv3x3_pair {DTYPES[x.dtype]} kernel takes Cin a "
                         f"multiple of {m} up to {MAX_CIN} and Cout a "
                         f"multiple of {m} up to {MAX_COUT}, got x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")
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


def _f32_launch(x, w, a, b, relu: bool) -> torch.Tensor:
    """One call of the f32 kernel on checked inputs (the weights' split,
    then the conv); returns its output."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    with torch.cuda.device(x.device):
        out = torch.empty((n, h, wd, cout), dtype=torch.float32,
                          device=x.device)
        ws = torch.empty(18 * cin * cout, dtype=torch.float32,
                         device=x.device)
        err = fused_conv.f32_library().conv3x3_pair_bn_relu_f32(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), ws.data_ptr(), n, h, wd, cin, cout, int(relu),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_pair f32 kernel launch failed: CUDA "
                           f"error {err} at x {tuple(x.shape)}, Cout {cout}")
    return out


def conv3x3_pair_bn_relu(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """Fused relu(conv3x3_pad1(x, w) * a + b). x: (N,H,W,Cin) NHWC
    contiguous with H even; w: (3,3,Cin,Cout) HWIO contiguous; a, b: (Cout,)
    f32.

    On a CPU tensor this is ``conv3x3_pair_bn_relu_plain``. On a CUDA tensor
    it launches K5 of x's dtype or raises: bf16 in and out with f32
    accumulation, or f32 in and out on split-TF32 products."""
    _check_even_h(x)
    if x.device.type == "cpu":
        return conv3x3_pair_bn_relu_plain(x, w, a, b, relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_pair_bn_relu: no kernel for {x.device}")
    _check(x, w, a, b)
    launch = _f32_launch if x.dtype == torch.float32 else _launch
    out = launch(x, w, a, b, relu)
    conv3x3_pair_bn_relu.launches += 1
    conv3x3_pair_bn_relu.dtype_launches[DTYPES[x.dtype]] += 1
    return out


def reset_launches() -> None:
    conv3x3_pair_bn_relu.launches = 0
    conv3x3_pair_bn_relu.dtype_launches = dict.fromkeys(DTYPES.values(), 0)


reset_launches()


def conv3x3_pair(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Raw conv3x3(pad 1) + bias on the pair kernel: no affine, no ReLU."""
    ones = torch.ones(w.shape[3], dtype=torch.float32, device=x.device)
    return conv3x3_pair_bn_relu(x, w, ones, bias.float(), relu=False)
