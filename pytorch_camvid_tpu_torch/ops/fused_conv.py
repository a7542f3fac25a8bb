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
- ``conv3x3_bn_relu_plain`` is the same function from stock PyTorch ops.
  The CPU tests run it, and the card check compares the kernel with it.
- ``conv3x3_bn_relu.launches`` counts kernel launches, so a run can show
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
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5  # torch.nn.BatchNorm2d default

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "conv3x3_bn_relu.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
                          b: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """relu(conv3x3_pad1(x, w) * a + b) from stock ops. x: (N,H,W,Cin);
    w: (3,3,Cin,Cout) HWIO; a, b: (Cout,) f32. Returns (N,H,W,Cout) in
    x's dtype; the conv runs in x's dtype, the epilogue in f32."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 padding=1)
    y = y.permute(0, 2, 3, 1).float() * a + b
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("conv3x3_bn_relu: nvcc not found (set CUDA_HOME); "
                       "the CUDA kernel is built from csrc/ at first use")


def build() -> Tuple[Path, float, str]:
    """Compile ``csrc/conv3x3_bn_relu.cu`` for sm_90a into ``_build/``,
    keyed by a hash of the source and flags. Returns (library path, build
    seconds (0 when already built), nvcc's output incl. ptxas -v)."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"conv3x3_bn_relu_{key[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"conv3x3_bn_relu: nvcc failed "
                           f"(rc {r.returncode}):\n{r.stdout}{r.stderr}")
    log.write_text(r.stdout + r.stderr)
    os.replace(tmp, lib)
    return lib, dt, r.stdout + r.stderr


@functools.cache
def _library() -> ctypes.CDLL:
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.conv3x3_bn_relu_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(x, w, a, b):
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"conv3x3_bn_relu kernel takes bf16 x and w, got "
                        f"{x.dtype} and {w.dtype}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("conv3x3_bn_relu kernel takes f32 a and b")
    if x.dim() != 4:
        raise ValueError(f"x must be (N,H,W,Cin), got {tuple(x.shape)}")
    cin = x.shape[3]
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be (3,3,{cin},Cout) HWIO, got "
                         f"{tuple(w.shape)}")
    cout = w.shape[3]
    if a.shape != (cout,) or b.shape != (cout,):
        raise ValueError(f"a and b must be ({cout},)")
    for name, t in (("x", x), ("w", w), ("a", a), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (x in NHWC)")
    if min(x.shape) == 0 or max(*x.shape, cout) >= 2 ** 31:
        raise ValueError(f"unsupported shape x {tuple(x.shape)}, "
                         f"Cout {cout}")


def conv3x3_bn_relu(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """Fused relu(conv3x3_pad1(x, w) * a + b). x: (N,H,W,Cin) NHWC
    contiguous; w: (3,3,Cin,Cout) HWIO contiguous; a, b: (Cout,) f32.

    On a CPU tensor this is ``conv3x3_bn_relu_plain``. On a CUDA tensor it
    launches the Hopper kernel (bf16 x and w, f32 accumulation, bf16 out)
    or raises."""
    if x.device.type == "cpu":
        return conv3x3_bn_relu_plain(x, w, a, b, relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_bn_relu: no kernel for {x.device}")
    _check(x, w, a, b)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    lib = _library()
    with torch.cuda.device(x.device):
        out = torch.empty((n, h, wd, cout), dtype=torch.bfloat16,
                          device=x.device)
        err = lib.conv3x3_bn_relu_bf16(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, h, wd, cin, cout, int(relu),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_bn_relu kernel launch failed: CUDA "
                           f"error {err} at x {tuple(x.shape)}, Cout {cout}")
    conv3x3_bn_relu.launches += 1
    return out


conv3x3_bn_relu.launches = 0
