"""SegNet's 2x2 max pool with indices and its unpool on hand-written Hopper
kernels (``csrc/maxpool2x2.cu``): counterpart of
``pytorch_camvid_tpu/ops/pallas_pool.py``.

- K3, the eval pair: ``max_pool_2x2_argmax`` -> (pooled, flat int32 index)
  and ``max_unpool_2x2`` (the TPU's ``max_pool_2x2_argmax_pallas`` and
  ``max_unpool_2x2_pallas``).
- K2, the training pair: ``pool_phase_train`` -> (pooled, int8 phase) and
  ``unpool_phase_train``, ``torch.autograd.Function``s as the TPU's custom
  VJPs (``pool_phase_packed_train``, ``unpool_phase_packed_train``). The
  pool's backward is the phase unpool on the saved phase (it credits the
  whole gradient to the selected pixel, as the Pallas pair and torch's
  ``max_pool2d`` do); the unpool's backward is the phase gather. Their
  kernel wrappers are ``max_pool_2x2_phase``, ``max_unpool_2x2_phase`` and
  ``gather_phase``.

Each wrapper runs its plain version (``ops/pooling.py``) on a CPU tensor; on
a CUDA tensor it launches its kernel or raises, and counts the launch in
``.launches``. While tracing, the four forward wrappers are the ops
``camvid::max_pool_2x2_argmax``, ``max_unpool_2x2``, ``max_pool_2x2_phase``
and ``max_unpool_2x2_phase`` (``ops/library.py``), whose CUDA kernels are
the launchers ``launch_pool_argmax``, ``launch_unpool``,
``launch_pool_phase`` and ``launch_unpool_phase``. Kernel and plain
version agree bit for bit, NaN included (``ops/pooling.py`` states the
selection rule). bf16 and f32 are taken, and by K3 also int8 (the
int8-quantized SegNet's fused pool edges; ties go to the first maximum, as
on the other types).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from pytorch_camvid_tpu_torch.ops import cuda_build, pooling

SOURCE = cuda_build.CSRC / "maxpool2x2.cu"
_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}
K2_DTYPES = (torch.bfloat16, torch.float32)
K3_DTYPES = K2_DTYPES + (torch.int8,)


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(cuda_build.load(SOURCE))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C entry points of a library built from ``maxpool2x2.cu`` (or an
    edit of it, chip_faults.py), typed."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.maxpool2x2_pool.argtypes = [p] * 3 + [i] * 6 + [p]
    lib.maxpool2x2_unpool.argtypes = [p] * 3 + [i] * 8 + [p]
    lib.maxpool2x2_phase_gather.argtypes = [p] * 3 + [i] * 7 + [p]
    for fn in (lib.maxpool2x2_pool, lib.maxpool2x2_unpool,
               lib.maxpool2x2_phase_gather):
        fn.restype = ctypes.c_int
    return lib


def _on_cuda(name: str, x: torch.Tensor, *others: torch.Tensor,
             dtypes=K2_DTYPES) -> bool:
    """False for a CPU tensor (the caller runs the plain version); True
    when the kernel can take the tensors; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name} kernel takes "
                        f"{', '.join(str(d)[6:] for d in dtypes)}, got "
                        f"{x.dtype}")
    for t in (x,) + others:
        if t.dim() != 4:
            raise ValueError(f"{name}: tensors must be NHWC, got "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name}: a tensor is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous NHWC")
    return True


def _cuda_only(name: str, x: torch.Tensor, *others: torch.Tensor,
               dtypes=K2_DTYPES) -> None:
    """``_on_cuda``'s checks for a launcher, which takes CUDA tensors
    only."""
    if not _on_cuda(name, x, *others, dtypes=dtypes):
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{x.device}")


def _launch(name: str, fn, x: torch.Tensor, *args) -> None:
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"at {tuple(x.shape)} {x.dtype}")


def _pool(name: str, x: torch.Tensor, phase: bool):
    n, h, w, c = x.shape
    if h < 2 or w < 2:
        raise ValueError(f"{name}: H and W must be >= 2, got {tuple(x.shape)}")
    shape = (n, h // 2, w // 2, c)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    idx = torch.empty(shape, dtype=torch.int8 if phase else torch.int32,
                      device=x.device)
    _launch(name, _library().maxpool2x2_pool, x, x.data_ptr(),
            out.data_ptr(), idx.data_ptr(), _DTYPES[x.dtype], int(phase),
            n, h, w, c)
    return out, idx


def _unpool(name: str, x: torch.Tensor, idx: torch.Tensor,
            out_hw: Tuple[int, int], phase: bool) -> torch.Tensor:
    want = torch.int8 if phase else torch.int32
    if idx.dtype != want or idx.shape != x.shape:
        raise ValueError(f"{name}: index must be {want} of x's shape "
                         f"{tuple(x.shape)}, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    n, h2, w2, c = x.shape
    ho, wo = out_hw
    if not (2 * h2 <= ho and 2 * w2 <= wo):
        raise ValueError(f"{name}: out_hw {tuple(out_hw)} smaller than 2x "
                         f"{(h2, w2)}")
    out = torch.empty((n, ho, wo, c), dtype=x.dtype, device=x.device)
    _launch(name, _library().maxpool2x2_unpool, x, x.data_ptr(),
            idx.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], int(phase),
            n, h2, w2, c, ho, wo)
    return out


# ------------------------------------------------------------- K3 (eval)

def max_pool_2x2_argmax(x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled, flat int32 index y*W + x) of an NHWC tensor; odd sizes
    floor."""
    if torch.compiler.is_compiling():
        return torch.ops.camvid.max_pool_2x2_argmax(x)
    if x.device.type == "cpu":
        return pooling.max_pool_2x2_with_argmax(x)
    return launch_pool_argmax(x)


def launch_pool_argmax(x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    _cuda_only("max_pool_2x2_argmax", x, dtypes=K3_DTYPES)
    out = _pool("max_pool_2x2_argmax", x, phase=False)
    max_pool_2x2_argmax.launches += 1
    return out


def max_unpool_2x2(x: torch.Tensor, idx: torch.Tensor,
                   out_hw: Tuple[int, int]) -> torch.Tensor:
    """Each pooled value at its flat index in an (Ho, Wo) plane of zeros."""
    if torch.compiler.is_compiling():
        return torch.ops.camvid.max_unpool_2x2(x, idx, list(out_hw))
    if x.device.type == "cpu":
        return pooling.max_unpool_2x2(x, idx, out_hw)
    return launch_unpool(x, idx, out_hw)


def launch_unpool(x: torch.Tensor, idx: torch.Tensor,
                  out_hw: Tuple[int, int]) -> torch.Tensor:
    _cuda_only("max_unpool_2x2", x, idx, dtypes=K3_DTYPES)
    out = _unpool("max_unpool_2x2", x, idx, out_hw, phase=False)
    max_unpool_2x2.launches += 1
    return out


# ------------------------------------------------------------ K2 (train)

def max_pool_2x2_phase(x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled, int8 phase k = 2*dy + dx) of an NHWC tensor."""
    if torch.compiler.is_compiling():
        return torch.ops.camvid.max_pool_2x2_phase(x)
    if x.device.type == "cpu":
        return pooling.max_pool_2x2_argmax_phase(x)
    return launch_pool_phase(x)


def launch_pool_phase(x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    _cuda_only("max_pool_2x2_phase", x)
    out = _pool("max_pool_2x2_phase", x, phase=True)
    max_pool_2x2_phase.launches += 1
    return out


def max_unpool_2x2_phase(x: torch.Tensor, k: torch.Tensor,
                         out_hw: Tuple[int, int]) -> torch.Tensor:
    """The unpool from int8 phases, zero-padded to ``out_hw``; also the
    phase pool's backward."""
    if torch.compiler.is_compiling():
        return torch.ops.camvid.max_unpool_2x2_phase(x, k, list(out_hw))
    if x.device.type == "cpu":
        return pooling.max_unpool_2x2_from_phase(x, k, out_hw)
    return launch_unpool_phase(x, k, out_hw)


def launch_unpool_phase(x: torch.Tensor, k: torch.Tensor,
                        out_hw: Tuple[int, int]) -> torch.Tensor:
    _cuda_only("max_unpool_2x2_phase", x, k)
    out = _unpool("max_unpool_2x2_phase", x, k, out_hw, phase=True)
    max_unpool_2x2_phase.launches += 1
    return out


def gather_phase(g: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """out[n,i,j,c] = g[n, 2i+dy, 2j+dx, c]: the phase unpool's backward."""
    if not _on_cuda("gather_phase", g, k):
        return pooling.gather_phase(g, k)
    if k.dtype != torch.int8:
        raise ValueError(f"gather_phase: k must be int8, got {k.dtype}")
    n, h, w, c = g.shape
    _, h2, w2, ck = k.shape
    if k.shape[0] != n or ck != c or 2 * h2 > h or 2 * w2 > w:
        raise ValueError(f"gather_phase: k {tuple(k.shape)} does not fit g "
                         f"{tuple(g.shape)}")
    out = torch.empty(k.shape, dtype=g.dtype, device=g.device)
    _launch("gather_phase", _library().maxpool2x2_phase_gather, g,
            g.data_ptr(), k.data_ptr(), out.data_ptr(), _DTYPES[g.dtype],
            n, h, w, c, h2, w2)
    gather_phase.launches += 1
    return out


# JSON name of each wrapper's kernel (chip_smoke.py)
KERNELS = {"maxpool2x2.pool_flat": max_pool_2x2_argmax,
           "maxpool2x2.unpool_flat": max_unpool_2x2,
           "maxpool2x2.pool_phase": max_pool_2x2_phase,
           "maxpool2x2.unpool_phase": max_unpool_2x2_phase,
           "maxpool2x2.phase_gather": gather_phase}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


reset_launches()


# -------------------------------------------------------------- autograd

class _PoolPhaseTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        pooled, k = max_pool_2x2_phase(x.contiguous())
        ctx.mark_non_differentiable(k)
        ctx.save_for_backward(k)
        ctx.in_hw = (x.shape[1], x.shape[2])
        return pooled, k

    @staticmethod
    def backward(ctx, g, _gk):
        k, = ctx.saved_tensors
        return max_unpool_2x2_phase(g.contiguous(), k, ctx.in_hw)


class _UnpoolPhaseTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, out_hw):
        ctx.save_for_backward(k)
        return max_unpool_2x2_phase(x.contiguous(), k, out_hw)

    @staticmethod
    def backward(ctx, g):
        k, = ctx.saved_tensors
        return gather_phase(g.contiguous(), k), None, None


def pool_phase_train(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (pooled, int8 phase); the phase has no gradient."""
    return _PoolPhaseTrain.apply(x)


def unpool_phase_train(x: torch.Tensor, k: torch.Tensor,
                       out_hw: Tuple[int, int]) -> torch.Tensor:
    """Differentiable (in x) unpool from the phases of ``pool_phase_train``,
    zero-padded to ``out_hw``."""
    return _UnpoolPhaseTrain.apply(x, k, tuple(out_hw))
