"""2x2/stride-2 max pooling: UNet's pool, and SegNet's pool with indices and
its index unpool (counterpart of pytorch_camvid_tpu/ops/pooling.py; the
reference's ``nn.MaxPool2d(2, 2)``, ``nn.MaxPool2d(2, return_indices=True)``
and ``nn.MaxUnpool2d(2)`` with ``output_size``, models/segnet.py:79-116).

These are the plain versions, built on ``F.max_pool2d(...,
return_indices=True)`` and ``F.max_unpool2d`` through NHWC <-> NCHW views.
``ops/fused_pool.py`` holds the hand-written kernels (K3, K2) that compute
the same functions on the card, and calls these on CPU tensors.

Index forms, as in the JAX package:
- flat: int32 ``y * W + x`` over the pre-pool plane (torch's convention);
- phase: int8 ``k = 2 * dy + dx``, which of the window's four pixels won.

Selection rule (torch's, on the CPU and on the card): the window is scanned
(0,0), (0,1), (1,0), (1,1) and a pixel takes over when it is strictly
greater than the running maximum or is NaN. So ties go to the first maximal
pixel, and a NaN wins (the last NaN, when there are several). The JAX
package's XLA pair also lets NaN win (the first); its Pallas kernels do not
(ROADMAP.md, Queue 3).

Odd sizes floor on the pool (45 -> 22) and zero-pad on the unpool
(22 -> 45): the last row or column is never selected.

int8 (the quantized SegNet's fused pool edges): the pair runs on the values
as f32, which is exact, and casts back; ties, common on int8 values, go to
the first maximum, as JAX's argmax pair gives them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """NHWC max pool; odd spatial sizes floor like torch (45 -> 22)."""
    return _nhwc(F.max_pool2d(_nchw(x), 2, 2))


def _pool_int64(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.dtype == torch.int8:
        y, idx = _pool_int64(x.float())
        return y.to(torch.int8), idx
    y, idx = F.max_pool2d(_nchw(x), 2, 2, return_indices=True)
    return _nhwc(y), _nhwc(idx)


def max_pool_2x2_with_argmax(x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled, flat int32 index y*W + x) of an NHWC tensor."""
    y, idx = _pool_int64(x)
    return y, idx.to(torch.int32)


def max_pool_2x2_argmax_phase(x: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled, int8 phase k = 2*dy + dx) of an NHWC tensor."""
    y, idx = _pool_int64(x)
    w = x.shape[2]
    k = 2 * ((idx // w) % 2) + (idx % w) % 2
    return y, k.to(torch.int8)


def phase_to_flat_index(k: torch.Tensor, w_in: int) -> torch.Tensor:
    """The flat int32 index y*w_in + x of each window's phase k."""
    _, h2, w2, _ = k.shape
    ki = k.to(torch.int32)
    rows = torch.arange(h2, dtype=torch.int32, device=k.device)
    cols = torch.arange(w2, dtype=torch.int32, device=k.device)
    yy = 2 * rows.view(1, h2, 1, 1) + ki // 2
    xx = 2 * cols.view(1, 1, w2, 1) + ki % 2
    return yy * w_in + xx


def max_unpool_2x2(x: torch.Tensor, idx: torch.Tensor,
                   out_hw: Tuple[int, int]) -> torch.Tensor:
    """Place each pooled value at its flat index in an (Ho, Wo) plane of
    zeros (``F.max_unpool2d``, which takes int64 indices)."""
    if x.dtype == torch.int8:
        return max_unpool_2x2(x.float(), idx, out_hw).to(torch.int8)
    y = F.max_unpool2d(_nchw(x), _nchw(idx).long(), 2, 2,
                       output_size=tuple(out_hw))
    return _nhwc(y)


def max_unpool_2x2_from_phase(x: torch.Tensor, k: torch.Tensor,
                              out_hw: Tuple[int, int]) -> torch.Tensor:
    """``max_unpool_2x2`` from int8 phases; also the phase pool's backward
    (the cotangent goes to the selected pixel, zero elsewhere)."""
    return max_unpool_2x2(x, phase_to_flat_index(k, out_hw[1]), out_hw)


def gather_phase(g: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """out[n,i,j,c] = g[n, 2i+dy, 2j+dx, c] for k = 2*dy + dx: the phase
    unpool's backward. g is (N, Ho, Wo, C), k (N, H2, W2, C) with
    2*H2 <= Ho and 2*W2 <= Wo."""
    n, h2, w2, c = k.shape
    win = g[:, :2 * h2, :2 * w2].reshape(n, h2, 2, w2, 2, c)
    win = win.permute(0, 1, 3, 2, 4, 5).reshape(n, h2, w2, 4, c)
    return win.gather(3, k.long().unsqueeze(3)).squeeze(3)
