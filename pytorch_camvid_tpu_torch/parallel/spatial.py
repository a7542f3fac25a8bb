"""H-sharded conv3x3 and encoder stages with a halo exchange (counterpart
of pytorch_camvid_tpu/parallel/spatial.py).

Each rank holds rows ``mesh.rows(H)`` of an (N, H, W, C) activation
(``shard_height``). Before a conv it takes k boundary rows a side from its
neighbours (``halo_rows``); the image's top and bottom edges get zeros (the
conv's pad 1). The convs run K4 (``ops/fused_conv.py``, eval mode: BN
folded, or a unit affine without ReLU for the bare conv) on the extended
block; K4 pads H by one row a side too, and the two rows that adds, beyond
JAX's VALID-in-H, are dropped after each conv. A stage of k blocks
exchanges k rows a side once (JAX's halo widening); after block j the
edge ranks set the k - j - 1 rows beyond the image back to zero before the
next conv sees them. The 2×2 pool is ``ops/pooling.py``'s, local to the
rank (its rows are even, so no window crosses a rank).

The rows move with ``batch_isend_irecv`` between neighbouring ranks: as
device tensors under NCCL, through host copies under gloo (whose CUDA
support is ``broadcast`` and ``all_reduce`` only).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from pytorch_camvid_tpu_torch.ops.fused_conv import conv3x3_bn_relu
from pytorch_camvid_tpu_torch.ops.pooling import max_pool_2x2
from pytorch_camvid_tpu_torch.parallel.mesh import Mesh


def shard_height(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of an (N, H, W, C) tensor, on its device."""
    return x[:, mesh.rows(x.shape[1])].to(mesh.device)


def exchange_rows(top: torch.Tensor, bottom: torch.Tensor, mesh: Mesh):
    """(the previous rank's ``bottom``, the next rank's ``top``), zeros
    where there is no such rank."""
    halo_top, halo_bottom = torch.zeros_like(bottom), torch.zeros_like(top)
    r, last = mesh.rank, mesh.world - 1
    if not mesh.levels or mesh.world == 1:
        return halo_top, halo_bottom
    host = dist.get_backend() != "nccl"
    dev = top.device

    def buf(t):
        t = t.contiguous()
        return t.cpu() if host else t

    send_top, send_bottom = buf(top), buf(bottom)
    recv_top = torch.empty_like(send_bottom)
    recv_bottom = torch.empty_like(send_top)
    ops = []
    if r > 0:
        ops += [dist.P2POp(dist.isend, send_top, r - 1),
                dist.P2POp(dist.irecv, recv_top, r - 1)]
    if r < last:
        ops += [dist.P2POp(dist.isend, send_bottom, r + 1),
                dist.P2POp(dist.irecv, recv_bottom, r + 1)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if r > 0:
        halo_top = recv_top.to(dev)
    if r < last:
        halo_bottom = recv_bottom.to(dev)
    return halo_top, halo_bottom


def halo_rows(x: torch.Tensor, k: int, mesh: Mesh) -> torch.Tensor:
    """x with k rows of its neighbours above and below: (N, H_l + 2k, W,
    C)."""
    if x.shape[1] < k:
        raise ValueError(f"{x.shape[1]} rows a rank cannot lend {k}")
    top, bottom = exchange_rows(x[:, :k], x[:, -k:], mesh)
    return torch.cat([top, x, bottom], dim=1)


def conv3x3_halo(x: torch.Tensor, w: torch.Tensor, mesh: Mesh
                 ) -> torch.Tensor:
    """Pad-1 conv3x3 of the whole image on an H-sharded (N, H_l, W, Cin)
    block: w (3, 3, Cin, Cout) HWIO in x's dtype; no bias."""
    xh = halo_rows(x, 1, mesh)
    cout = w.shape[-1]
    one = torch.ones(cout, dtype=torch.float32, device=x.device)
    y = conv3x3_bn_relu(xh.contiguous(), w.contiguous(), one,
                        torch.zeros_like(one), relu=False)
    return y[:, 1:-1]


def encoder_stage_halo(blocks: Sequence, x: torch.Tensor, mesh: Mesh
                       ) -> torch.Tensor:
    """An encoder stage, k eval-mode conv blocks (``ops/conv.py``'s) then
    the 2×2 max pool, on an H-sharded block with one exchange of k rows a
    side."""
    k = len(blocks)
    if x.shape[1] % 2:
        raise ValueError("a rank's rows must be even for the 2x2 pool")
    xh = halo_rows(x, k, mesh)
    for j, blk in enumerate(blocks):
        w, a, b = blk.prepare(x.dtype)
        xh = conv3x3_bn_relu(xh.contiguous(), w, a, b)[:, 1:-1]
        d = k - (j + 1)
        if d > 0:   # rows beyond the image are the next conv's zero pad
            if mesh.rank == 0:
                xh[:, :d] = 0
            if mesh.rank == mesh.world - 1:
                xh[:, -d:] = 0
    return max_pool_2x2(xh)


def make_spatial_conv(mesh: Mesh) -> Callable:
    """``conv(x_local, w)``: ``conv3x3_halo`` over ``mesh``."""
    return lambda x, w: conv3x3_halo(x, w, mesh)


def make_spatial_stage(mesh: Mesh) -> Callable:
    """``stage(blocks, x_local)``: ``encoder_stage_halo`` over ``mesh``."""
    return lambda blocks, x: encoder_stage_halo(blocks, x, mesh)
