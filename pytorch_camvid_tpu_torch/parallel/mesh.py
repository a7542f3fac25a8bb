"""The ranks of a data-parallel run and their collectives (counterpart of
pytorch_camvid_tpu/parallel/mesh.py).

JAX lays a ``('data', 'model')`` mesh over the devices of one program and
lets XLA place the collectives. Here every rank is a process with one
device, and a ``Mesh`` is what a rank knows of the run: the world, its
rank, its device and the process groups its sums run over. The collectives
are explicit ``torch.distributed`` calls, issued in the same order on every
rank:

- ``all_reduce`` sums a tensor over every level of the mesh: one group, or
  for a multislice mesh the ranks of the slice and then the ranks that hold
  the same place in the other slices (JAX's ``psum`` over ``('slice',
  'data')``, which crosses DCN last);
- ``pmean`` is the mean over the ranks inside autograd: the sum in the
  forward and the sum of the gradient in the backward, each divided by the
  world (``lax.pmean`` and its transpose). Sync-BN's moments go through it
  (``ops/conv.py::syncing``);
- ``reduce_grads`` sums, or averages, every gradient of a step as one flat
  f32 bucket.

A mesh of one rank with no process group has no levels: its collectives
return their input and nothing is sent. A process group of one rank (one
NCCL rank on one card) keeps its level, so its steps issue the same calls
as a larger world's.

``stepping(mesh, mode)`` tells the train and eval steps (``train/steps.py``)
which data-parallel step they are running: ``"inferred"`` (the JAX
package's ``jit_train_step``: one step over the global batch) or
``"explicit"`` (``shard_map_train_step``: the mean of the ranks' steps).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_step = threading.local()


@dataclasses.dataclass
class Mesh:
    world: int
    rank: int
    device: torch.device
    # the groups a sum runs over, in order; () without a process group
    levels: Tuple = ()

    def is_primary(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` (the batch is split
        in rank order, slice-major: JAX's ``P(('slice', 'data'))``)."""
        if n % self.world:
            raise ValueError(f"batch {n} must divide over {self.world} "
                             f"ranks")
        k = n // self.world
        return slice(self.rank * k, (self.rank + 1) * k)

    def all_reduce(self, t: torch.Tensor, op=None) -> torch.Tensor:
        """Reduce ``t`` in place over every level (SUM by default) and
        return it."""
        op = dist.ReduceOp.SUM if op is None else op
        for group in self.levels:
            dist.all_reduce(t, op=op, group=group)
        return t

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the ranks, differentiable."""
        if not self.levels:
            return t
        return _PMean.apply(t, self)

    def reduce_grads(self, grads: Dict[str, torch.Tensor],
                     mean: bool) -> Dict[str, torch.Tensor]:
        """Every gradient summed (``mean``: averaged) over the ranks in one
        flat f32 all-reduce; returns new f32 tensors of the same shapes."""
        if not self.levels:
            return grads
        names = list(grads)
        flat = torch.cat([grads[k].reshape(-1).float() for k in names])
        self.all_reduce(flat)
        if mean:
            flat /= self.world
        out, lo = {}, 0
        for k in names:
            n = grads[k].numel()
            out[k] = flat[lo: lo + n].view(grads[k].shape)
            lo += n
        return out

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any."""
        if not self.levels:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        return bool(self.all_reduce(t, dist.ReduceOp.MAX).item())


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(x.clone()) / mesh.world

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        mesh = ctx.mesh
        return mesh.all_reduce(g.clone()) / mesh.world, None


def _rank_device(device) -> torch.device:
    from pytorch_camvid_tpu_torch.parallel import multihost
    if device is not None:
        return torch.device(device)
    return multihost.rank_device()


def make_mesh(n_data: Optional[int] = None, device=None) -> Mesh:
    """The flat mesh of this process's rank: the whole process group when
    one is initialized (``n_data`` None or 0, or the world), else one rank
    on ``device`` (default: the device ``init_distributed`` chose, or the
    CPU). The port has no model axis (JAX's is of size 1)."""
    n = n_data or 0
    if not dist.is_initialized():
        if n > 1:
            raise ValueError(
                f"data_parallel={n} needs {n} ranks: launch them with the "
                f"train CLI's -dp {n} or -multihost, or "
                f"parallel.launch.spawn")
        return Mesh(1, 0, _rank_device(device))
    world, rank = dist.get_world_size(), dist.get_rank()
    if n not in (0, world):
        raise ValueError(f"data_parallel={n} but the process group has "
                         f"{world} ranks")
    return Mesh(world, rank, _rank_device(device), (dist.group.WORLD,))


def make_multislice_mesh(n_slice: int, n_data: Optional[int] = None,
                         device=None) -> Mesh:
    """A ('slice', 'data') mesh over the process group: rank r is place r
    % n_data of slice r // n_data. Its sums run over the slice's group,
    then over the group of the ranks at the same place in every slice
    (JAX's hierarchical psum). Every rank makes every group, in one
    order, as ``new_group`` requires."""
    if not dist.is_initialized():
        raise ValueError("a multislice mesh needs an initialized process "
                         "group (init_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    n_data = n_data or world // n_slice
    if n_slice * n_data != world:
        raise ValueError(f"{n_slice} slices of {n_data} ranks != world "
                         f"{world}")
    slices = [dist.new_group(list(range(s * n_data, (s + 1) * n_data)))
              for s in range(n_slice)]
    across = [dist.new_group(list(range(d, world, n_data)))
              for d in range(n_data)]
    return Mesh(world, rank, _rank_device(device),
                (slices[rank // n_data], across[rank % n_data]))


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """A batch split over the mesh's ranks: each holds ``mesh.rows(n)``."""
    mesh: Mesh


@dataclasses.dataclass(frozen=True)
class ReplicatedSharding:
    """Every rank holds the whole array."""
    mesh: Mesh


def batch_sharding(mesh: Mesh) -> BatchSharding:
    return BatchSharding(mesh)


def replicated_sharding(mesh: Mesh) -> ReplicatedSharding:
    return ReplicatedSharding(mesh)


@contextlib.contextmanager
def stepping(mesh: Mesh, mode: str):
    """Inside the block the train and eval steps run as ``mode``
    ("inferred" or "explicit") data-parallel steps over ``mesh``."""
    if mode not in ("inferred", "explicit"):
        raise ValueError(f"unknown data-parallel mode {mode!r}")
    before = getattr(_step, "setting", None)
    _step.setting = (mesh, mode)
    try:
        yield
    finally:
        _step.setting = before


def current_step() -> Optional[Tuple[Mesh, str]]:
    """(mesh, mode) of the enclosing ``stepping`` block, or None."""
    return getattr(_step, "setting", None)
