"""Data-parallel train and eval steps, "explicit" mode (counterpart of
pytorch_camvid_tpu/parallel/shard_map_dp.py).

JAX's ``shard_map`` runs the per-replica step built with ``axis_name``:
each shard's own mean loss, then ``lax.pmean`` of the loss and gradients,
sync-BN moments by ``pmean``, the confusion matrix by ``psum`` (the legacy
torch_xla trainer's all-reduce in ``xm.optimizer_step``). Here each rank
runs the step on its rows inside ``stepping(mesh, "explicit")``; where the
loss's denominators differ between the ranks (ignore labels, class
weights) this is the mean of the ranks' means, not the global batch's
(``data_parallel.py``).
"""

from __future__ import annotations

from typing import Callable

from pytorch_camvid_tpu_torch.parallel.data_parallel import wrap_step
from pytorch_camvid_tpu_torch.parallel.mesh import Mesh


def shard_map_train_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """``step_fn(state, (images, labels))`` on the rank's rows; loss and
    gradients the means over the ranks."""
    return wrap_step(step_fn, mesh, "explicit")


def shard_map_eval_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """The eval step on the rank's rows: the mean of the ranks' losses and
    the sum of their confusion matrices."""
    return wrap_step(step_fn, mesh, "explicit")
