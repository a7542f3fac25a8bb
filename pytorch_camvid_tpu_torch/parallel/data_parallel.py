"""Data-parallel train and eval steps, "inferred" mode (counterpart of
pytorch_camvid_tpu/parallel/data_parallel.py).

JAX compiles the step once over the mesh and XLA places the collectives
the global batch implies: the step over N devices is the step over the
global batch. Here each rank runs the same step function on its rows of
the global batch inside ``parallel/mesh.py::stepping(mesh, "inferred")``,
and the step (``train/steps.py``) issues those collectives itself: sync-BN
moments, the loss's denominator, the gradient sum, the eval's confusion
matrix and loss. With the same rows and draws as the one-rank step over
the global batch, it equals it up to the order of float sums.

On a mesh without a process group the wrappers return the step as it is
(JAX's single-device ``jax.jit``). A process group of one rank keeps every
collective.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from pytorch_camvid_tpu_torch.parallel.mesh import Mesh, stepping


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global ``(images, labels)`` batch (host
    arrays or tensors), on its device."""
    out = []
    for x in batch:
        t = torch.as_tensor(np.ascontiguousarray(x) if isinstance(
            x, np.ndarray) else x)
        out.append(t[mesh.rows(t.shape[0])].to(mesh.device))
    return tuple(out)


def wrap_step(step_fn: Callable, mesh: Mesh, mode: str) -> Callable:
    """``step_fn`` run inside ``stepping(mesh, mode)``."""
    if not mesh.levels:
        return step_fn

    def fn(*args):
        with stepping(mesh, mode):
            return step_fn(*args)

    return fn


def jit_train_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """``step_fn(state, (images, labels))`` on the rank's rows as one step
    over the global batch."""
    return wrap_step(step_fn, mesh, "inferred")


def jit_chain_train_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """k steps in one call: ``(state, images, labels, idx_k) -> (state,
    stacked metrics)``, where images and labels are the split resident on
    the rank's device and ``idx_k`` is (k, global batch) sample indices;
    each step gathers the rank's rows of its batch. The steps and their
    numerics are those of k calls of ``jit_train_step``."""
    step = jit_train_step(step_fn, mesh)

    def chained(state, images, labels, idx_k):
        ms = []
        for ix in np.asarray(idx_k):
            i = torch.as_tensor(ix[mesh.rows(len(ix))], dtype=torch.long,
                                device=images.device)
            state, m = step(state, (images.index_select(0, i),
                                    labels.index_select(0, i)))
            ms.append(m)
        return state, {k: torch.stack([torch.as_tensor(m[k]) for m in ms])
                       for k in ms[0]}

    return chained


def jit_eval_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """``step_fn(state, (images, labels))`` on the rank's rows: the global
    batch's loss and confusion matrix on every rank."""
    return wrap_step(step_fn, mesh, "inferred")
