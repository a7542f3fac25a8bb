"""Train and eval steps (counterpart of pytorch_camvid_tpu/train/steps.py;
reference hot loops train.py:122-151 and 180-197).

A train step runs, on the device and without a host sync: the augmentation
(when given), the forward in train mode, the cross-entropy, the backward,
the lr and beta1 schedules (host scalars of the step) and the optimizer
update. Its metrics are device tensors, read only when the caller wants
them. It updates the ``TrainState`` in place and returns it.

``remat=True`` recomputes each model stage's activations in the backward
instead of keeping them (``models/common.py::remat_call``, the JAX
package's ``jax.checkpoint`` per stage): less activation memory for one
more forward of every conv block, with the same loss, gradients and BN
running stats.

Data parallelism: inside ``parallel/mesh.py::stepping(mesh, mode)`` (which
the wrappers of ``parallel/data_parallel.py`` and ``shard_map_dp.py``
enter) a step takes the rank's rows of a global batch, runs the forward
under sync-BN (``ops/conv.py::syncing``) and reduces over the ranks:

- augmentation: every rank draws for the global batch and keeps its rows
  (``augment_fn(..., rows=)``), so each rank's rows get other draws than
  the others' and every rank's generator stays in step;
- ``"inferred"`` (JAX ``jit_train_step``, one step over the global batch):
  the loss's denominator ``sum(w)`` is summed over the ranks before each
  rank divides its ``sum(w * nll)`` by it, and the gradients are summed;
  the loss is the global batch's mean even where ignore labels or class
  weights fall unevenly on the ranks;
- ``"explicit"`` (JAX ``shard_map_train_step`` with ``axis_name``): each
  rank's loss is its own rows' mean, and the loss and gradients are the
  means over the ranks.

Either way one flat f32 bucket of every gradient is all-reduced after the
step's last backward (``Mesh.reduce_grads``), and the optimizer update and
the logged gradient norms see the reduced gradients. The eval step sums
the confusion matrix over the ranks and reduces its loss the same two ways.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from pytorch_camvid_tpu_torch.ops.conv import syncing
from pytorch_camvid_tpu_torch.ops.loss import (IgnoreIndex, cross_entropy_loss,
                                               cross_entropy_sums)
from pytorch_camvid_tpu_torch.ops.metrics import confusion_matrix
from pytorch_camvid_tpu_torch.parallel.mesh import current_step
from pytorch_camvid_tpu_torch.train.optim import Optimizer
from pytorch_camvid_tpu_torch.train.state import TrainState


def loss_and_grads(model: nn.Module, images: torch.Tensor,
                   labels: torch.Tensor,
                   class_weights: Optional[torch.Tensor] = None,
                   ignore_index: IgnoreIndex = None, plain: bool = False,
                   remat: bool = False, mesh=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Train-mode forward (updating the BN running stats), loss and the
    gradient of every parameter, keyed by its name; ``remat`` recomputes
    each stage in the backward. With a ``mesh`` (the inferred step) the
    loss divides by the ``sum(w)`` of every rank's pixels."""
    model.train()
    logits = model(images, plain, remat)
    if mesh is None:
        loss = cross_entropy_loss(logits, labels, class_weights,
                                  ignore_index)
    else:
        num, den = cross_entropy_sums(logits, labels, class_weights,
                                      ignore_index)
        loss = num / mesh.all_reduce(den.detach().clone()).clamp_min(1e-12)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), dict(zip(names, grads))


def make_train_step(optimizer: Optimizer, lr_schedule: Callable[[int], float],
                    beta1_schedule: Optional[Callable[[int], float]] = None,
                    class_weights: Optional[torch.Tensor] = None,
                    ignore_index: IgnoreIndex = None,
                    augment_fn: Optional[Callable] = None,
                    compute_dtype: torch.dtype = torch.float32,
                    log_grad_norms: bool = True, grad_accum: int = 1,
                    plain: bool = False, remat: bool = False):
    """Build ``step_fn(state, (images, labels)) -> (state, metrics)``.

    images: float NHWC already normalized, or raw uint8 when ``augment_fn``
    is given (``augment_fn(generator, images_u8, labels) -> (images,
    labels)``, e.g. ``data/augment.py::make_train_augment``).

    ``grad_accum > 1`` splits the batch into that many microbatches: each
    is normalized by its own BN statistics, the running stats are updated
    microbatch by microbatch, and the mean gradient makes one optimizer
    update (the JAX package's ``lax.scan``). ``remat=True`` recomputes
    each model stage's activations in the backward; it works with either
    compute dtype, ``plain`` and ``grad_accum``. ``plain=True`` runs the
    plain versions of the kernels, the reference for the kernel path."""

    def step_fn(state: TrainState, batch):
        images, labels = batch
        dp = current_step()
        mesh, mode = dp if dp is not None else (None, None)
        if augment_fn is not None:
            kw = {}
            if mesh is not None:
                total = images.shape[0] * mesh.world
                kw["rows"] = (mesh.rows(total).start, total)
            images, labels = augment_fn(state.generator, images, labels,
                                        **kw)
        images, labels = images.to(compute_dtype), labels.long()
        model = state.model
        global_mesh = mesh if mode == "inferred" else None
        sync = syncing(mesh) if mesh is not None else contextlib.nullcontext()
        with sync:
            if grad_accum > 1:
                n = images.shape[0]
                if n % grad_accum:
                    raise ValueError(f"batch {n} must divide grad_accum "
                                     f"{grad_accum}")
                loss, grads = None, None
                for im, lb in zip(images.chunk(grad_accum),
                                  labels.chunk(grad_accum)):
                    mb_loss, mb_grads = loss_and_grads(
                        model, im, lb, class_weights, ignore_index, plain,
                        remat, global_mesh)
                    if grads is None:
                        loss, grads = mb_loss, mb_grads
                    else:
                        loss = loss + mb_loss
                        grads = {k: grads[k] + g
                                 for k, g in mb_grads.items()}
                inv = 1.0 / grad_accum
                loss = loss * inv
                grads = {k: g * inv for k, g in grads.items()}
            else:
                loss, grads = loss_and_grads(model, images, labels,
                                             class_weights, ignore_index,
                                             plain, remat, global_mesh)
        if mesh is not None:
            explicit = mode == "explicit"
            grads = mesh.reduce_grads(grads, mean=explicit)
            loss = mesh.all_reduce(loss.clone())
            if explicit:
                loss = loss / mesh.world

        lr = lr_schedule(state.step)
        beta1 = beta1_schedule(state.step) if beta1_schedule else 0.9
        optimizer.update(state.params(), grads, state.opt_state, state.step,
                         lr, beta1)
        metrics = {"loss": loss, "lr": lr, "beta1": beta1}
        if log_grad_norms:
            # the head block's BN scale and bias, the reference's 'last
            # layer' (utils.py:15-36): UNet's output, SegNet's decoder1[-1]
            head = model.head_names()
            metrics["grad_norm_w"] = torch.linalg.vector_norm(
                grads[head["scale"]])
            metrics["grad_norm_b"] = torch.linalg.vector_norm(
                grads[head["bias"]])
        state.step += 1
        return state, metrics

    return step_fn


def make_eval_step(num_classes: int, ignore_index: Optional[int] = None,
                   class_weights: Optional[torch.Tensor] = None,
                   loss_ignore_index: IgnoreIndex = None,
                   compute_dtype: torch.dtype = torch.float32,
                   plain: bool = False):
    """Build ``step_fn(state, (images, labels)) -> (loss, confusion
    matrix)``. The model runs in eval mode: running BN stats, and on CUDA
    the fused conv+BN+ReLU kernel (K4). In a data-parallel eval (the
    module docstring) the matrix and the loss are the global batch's. It is switched to eval mode only
    when it is training, so the blocks' prepared kernel weights (BN folded,
    kernel layout) survive from one eval batch to the next."""

    @torch.no_grad()
    def step_fn(state: TrainState, batch):
        images, labels = batch
        model = state.model
        if model.training:
            model.eval()
        logits = model(images.to(compute_dtype), plain)
        cm = confusion_matrix(logits.argmax(dim=-1), labels, num_classes,
                              ignore_index)
        dp = current_step()
        if dp is None:
            return cross_entropy_loss(logits, labels, class_weights,
                                      loss_ignore_index), cm
        mesh, mode = dp
        mesh.all_reduce(cm)
        if mode == "explicit":
            loss = cross_entropy_loss(logits, labels, class_weights,
                                      loss_ignore_index)
            return mesh.all_reduce(loss) / mesh.world, cm
        num, den = mesh.all_reduce(torch.stack(cross_entropy_sums(
            logits, labels, class_weights, loss_ignore_index)))
        return num / den.clamp_min(1e-12), cm

    return step_fn
