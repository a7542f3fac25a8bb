"""Rank programs of the port's data-parallel tests.

``parallel/launch.py::spawn`` runs them in fresh processes, which import
this module by name from the test directory on the inherited ``sys.path``:
it imports the port and numpy only, never JAX. Each takes the rank's
``Mesh`` and numpy inputs and returns numpy results.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from pytorch_camvid_tpu_torch.data.augment import (AugmentConfig,
                                                   make_train_augment)
from pytorch_camvid_tpu_torch.data.pipeline import DeviceDataLoader
from pytorch_camvid_tpu_torch.interop.weights import train_state_from_jax
from pytorch_camvid_tpu_torch.models.unet import UNet
from pytorch_camvid_tpu_torch.ops.conv import ConvBNReLU
from pytorch_camvid_tpu_torch.parallel import (jit_eval_step, jit_train_step,
                                               make_multislice_mesh,
                                               shard_batch,
                                               shard_map_eval_step,
                                               shard_map_train_step, spatial)
from pytorch_camvid_tpu_torch.parallel.multihost import state_sha256
from pytorch_camvid_tpu_torch.train import (make_eval_step, make_train_step,
                                            schedules, sgd)
from pytorch_camvid_tpu_torch.train.loop import evaluate
from pytorch_camvid_tpu_torch.train.optim import Optimizer

WIDTH = 1 / 16


def port_state(variables, seed: int = 0):
    """A port ``TrainState`` (SGD, zero momentum) from JAX-layout numpy
    variables of UNet at width 1/16; its generator on the CPU, seeded."""
    model = UNet(3, 12, width_mult=WIDTH)
    st = train_state_from_jax(types.SimpleNamespace(
        params=variables["params"], bn_state=variables["state"],
        opt_state={}, step=0), model, torch.Generator().manual_seed(seed))
    st.opt_state = sgd().init(dict(model.named_parameters()))
    return st


def _recording(opt: Optimizer, out: dict) -> Optimizer:
    """``opt`` that keeps the gradients it is given, as numpy."""
    def update(params, grads, state, step, lr, beta1=0.9):
        out["grads"] = {k: g.detach().float().cpu().numpy().copy()
                        for k, g in grads.items()}
        opt.update(params, grads, state, step, lr, beta1)
    return Optimizer(opt.init, update)


def _named(tensors) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def run_case(mesh, case: dict) -> dict:
    """One case on this rank: ``kind`` "train" (one SGD step at lr 1e-3,
    ``mode`` "inferred" or "explicit", optional ``ignore_index``,
    ``augment`` and ``grad_accum``) or "eval" (``mode``; the confusion
    matrix ignores class 11) on the global batch ``x``, ``y``; or
    "padded_eval" (``evaluate`` over the split ``x``, ``y`` in batches of
    ``batch``, padded to whole batches of 255 rows where there are
    ranks)."""
    st = port_state(case["variables"])
    wrap = {"inferred": (jit_train_step, jit_eval_step),
            "explicit": (shard_map_train_step, shard_map_eval_step)}
    x, y = case["x"], case["y"]
    if case["kind"] == "padded_eval":
        loader = DeviceDataLoader(x, y, case["batch"], device=mesh.device,
                                  mesh=mesh, pad_to_batch=mesh.world > 1)
        step = jit_eval_step(make_eval_step(
            12, ignore_index=11, loss_ignore_index=(255,)), mesh)
        loss_sum, cm, n = evaluate(st, step, loader, lambda im: (
            im.float() / 255.0 - 0.4) / 0.3)
        return {"loss_sum": loss_sum, "cm": cm, "n_batches": n}
    batch = shard_batch((x, y), mesh)
    if case["kind"] == "eval":
        step = wrap[case["mode"]][1](make_eval_step(12, ignore_index=11),
                                     mesh)
        loss, cm = step(st, batch)
        return {"loss": float(loss), "cm": cm.numpy()}
    out = {}
    aug = None
    if case.get("augment"):
        aug = make_train_augment(AugmentConfig(rotation_fill=11,
                                               scale_fill=11))
    step = wrap[case["mode"]][0](make_train_step(
        _recording(sgd(), out), schedules.constant_lr(1e-3),
        ignore_index=case.get("ignore_index"), augment_fn=aug,
        log_grad_norms=False, grad_accum=case.get("grad_accum", 1)), mesh)
    st, m = step(st, batch)
    out.update(loss=float(m["loss"]), params=_named(st.params()),
               buffers=_named(dict(st.model.named_buffers())),
               sha256=state_sha256(st))
    return out


def run_cases(mesh, cases: dict) -> dict:
    """``run_case`` of each named case, in order (every rank runs them
    all, so their collectives line up)."""
    return {name: run_case(mesh, case) for name, case in cases.items()}


def run_cases_multislice(mesh, cases: dict, n_slice: int) -> dict:
    """``run_cases`` on an ``n_slice``-slice mesh of the same ranks."""
    return run_cases(make_multislice_mesh(n_slice), cases)


def block_from_jax(p: dict, s: dict) -> ConvBNReLU:
    """An eval-mode port block with a JAX block's params and BN state."""
    w = torch.from_numpy(np.array(p["w"], np.float32))
    blk = ConvBNReLU(w.shape[2], w.shape[3])
    conv, bn = blk.conv_bn()
    with torch.no_grad():
        conv.weight.copy_(w.permute(3, 2, 0, 1))
        for t, v in ((conv.bias, p["b"]), (bn.weight, p["scale"]),
                     (bn.bias, p["bias"]), (bn.running_mean, s["mean"]),
                     (bn.running_var, s["var"])):
            t.copy_(torch.from_numpy(np.array(v, np.float32)))
    return blk.eval()


def halo_case(mesh, x, w, params, states) -> dict:
    """The rank's rows of the H-sharded conv (``x``, HWIO ``w``) and of
    the H-sharded encoder stage (the JAX blocks ``params``, ``states``)."""
    xt = spatial.shard_height(torch.from_numpy(x), mesh)
    conv = spatial.make_spatial_conv(mesh)(xt, torch.from_numpy(w))
    blocks = [block_from_jax(p, s) for p, s in zip(params, states)]
    with torch.no_grad():
        stage = spatial.make_spatial_stage(mesh)(blocks, xt)
    return {"conv": conv.numpy(), "stage": stage.numpy()}
