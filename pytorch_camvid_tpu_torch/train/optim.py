"""Optimizers with a per-step learning rate and beta1 (counterpart of
pytorch_camvid_tpu/train/optim.py).

OneCycle cycles Adam's beta1 over training, so both optimizers take ``lr``
(and AdamW ``beta1``) at every update. The arithmetic follows the JAX
package operation by operation, in f32:

- AdamW (torch.optim.AdamW semantics, reference train.py:100): bias
  corrections use the *current* beta1 and a 1-based step; decoupled weight
  decay ``p *= 1 - lr * wd`` before the Adam step.
- SGD with nesterov momentum (legacy/train_tpu.py:77-84): weight decay is
  added to the gradient, and the momentum buffer is set to that gradient on
  the first step (torch's ``buf = g``).

State is a dict of per-parameter tensors keyed by the parameter's name in
``model.named_parameters()``; ``update`` changes parameters and state in
place (PyTorch's idiom, where the JAX package returns new trees). The
updates run as ``torch._foreach_*`` ops, a few launches for all leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Dict[str, torch.Tensor]], Dict[str, Dict]]
    update: Callable[..., None]


def _zeros(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def _lists(params, grads, state, *keys) -> List[List[torch.Tensor]]:
    names = list(params)
    return ([params[k] for k in names], [grads[k].float() for k in names],
            *[[state[s][k] for k in names] for s in keys])


def adamw(beta2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": _zeros(params), "v": _zeros(params)}

    @torch.no_grad()
    def update(params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state, step: int, lr: float,
               beta1: float = 0.9) -> None:
        p, g, m, v = _lists(params, grads, state, "m", "v")
        f32 = np.float32
        t = f32(step) + f32(1)                       # torch is 1-based
        b1 = f32(beta1)
        bc1 = f32(1) - b1 ** t
        bc2 = f32(1) - f32(beta2) ** t
        torch._foreach_mul_(m, float(b1))
        torch._foreach_add_(m, torch._foreach_mul(g, float(f32(1) - b1)))
        torch._foreach_mul_(v, beta2)
        # (1 - beta2) is a Python float in JAX too: rounded once to f32
        torch._foreach_add_(v, torch._foreach_mul(
            torch._foreach_mul(g, g), 1.0 - beta2))
        denom = torch._foreach_sqrt(v)
        torch._foreach_div_(denom, float(np.sqrt(bc2)))
        torch._foreach_add_(denom, eps)
        if weight_decay:
            torch._foreach_mul_(p, float(f32(1) - f32(lr) * f32(
                weight_decay)))
        upd = torch._foreach_mul(m, float(f32(lr) / bc1))
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(p, upd)

    return Optimizer(init, update)


def sgd(momentum: float = 0.9, nesterov: bool = True,
        weight_decay: float = 1e-4) -> Optimizer:
    def init(params):
        return {"buf": _zeros(params)}

    @torch.no_grad()
    def update(params, grads, state, step: int, lr: float,
               beta1=None) -> None:
        p, g, buf = _lists(params, grads, state, "buf")
        if weight_decay:
            g = torch._foreach_add(g, torch._foreach_mul(p, weight_decay))
        if step == 0:
            for b, gi in zip(buf, g):
                b.copy_(gi)
        else:
            torch._foreach_mul_(buf, momentum)
            torch._foreach_add_(buf, g)
        d = (torch._foreach_add(g, torch._foreach_mul(buf, momentum))
             if nesterov else buf)
        torch._foreach_sub_(p, torch._foreach_mul(d, lr))

    return Optimizer(init, update)

