"""Learning-rate and beta1 schedules as closed-form functions of the step
(counterpart of pytorch_camvid_tpu/train/schedules.py).

Each schedule maps an int step to a Python float, computed in float32 as
the JAX package computes it, so a step feeds the optimizer a host scalar
and the device never waits on a schedule.

- OneCycle (torch's ``OneCycleLR`` defaults: pct_start 0.3, cosine, div 25,
  final div 1e4, beta1 cycling 0.95 -> 0.85 -> 0.95), with torch's
  ``float(pct_start * total) - 1`` phase boundary;
- warmup (``lr * step / (total + 1e-8)``), multistep by epoch, the
  exponential sweep of the LR finder, constant, and the legacy
  warmup-then-multistep recipe.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

Schedule = Callable[[int], float]
_f32 = np.float32


def _cos_anneal(start: float, end: float, pct):
    return end + (start - end) / 2.0 * (1.0 + np.cos(_f32(np.pi) * pct))


def _onecycle(step: int, total_steps: int, start1: float, mid: float,
              end2: float, pct_start: float) -> float:
    s = _f32(step)
    up_end = float(pct_start * total_steps) - 1.0
    down_end = float(total_steps - 1)
    if s <= up_end:
        pct = np.clip(s / _f32(max(up_end, 1e-8)), _f32(0), _f32(1))
        return float(_f32(_cos_anneal(start1, mid, pct)))
    pct = np.clip((s - _f32(up_end)) / _f32(max(down_end - up_end, 1e-8)),
                  _f32(0), _f32(1))
    return float(_f32(_cos_anneal(mid, end2, pct)))


def onecycle_lr(max_lr: float, total_steps: int, pct_start: float = 0.3,
                div_factor: float = 25.0,
                final_div_factor: float = 1e4) -> Schedule:
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    return lambda step: _onecycle(step, total_steps, initial_lr, max_lr,
                                  min_lr, pct_start)


def onecycle_beta1(total_steps: int, pct_start: float = 0.3,
                   max_momentum: float = 0.95,
                   base_momentum: float = 0.85) -> Schedule:
    """Adam's beta1 cycles opposite to the lr: 0.95 -> 0.85 -> 0.95."""
    return lambda step: _onecycle(step, total_steps, max_momentum,
                                  base_momentum, max_momentum, pct_start)


def warmup_lr(base_lr: float, total_iters: int) -> Schedule:
    return lambda step: float(_f32(base_lr * _f32(step)
                                   / (total_iters + 1e-8)))


def multistep_lr(base_lr: float, milestones: Sequence[int],
                 gamma: float = 0.1) -> Schedule:
    ms = sorted(milestones)
    return lambda epoch: float(_f32(base_lr * gamma ** sum(
        _f32(epoch) >= m for m in ms)))


def exponential_sweep_lr(start_lr: float, end_lr: float,
                         num_iter: int) -> Schedule:
    """lr = start * (end/start)^((step+1)/num_iter): the reference steps its
    scheduler once at construction, so iteration i uses (i+1)/num_iter."""
    return lambda step: float(_f32(start_lr * (end_lr / start_lr) ** (
        (_f32(step) + _f32(1)) / _f32(num_iter))))


def constant_lr(lr: float) -> Schedule:
    return lambda step: float(_f32(lr))


def warmup_then_multistep(base_lr: float, warm_iters: int,
                          milestones: Sequence[int], steps_per_epoch: int,
                          gamma: float = 0.1) -> Schedule:
    """Linear warmup for ``warm_iters`` steps, then MultiStepLR by epoch
    (epoch = step // steps_per_epoch; legacy/train_tpu.py:86-97)."""
    warm = warmup_lr(base_lr, warm_iters)
    ms = multistep_lr(base_lr, milestones, gamma)
    return lambda step: (warm(step) if step <= warm_iters
                         else ms(step // steps_per_epoch))
