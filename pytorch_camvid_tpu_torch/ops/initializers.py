"""Conv initializers reproducing torch.nn.Conv2d defaults with an explicit
generator (counterpart of pytorch_camvid_tpu/ops/initializers.py).

weight and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = cin*kh*kw
(kaiming_uniform(a=sqrt(5)) reduces to this). BatchNorm keeps its own
defaults: scale 1, bias 0, running mean 0, running var 1. The JAX package
draws from threefry and this one from torch's Philox/MT streams, so the two
agree in distribution, not in value.
"""

from __future__ import annotations

from typing import Optional

import torch


@torch.no_grad()
def conv_init_(conv: torch.nn.Conv2d,
               generator: Optional[torch.Generator] = None) -> None:
    """Re-draw ``conv.weight`` and ``conv.bias`` in place from
    U(+-1/sqrt(fan_in)) using ``generator``."""
    fan_in = conv.weight[0].numel()
    bound = 1.0 / fan_in ** 0.5
    conv.weight.uniform_(-bound, bound, generator=generator)
    if conv.bias is not None:
        conv.bias.uniform_(-bound, bound, generator=generator)
