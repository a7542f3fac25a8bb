"""Train state (counterpart of pytorch_camvid_tpu/train/state.py).

Everything a step needs: the model (parameters and BatchNorm buffers), the
optimizer state, the int step, and an explicit ``torch.Generator`` that
draws the augmentation's random numbers. A step updates it in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from pytorch_camvid_tpu_torch.train.optim import Optimizer


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    opt_state: Dict[str, Dict[str, torch.Tensor]]
    step: int
    generator: torch.Generator

    @staticmethod
    def create(model: nn.Module, optimizer: Optimizer,
               generator: Optional[torch.Generator] = None,
               seed: int = 0) -> "TrainState":
        """Fresh state on the model's device; the generator, when not
        given, lives on that device and is seeded with ``seed``."""
        if generator is None:
            dev = next(model.parameters()).device
            generator = torch.Generator(device=dev).manual_seed(seed)
        return TrainState(model=model, opt_state=optimizer.init(
            dict(model.named_parameters())), step=0, generator=generator)

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())
