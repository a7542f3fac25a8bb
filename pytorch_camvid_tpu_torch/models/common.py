"""What UNet and SegNet share: a stage of conv blocks, and the base class
that knows a model's blocks, its parameter names and its block sizes."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from pytorch_camvid_tpu_torch.ops.conv import ConvBNReLU

# (stage name, [(cin, cout) per conv block]) in forward order
Spec = List[Tuple[str, List[Tuple[int, int]]]]


class Stage(nn.Sequential):
    """Conv blocks run in order; ``plain`` goes to each."""

    def forward(self, x, plain: bool = False):
        for blk in self:
            x = blk(x, plain)
        return x


class SegmentationNet(nn.Module):
    """A model built from a spec of conv blocks. Subclasses set ``net`` (the
    name ``get_model`` takes), ``self.spec``, and define ``base_spec``,
    ``block_names`` and ``block_sizes``."""

    net = ""
    spec: Spec

    @staticmethod
    def base_spec(in_ch: int, num_classes: int) -> Spec:
        """The reference's spec at full width."""
        raise NotImplementedError

    @staticmethod
    def block_names(stage: str, i: int) -> Dict[str, str]:
        """state_dict names of block ``i`` of ``stage``, keyed as the JAX
        package keys the block: w, b, scale, bias, mean, var, and count
        (BN's num_batches_tracked)."""
        raise NotImplementedError

    @staticmethod
    def block_sizes(hw: Tuple[int, int]) -> List[Tuple[int, int]]:
        """(H, W) each conv block runs at for an (H, W) input, in spec
        order."""
        raise NotImplementedError

    def blocks(self) -> List[ConvBNReLU]:
        """The conv blocks in spec order."""
        return [m for m in self.modules() if isinstance(m, ConvBNReLU)]

    def head_names(self) -> Dict[str, str]:
        """``block_names`` of the head, the last block: the 'last layer'
        whose BN gradient norms the reference logs (utils.py:15-36)."""
        stage, pairs = self.spec[-1]
        return self.block_names(stage, len(pairs) - 1)

    @torch.no_grad()
    def prepare(self, dtype: torch.dtype) -> "SegmentationNet":
        """Fold BN and lay out every block's weight for the fused kernel in
        ``dtype`` once, ahead of eval-mode forwards."""
        for blk in self.blocks():
            blk.prepare(dtype)
        return self


def halvings(hw: Tuple[int, int], levels: int) -> List[Tuple[int, int]]:
    """``hw`` and its ``levels - 1`` floor halvings (the pools' outputs)."""
    out = [tuple(hw)]
    for _ in range(levels - 1):
        out.append((out[-1][0] // 2, out[-1][1] // 2))
    return out
