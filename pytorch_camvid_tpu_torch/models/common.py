"""What UNet and SegNet share: a stage of conv blocks, stage
rematerialization, and the base class that knows a model's blocks, its
parameter names and its block sizes.

Rematerialization (``remat=True``, the JAX package's ``jax.checkpoint`` of
each stage, JAX ``models/unet.py::_stage_fn``): each stage's conv blocks
run under ``torch.utils.checkpoint`` (non-reentrant, which works under
``torch.autograd.grad``), so the forward keeps only the stage's input and
the backward runs the stage's forward again to get what its blocks saved.
The recompute runs inside ``ops/conv.py::recomputing()``, so it does not
move the BN running stats a second time; it computes the same batch
statistics, and autograd saves the same tensors in both passes.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from pytorch_camvid_tpu_torch.ops.conv import ConvBNReLU, recomputing

# (stage name, [(cin, cout) per conv block]) in forward order
Spec = List[Tuple[str, List[Tuple[int, int]]]]


def remat_contexts():
    """``checkpoint``'s ``context_fn``: nothing around the forward,
    ``recomputing()`` around the recompute."""
    return contextlib.nullcontext(), recomputing()


def remat_call(fn: Callable, x: torch.Tensor, plain: bool,
               remat: bool) -> torch.Tensor:
    """``fn(x, plain)``; with ``remat`` its activations are recomputed in
    the backward instead of kept. The forward draws no random numbers, so
    no RNG state is kept for it."""
    if not remat:
        return fn(x, plain)
    return checkpoint(fn, x, plain, use_reentrant=False,
                      context_fn=remat_contexts, preserve_rng_state=False)


class Stage(nn.Sequential):
    """Conv blocks run in order; ``plain`` goes to each. With ``remat``
    the stage is the unit that is checkpointed."""

    def forward(self, x, plain: bool = False, remat: bool = False):
        return remat_call(self._blocks, x, plain, remat)

    def _blocks(self, x, plain: bool):
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
