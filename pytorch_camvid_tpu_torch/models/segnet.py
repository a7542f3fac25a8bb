"""SegNet as an ``nn.Module`` (counterpart of
pytorch_camvid_tpu/models/segnet.py).

Architecture parity with the reference (models/segnet.py:19-118):
- encoder: 2-2-3-3-3 conv3x3+BN+ReLU blocks, 64->128->256->512->512, each
  stage followed by a 2x2 max pool that records its indices and the stage's
  pre-pool (H, W);
- decoder: mirrored; each stage unpools to the recorded size (odd sizes
  zero-pad: 22 -> 45) and runs its conv blocks. The head is the last
  decoder block, itself conv+BN+ReLU, so logits are non-negative.

Parameter and buffer names equal the reference's state_dict
(``encoder{k}.{i}.conv.*``, ``encoder{k}.{i}.bn.*``, ``decoder{k}.{i}.*``;
pytorch_camvid_tpu/interop/torch_weights.py:43-48), so a reference ``.pth``
loads with ``strict=True``. 26 blocks, 29.45M parameters at full width.

NHWC in, f32 logits out, computed in the input's dtype. The pools:
- eval mode: K3, ``ops/fused_pool.py::max_pool_2x2_argmax`` and
  ``max_unpool_2x2`` (flat int32 indices), as the JAX model's
  ``use_pallas=True`` path;
- train mode: K2, ``pool_phase_train`` and ``unpool_phase_train`` (int8
  phases, kernels forward and backward), as JAX's TPU default
  ``pallas_phase``; the convs run K1 (``ops/conv_train.py``).
``plain=True`` runs the plain versions of every kernel, conv and pool, in
both modes; in train mode autograd differentiates them. ``remat=True``
checkpoints each stage's conv blocks (``models/common.py::remat_call``),
as JAX's ``apply_segnet(remat=True)``: the pools and unpools stay outside,
and the phases they save stay stored.
"""

from __future__ import annotations

from typing import Optional

import torch

from pytorch_camvid_tpu_torch.models.common import (SegmentationNet, Spec,
                                                    Stage, halvings)
from pytorch_camvid_tpu_torch.ops import fused_pool, pooling
from pytorch_camvid_tpu_torch.ops.conv import BasicConv


def segnet_spec(in_ch: int, num_classes: int) -> Spec:
    """(stage name, [(cin, cout) per conv block]) in forward order."""
    return [
        ("encoder1", [(in_ch, 64), (64, 64)]),
        ("encoder2", [(64, 128), (128, 128)]),
        ("encoder3", [(128, 256), (256, 256), (256, 256)]),
        ("encoder4", [(256, 512), (512, 512), (512, 512)]),
        ("encoder5", [(512, 512), (512, 512), (512, 512)]),
        ("decoder5", [(512, 512), (512, 512), (512, 512)]),
        ("decoder4", [(512, 512), (512, 512), (512, 256)]),
        ("decoder3", [(256, 256), (256, 256), (256, 128)]),
        ("decoder2", [(128, 128), (128, 64)]),
        ("decoder1", [(64, 64), (64, num_classes)]),
    ]


def scaled_spec(in_ch: int, num_classes: int, width_mult: float) -> Spec:
    """The spec with every internal channel count scaled to
    ``max(4, round(c * width_mult))``, the JAX package's rule. SegNet has
    no concat, so any multiplier gives a consistent model (the JAX package
    also applies UNet's concat check, and refuses e.g. 0.05). The
    data-facing edges are fixed by position: the first block's input and
    the head's output."""
    spec = segnet_spec(in_ch, num_classes)
    if width_mult == 1.0:
        return spec

    def s(c):
        return max(4, int(round(c * width_mult)))
    out = [(name, [(s(a), s(b)) for a, b in pairs]) for name, pairs in spec]
    out[0][1][0] = (in_ch, out[0][1][0][1])
    out[-1][1][-1] = (out[-1][1][-1][0], num_classes)
    return out


# state_dict suffix of each JAX block leaf under ``{stage}.{i}``
_SUFFIX = {"w": "conv.weight", "b": "conv.bias", "scale": "bn.weight",
           "bias": "bn.bias", "mean": "bn.running_mean",
           "var": "bn.running_var", "count": "bn.num_batches_tracked"}


class SegNet(SegmentationNet):
    net = "segnet"

    def __init__(self, input_channels: int = 3, class_num: int = 12,
                 width_mult: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 spec: Optional[Spec] = None):
        """``spec`` (e.g. read off a state_dict) replaces the one built
        from the channel counts and ``width_mult``."""
        super().__init__()
        self.spec = spec or scaled_spec(input_channels, class_num,
                                        width_mult)
        for name, pairs in self.spec:
            setattr(self, name, Stage(
                *[BasicConv(ci, co, generator) for ci, co in pairs]))

    base_spec = staticmethod(segnet_spec)

    @staticmethod
    def block_names(stage: str, i: int):
        return {k: f"{stage}.{i}.{suffix}" for k, suffix in _SUFFIX.items()}

    @staticmethod
    def block_sizes(hw):
        """Encoder stage k and decoder stage k run at the k-th level."""
        dims = halvings(hw, 5)
        return [dims[int(name[7:]) - 1]
                for name, pairs in segnet_spec(3, 12) for _ in pairs]

    def _pools(self, plain: bool):
        if self.training:
            if plain:
                return (pooling.max_pool_2x2_argmax_phase,
                        pooling.max_unpool_2x2_from_phase)
            return fused_pool.pool_phase_train, fused_pool.unpool_phase_train
        if plain:
            return pooling.max_pool_2x2_with_argmax, pooling.max_unpool_2x2
        return fused_pool.max_pool_2x2_argmax, fused_pool.max_unpool_2x2

    def forward(self, x: torch.Tensor, plain: bool = False,
                remat: bool = False) -> torch.Tensor:
        """x: (N,H,W,C) float -> f32 logits (N,H,W,class_num), computed in
        x's dtype; ``remat=True`` recomputes each stage in the backward."""
        pool, unpool = self._pools(plain)
        skips = []  # (index, pre-pool (H, W)) per encoder stage
        for k in range(1, 6):
            x = getattr(self, f"encoder{k}")(x, plain, remat)
            hw = (x.shape[1], x.shape[2])
            x, idx = pool(x)
            skips.append((idx, hw))
        for k in range(5, 0, -1):
            idx, hw = skips[k - 1]
            x = getattr(self, f"decoder{k}")(unpool(x, idx, hw), plain,
                                             remat)
        return x.float()
