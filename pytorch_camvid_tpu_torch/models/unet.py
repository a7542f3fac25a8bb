"""UNet as an ``nn.Module`` (counterpart of pytorch_camvid_tpu/models/unet.py).

Architecture parity with the reference (models/unet.py:35-156):
- encoder: 5 stages of two conv3x3+BN+ReLU blocks, 64->128->256->512->1024,
  2x2 max pool between stages;
- decoder: 4x (bilinear 2x upsample align_corners=True + conv block, pad to
  the skip, channel concat, two conv blocks);
- the head is itself a conv+BN+ReLU block, so logits are non-negative.

Parameter and buffer names equal the reference's state_dict
(``down{k}.{i}.conv.{0,1}.*``, ``upsample{k}.conv.conv.*``,
``up{k}.{i}.conv.*``, ``output.conv.*``; pytorch_camvid_tpu/interop/
torch_weights.py:31-49), so a reference ``.pth`` loads with ``strict=True``.

NHWC in, NHWC f32 logits out. The model computes in its input's dtype
(the caller casts, as serving's normalize and the train step's augmentation
do) and returns f32 logits (JAX unet.py:156,171). In train mode every block
runs K1 (``ops/conv_train.py``) and BatchNorm with batch statistics,
updating the running stats in place (``ops/conv.py``). ``remat=True``
checkpoints every stage's conv blocks (``models/common.py::remat_call``),
as JAX's ``apply_unet(remat=True)``: the upsamples' conv blocks and the
head too; the bilinear upsample, the pools, the pad and the concat stay
outside.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch_camvid_tpu_torch.models.common import (SegmentationNet, Spec,
                                                    Stage, halvings,
                                                    remat_call)
from pytorch_camvid_tpu_torch.ops.conv import ConvBNReLU, computing_in
from pytorch_camvid_tpu_torch.ops.pooling import max_pool_2x2
from pytorch_camvid_tpu_torch.ops.resize import (
    upsample2x_bilinear_align_corners)


def unet_spec(in_ch: int, num_classes: int):
    """(stage name, [(cin, cout) per conv block]) in forward order."""
    return [
        ("down1", [(in_ch, 64), (64, 64)]),
        ("down2", [(64, 128), (128, 128)]),
        ("down3", [(128, 256), (256, 256)]),
        ("down4", [(256, 512), (512, 512)]),
        ("down5", [(512, 1024), (1024, 1024)]),
        ("upsample1", [(1024, 512)]),
        ("up1", [(1024, 512), (512, 512)]),
        ("upsample2", [(512, 256)]),
        ("up2", [(512, 256), (256, 256)]),
        ("upsample3", [(256, 128)]),
        ("up3", [(256, 128), (128, 128)]),
        ("upsample4", [(128, 64)]),
        ("up4", [(128, 64), (64, 64)]),
        ("output", [(64, num_classes)]),
    ]


def scaled_spec(in_ch: int, num_classes: int, width_mult: float):
    """The spec with every internal channel count scaled by ``width_mult``.

    Concat edges need s(c1 + c2) == s(c1) + s(c2), which holds when every
    scaled internal count is an exact integer >= 4. Internal means every
    count except the data-facing edges by POSITION: the first block's input
    and the head's output (the JAX check filters by value, ADVICE r5 #3)."""
    spec = unet_spec(in_ch, num_classes)
    if width_mult == 1.0:
        return spec
    bad = set()
    for si, (_, pairs) in enumerate(spec):
        for bi, (cin, cout) in enumerate(pairs):
            edges = []
            if not (si == 0 and bi == 0):
                edges.append(cin)
            if not (si == len(spec) - 1 and bi == len(pairs) - 1):
                edges.append(cout)
            bad.update(c for c in edges
                       if c * width_mult != int(c * width_mult)
                       or c * width_mult < 4)
    if bad:
        raise ValueError(
            f"width_mult={width_mult} is invalid: scaled channels for "
            f"{sorted(bad)} are fractional or below 4, which breaks "
            f"concat-edge additivity (e.g. 1/8 or 1/16 are valid)")

    def s(c):
        return int(c * width_mult)
    out = [(name, [(s(a), s(b)) for a, b in pairs]) for name, pairs in spec]
    out[0][1][0] = (in_ch, out[0][1][0][1])
    out[-1][1][-1] = (out[-1][1][-1][0], num_classes)
    return out


def pad_to_match(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """F.pad([dw//2, dw-dw//2, dh//2, dh-dh//2]) (models/unet.py:120-123),
    NHWC. Returns x itself when no pad is needed (F.pad would copy it)."""
    dh = skip.shape[1] - x.shape[1]
    dw = skip.shape[2] - x.shape[2]
    if dh == dw == 0:
        return x
    return F.pad(x, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))


class UpSample2d(nn.Module):
    """Bilinear 2x (align_corners=True) then a conv block
    (reference ``UpSample2d``, models/unet.py:19-32)."""

    def __init__(self, cin, cout, generator=None):
        super().__init__()
        self.conv = ConvBNReLU(cin, cout, generator)

    def forward(self, x, plain: bool = False, remat: bool = False):
        return remat_call(self.conv, upsample2x_bilinear_align_corners(x),
                          plain, remat)


# state_dict suffix of each JAX block leaf under a block's prefix
_SUFFIX = {"w": "0.weight", "b": "0.bias", "scale": "1.weight",
           "bias": "1.bias", "mean": "1.running_mean",
           "var": "1.running_var", "count": "1.num_batches_tracked"}


class UNet(SegmentationNet):
    net = "unet"

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
            if name.startswith("upsample"):
                setattr(self, name, UpSample2d(*pairs[0], generator))
            elif name == "output":
                setattr(self, name, ConvBNReLU(*pairs[0], generator))
            else:
                setattr(self, name, Stage(
                    *[ConvBNReLU(ci, co, generator) for ci, co in pairs]))

    base_spec = staticmethod(unet_spec)

    @staticmethod
    def block_names(stage: str, i: int):
        if stage.startswith("upsample"):
            base = f"{stage}.conv.conv"
        elif stage == "output":
            base = "output.conv"
        else:
            base = f"{stage}.{i}.conv"
        return {k: f"{base}.{suffix}" for k, suffix in _SUFFIX.items()}

    @staticmethod
    def block_sizes(hw):
        """The encoder's levels floor; each upsample block runs at twice
        the level below it (before the pad), each up stage at its skip's
        size."""
        dims = halvings(hw, 5)
        out = []
        for name, pairs in unet_spec(3, 12):
            if name.startswith("down"):
                size = dims[int(name[4:]) - 1]
            elif name.startswith("upsample"):
                h, w = dims[5 - int(name[8:])]
                size = (2 * h, 2 * w)
            elif name.startswith("up"):
                size = dims[4 - int(name[2:])]
            else:
                size = dims[0]
            out += [size] * len(pairs)
        return out

    def forward(self, x: torch.Tensor, plain: bool = False,
                remat: bool = False) -> torch.Tensor:
        """x: (N,H,W,C) float -> f32 logits (N,H,W,class_num), computed in
        x's dtype. ``plain=True`` runs every block's plain version, in eval
        and in train mode: the reference for the kernel path. ``remat=True``
        recomputes each stage in the backward. In an int8-quantized model
        (``ops/quant.py``) int8 passes only inside the down and up stages:
        every stage ends in the compute dtype, so the skips, the pools and
        the bilinear upsample stay float."""
        with computing_in(x.dtype):
            skips = []
            for k in range(1, 6):
                x = getattr(self, f"down{k}")(x, plain, remat)
                if k < 5:
                    skips.append(x)
                    x = max_pool_2x2(x)
            for k, skip in zip(range(1, 5), reversed(skips)):
                x = getattr(self, f"upsample{k}")(x, plain, remat)
                x = torch.cat([pad_to_match(x, skip), skip], dim=-1)
                x = getattr(self, f"up{k}")(x, plain, remat)
            return remat_call(self.output, x, plain, remat).float()
