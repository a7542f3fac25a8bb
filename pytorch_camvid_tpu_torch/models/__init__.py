"""Segmentation models (counterpart of pytorch_camvid_tpu/models)."""

from __future__ import annotations

from typing import Dict

import torch

from pytorch_camvid_tpu_torch.models.common import Spec
from pytorch_camvid_tpu_torch.models.segnet import SegNet
from pytorch_camvid_tpu_torch.models.unet import UNet

MODELS = {"unet": UNet, "segnet": SegNet}


def model_class(model_name: str):
    if model_name not in MODELS:
        raise ValueError(f"network type {model_name!r} is not supported")
    return MODELS[model_name]


def get_model(model_name: str, input_channels: int = 3, class_num: int = 12,
              **kw):
    """Build a model by name (reference utils.py:147-160). Keyword
    arguments go to the model (``width_mult``, ``generator``, ``spec``)."""
    return model_class(model_name)(input_channels, class_num, **kw)


def spec_from_state_dict(model_name: str,
                         state_dict: Dict[str, torch.Tensor]) -> Spec:
    """The model's spec read off a reference-named state_dict: each block's
    (cin, cout) from its conv weight's shape, so any width loads."""
    cls = model_class(model_name)
    spec = []
    for stage, pairs in cls.base_spec(3, 12):
        convs = [state_dict[cls.block_names(stage, i)["w"]].shape
                 for i in range(len(pairs))]
        spec.append((stage, [(int(s[1]), int(s[0])) for s in convs]))
    return spec


__all__ = ["MODELS", "SegNet", "UNet", "get_model", "model_class",
           "spec_from_state_dict"]
