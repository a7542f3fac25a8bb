"""Segmentation models (counterpart of pytorch_camvid_tpu/models)."""

from __future__ import annotations

from pytorch_camvid_tpu_torch.models.unet import UNet


def get_model(model_name: str, input_channels: int = 3, class_num: int = 12,
              **kw):
    """Build a model by name (reference utils.py:147-160). Keyword
    arguments go to the model (``width_mult``, ``generator``)."""
    if model_name == "unet":
        return UNet(input_channels, class_num, **kw)
    if model_name == "segnet":
        raise NotImplementedError(
            "segnet is not ported to PyTorch yet; see ROADMAP.md (Queue 1)")
    raise ValueError(f"network type {model_name!r} is not supported")


__all__ = ["UNet", "get_model"]
