"""Serving constants (counterpart of pytorch_camvid_tpu/config.py:21-26)."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Settings:
    # CamVid per-channel mean/std in [0,1], **BGR order** to match the
    # reference's cv2 pipeline (conf/settings.py:7-9).
    MEAN: Tuple[float, float, float] = (
        0.42019099703461577, 0.41323568513979647, 0.4010048431259079)
    STD: Tuple[float, float, float] = (
        0.30598050258519743, 0.3089986932156864, 0.3054061869915674)
    # CamVid's 32 source labels grouped into 12 classes.
    NUM_CLASSES: int = 12


settings = Settings()
