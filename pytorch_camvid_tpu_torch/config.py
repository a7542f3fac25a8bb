"""Global configuration (counterpart of pytorch_camvid_tpu/config.py:18-67;
reference conf/settings.py + conf/__init__.py).

The same attribute surface as the JAX package's ``Settings``
(``settings.IMAGE_SIZE``, ``settings.MEAN`` ...). ``COMPUTE_DTYPE``,
``SYNC_BN`` and ``DATA_PARALLEL`` keep the JAX package's names and values;
the port's train and eval CLIs take ``-dtype bfloat16`` by default on their
own (the card's kernels take bf16 only), not from here.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Settings:
    # CamVid per-channel mean/std in [0,1], **BGR order** to match the
    # reference's cv2 pipeline (conf/settings.py:7-9).
    MEAN: Tuple[float, float, float] = (
        0.42019099703461577, 0.41323568513979647, 0.4010048431259079)
    STD: Tuple[float, float, float] = (
        0.30598050258519743, 0.3089986932156864, 0.3054061869915674)

    # Pascal VOC2012 BGR stats (conf/settings.py:3-5, commented out there).
    VOC_MEAN: Tuple[float, float, float] = (
        0.40450239443559777, 0.4373051208637668, 0.45734658153594476)
    VOC_STD: Tuple[float, float, float] = (
        0.2846743681700796, 0.27163815793569834, 0.2747289066704502)

    CHECKPOINT_FOLDER: str = "checkpoints"
    LOG_FOLDER: str = "runs"

    # ISO timestamp naming run folders (conf/settings.py:14).
    TIME_NOW: str = dataclasses.field(
        default_factory=lambda: datetime.now().isoformat())

    # Save a "regular" checkpoint every SAVE_EPOCH epochs (conf/settings.py:17).
    SAVE_EPOCH: int = 10

    DATA_PATH: str = "data"

    # (W, H) in cv2 order (conf/settings.py:21); tensors are H=360, W=480.
    IMAGE_SIZE: Tuple[int, int] = (480, 360)

    MILESTONES: Tuple[int, ...] = (100, 150)

    IGNORE_LABEL: int = 255  # VOC ignore label (conf/settings.py:25)

    # CamVid's 32 source labels grouped into 12 classes.
    NUM_CLASSES: int = 12

    # the JAX package's device knobs, same names and values
    COMPUTE_DTYPE: str = "float32"
    SYNC_BN: bool = True
    DATA_PARALLEL: int = 0

    @property
    def image_hw(self) -> Tuple[int, int]:
        """(H, W) tensor-order image size."""
        w, h = self.IMAGE_SIZE
        return (h, w)


settings = Settings()
