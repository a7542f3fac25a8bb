"""TableBorder dataset (counterpart of pytorch_camvid_tpu/data/tableborder.py,
a copy; reference: dataset/tableborder.py): table-structure
images with pickled row/col visibility masks stacked depth-wise into a
2-channel mask (tableborder.py:30-48). Side-project dataset with no consumer
in the reference repo; provided for capability parity."""

from __future__ import annotations

import glob
import os
import pickle
from typing import Optional, Tuple

import numpy as np


class TableBorder:
    def __init__(self, root: str, transforms=None,
                 image_size: Optional[Tuple[int, int]] = None):
        self._root = root
        self.transforms = transforms
        self._image_size = image_size
        self._image_names = sorted(
            glob.glob(os.path.join(root, "images", "*")))
        self.class_num = 2
        self.ignore_index = None

    def __len__(self):
        return len(self._image_names)

    def __getitem__(self, index: int):
        import cv2
        image_path = self._image_names[index]
        base = os.path.splitext(os.path.basename(image_path))[0]
        label_path = os.path.join(self._root, "labels", base + ".pkl")

        image = cv2.imread(image_path)
        with open(label_path, "rb") as f:
            rows, cols = pickle.load(f)
        # depth-stack the row/col visibility masks (tableborder.py:42-46)
        mask = np.dstack([np.asarray(rows, np.uint8),
                          np.asarray(cols, np.uint8)])
        if self._image_size is not None:
            image = cv2.resize(image, self._image_size)
            mask = cv2.resize(mask, self._image_size,
                              interpolation=cv2.INTER_NEAREST)
        if self.transforms:
            image, mask = self.transforms(image, mask)
        return image, mask
