"""Pascal VOC2012 (augmented / SBD) dataset (counterpart of
pytorch_camvid_tpu/data/voc2012.py, a numpy copy: the JAX package's
``data`` pulls in jax; reference dataset/voc2012.py).

Capability parity: 21 classes, ignore index 255, trainaug.txt (10,582) /
val.txt (1,449) splits under ``ImageSets/Segmentation``, images under
``JPEGImages``, labels under ``SegmentationClassAugRaw`` (the palette-
stripped labels produced by segmentation_aug.py). The reference stores but
never applies its transforms (dataset/voc2012.py:31,37-52 — SURVEY.md
§2.1); here transforms are applied like every other dataset.

Like CamVid, the split is packed into a versioned uint8 cache at a fixed
working size, under the JAX package's name and keys, so both packages read
one cache. VOC images vary in size; they are letterboxed (resized with
preserved aspect, then padded: image 0, label 255) so the packed array is
dense. cv2 is imported only to decode and resize while building a cache.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

CACHE_VERSION = 1

VOC_CLASS_NAMES: List[str] = [
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


def cache_path(root: str, image_set: str,
               image_size: Optional[Tuple[int, int]]) -> str:
    """The packed cache of a split at ``image_size`` (W, H; None = native,
    named 0x0): the JAX package's name for it."""
    w, h = image_size if image_size else (0, 0)
    return os.path.join(root,
                        f"cache_v{CACHE_VERSION}_{image_set}_{w}x{h}.npz")


def write_cache(path: str, images: np.ndarray, labels: np.ndarray,
                names: List[str]) -> None:
    """Write a split's packed cache atomically: uint8 ``images`` (N,H,W,3)
    BGR, ``labels`` (N,H,W) with 255 for ignored pixels and the sample
    ``names``, under the JAX package's keys."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp[:-4], images=images, labels=labels, names=json.dumps(names))
    os.replace(tmp, path)


class VOC2012Aug:
    """Augmented VOC2012 with the packed-cache surface of CamVid."""

    def __init__(self, root: str, image_set: str = "train", transforms=None,
                 image_size: Optional[Tuple[int, int]] = (480, 360)):
        if image_set not in ("train", "val"):
            raise RuntimeError("image set should only be train or val")
        self._root = root
        self._image_set = image_set
        self.transforms = transforms
        self._image_size = image_size

        self.class_names = list(VOC_CLASS_NAMES)
        self.class_num = len(self.class_names)  # 21
        self.ignore_index = 255

        self.images, self.labels, self.names = self._load_or_build_cache()

    def _split_file(self) -> str:
        name = "trainaug.txt" if self._image_set == "train" else "val.txt"
        return os.path.join(self._root, "ImageSets", "Segmentation", name)

    def _cache_path(self) -> str:
        return cache_path(self._root, self._image_set, self._image_size)

    def _load_or_build_cache(self):
        path = self._cache_path()
        if os.path.exists(path):
            z = np.load(path, allow_pickle=False)
            return z["images"], z["labels"], list(json.loads(str(z["names"])))
        images, labels, names = self._build_arrays()
        write_cache(path, images, labels, names)
        return images, labels, names

    def _letterbox(self, img, lab):
        import cv2
        w, h = self._image_size
        ih, iw = img.shape[:2]
        scale = min(w / iw, h / ih)
        nw, nh = int(round(iw * scale)), int(round(ih * scale))
        img = cv2.resize(img, (nw, nh))
        lab = cv2.resize(lab, (nw, nh), interpolation=cv2.INTER_NEAREST)
        top = (h - nh) // 2
        left = (w - nw) // 2
        img = cv2.copyMakeBorder(img, top, h - nh - top, left, w - nw - left,
                                 cv2.BORDER_CONSTANT, value=[0, 0, 0])
        lab = cv2.copyMakeBorder(lab, top, h - nh - top, left, w - nw - left,
                                 cv2.BORDER_CONSTANT, value=255)
        return img, lab

    def _build_arrays(self):
        import cv2
        with open(self._split_file()) as f:
            names = [line.strip() for line in f if line.strip()]
        imgs, labs = [], []
        for name in names:
            ip = os.path.join(self._root, "JPEGImages", name + ".jpg")
            lp = os.path.join(self._root, "SegmentationClassAugRaw",
                              name + ".png")
            img = cv2.imread(ip)       # BGR like the reference (cv2.imread)
            lab = cv2.imread(lp, 0)
            if img is None or lab is None:
                raise FileNotFoundError(f"missing {ip} or {lp}")
            if self._image_size is not None:
                img, lab = self._letterbox(img, lab)
            imgs.append(img)
            labs.append(lab)
        return (np.stack(imgs).astype(np.uint8),
                np.stack(labs).astype(np.uint8), names)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index: int):
        image = self.images[index].copy()
        label = self.labels[index].copy()
        if self.transforms:
            image, label = self.transforms(image, label)
        return image, label
