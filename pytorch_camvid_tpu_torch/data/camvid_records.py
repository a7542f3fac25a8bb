"""CamVid over the native record store (counterpart of the JAX package's
``data/camvid_records.py``; reference legacy/camvid_lmdb.py: encoded PNGs
packed into a per-split LMDB at first run, then ``__getitem__`` =
txn.get + cv2.imdecode).

The per-split cache is one mmap record store (``data/native.py::
RecordStore``, ``native/recordstore.cpp``'s format): record 2i is image i
as a PNG (BGR), record 2i + 1 its label as a PNG with the 32 -> 12
grouping already applied. The file is the JAX package's,
``<root>/camvid/records_v1_<split>.cvrs``, so either package reads the
other's. It is built atomically (a temporary file, then a rename), so a
crash mid-build leaves no truncated cache. cv2 is imported only to build
and decode. The packed-array ``CamVid`` (``data/camvid.py``) is the
training path; this class is for the record-decode benchmark
(``benchmark.py -records``) and for hosts where the decoded arrays would
not fit in memory.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from pytorch_camvid_tpu_torch.data.camvid import (CAMVID_CLASS_NAMES,
                                                  group_id_lut,
                                                  label_path_for,
                                                  list_split_files)
from pytorch_camvid_tpu_torch.data.native import RecordStore

CACHE_VERSION = 1


def records_path(root: str, image_set: str) -> str:
    """The split's record store: the JAX package's name for it."""
    return os.path.join(root, "camvid",
                        f"records_v{CACHE_VERSION}_{image_set}.cvrs")


class CamVidRecords:
    """CamVid over a record-store cache of encoded PNGs; ``image_size``
    (W, H) resizes on decode (bilinear images, nearest labels)."""

    def __init__(self, root: str, image_set: str = "train", transforms=None,
                 image_size: Optional[Tuple[int, int]] = None):
        if image_set not in ("train", "val"):
            raise RuntimeError("image set should only be train or set")
        self._root = root
        self._image_set = image_set
        self.transforms = transforms
        self._image_size = image_size

        self.class_names = list(CAMVID_CLASS_NAMES)
        self.class_num = len(self.class_names)
        self.ignore_index = self.class_names.index("Void")

        path = records_path(root, image_set)
        if not os.path.exists(path):
            self._build(path)
        self._store = RecordStore(path)
        if len(self._store) % 2:
            raise IOError(f"{path}: odd record count {len(self._store)}")

    def _build(self, path: str) -> None:
        import cv2
        files, codes = list_split_files(os.path.join(self._root, "camvid"),
                                        self._image_set)
        lut = group_id_lut(codes)
        records = []
        for p in files:
            img = cv2.imread(p)
            lab = lut[cv2.imread(label_path_for(p), 0)]
            ok1, img_png = cv2.imencode(".png", img)
            ok2, lab_png = cv2.imencode(".png", lab)
            if not (ok1 and ok2):
                raise IOError(f"cannot encode {p} as PNG")
            records += [img_png.tobytes(), lab_png.tobytes()]
        tmp = path + ".tmp"
        RecordStore.write(tmp, records)
        os.replace(tmp, path)

    def __len__(self) -> int:
        return len(self._store) // 2

    def __getitem__(self, index: int):
        import cv2
        img = cv2.imdecode(np.frombuffer(self._store[2 * index], np.uint8),
                           cv2.IMREAD_COLOR)
        lab = cv2.imdecode(
            np.frombuffer(self._store[2 * index + 1], np.uint8),
            cv2.IMREAD_GRAYSCALE)
        if self._image_size is not None:
            img = cv2.resize(img, self._image_size)
            lab = cv2.resize(lab, self._image_size,
                             interpolation=cv2.INTER_NEAREST)
        if self.transforms:
            img, lab = self.transforms(img, lab)
        return img, lab
