"""CamVid dataset (counterpart of pytorch_camvid_tpu/data/camvid.py;
reference dataset/camvid.py): a numpy copy, because the JAX package's
``data`` pulls in jax.

- fast.ai CamVid tarball layout: ``camvid/images/*.png``,
  ``camvid/labels/*_P.png`` (path rule: '.' -> '_P.'), ``codes.txt`` (32
  class names by id), ``valid.txt`` (val file list) — dataset/camvid.py:98-128;
- 32 -> 12 class grouping (dataset/camvid.py:33-89) with canonical class
  names / class_num=12 / ignore_index=11 ('Void') (dataset/camvid.py:91-96);
- split: train = images NOT listed in valid.txt (600), val = listed (101).
- The grouped, resized split is packed once into an on-disk cache (.npz,
  version-stamped) of two dense uint8 arrays, images NHWC BGR and labels
  NHW; source files are never touched. The cache's name and keys are the
  JAX package's, so both packages read one cache. cv2 is imported only to
  decode and resize while building it.
"""

from __future__ import annotations

import glob
import json
import os
import tarfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CACHE_VERSION = 1

# fast.ai CamVid tarball (dataset/camvid.py:25-27)
CAMVID_URL = "https://s3.amazonaws.com/fast-ai-imagelocal/camvid.tgz"
CAMVID_MD5 = "2e796d442fe723192014ace89a1515b1"

# 32 -> 12 grouping (dataset/camvid.py:33-89). Keys are the 32 CamVid class
# names from codes.txt; values are the 12 canonical groups.
CAMVID_LABEL_GROUPS: Dict[str, str] = {
    "Sky": "Sky",
    "Bridge": "Building", "Building": "Building", "Wall": "Building",
    "Tunnel": "Building", "Archway": "Building",
    "Column_Pole": "Pole", "TrafficCone": "Pole",
    "Road": "Road", "LaneMkgsDriv": "Road", "LaneMkgsNonDriv": "Road",
    "Sidewalk": "Pavement", "ParkingBlock": "Pavement",
    "RoadShoulder": "Pavement",
    "Tree": "Tree", "VegetationMisc": "Tree",
    "SignSymbol": "SignSymbol", "Misc_Text": "SignSymbol",
    "TrafficLight": "SignSymbol",
    "Fence": "Fence",
    "Car": "Car", "SUVPickupTruck": "Car", "Truck_Bus": "Car",
    "Train": "Car", "OtherMoving": "Car",
    "Pedestrian": "Pedestrian", "Child": "Pedestrian",
    "CartLuggagePram": "Pedestrian", "Animal": "Pedestrian",
    "Bicyclist": "Bicyclist", "MotorcycleScooter": "Bicyclist",
    "Void": "Void",
}

CAMVID_CLASS_NAMES: List[str] = [
    "Sky", "Building", "Pole", "Road", "Pavement", "Tree", "SignSymbol",
    "Fence", "Car", "Pedestrian", "Bicyclist", "Void",
]


def group_id_lut(codes: Sequence[str]) -> np.ndarray:
    """256-entry uint8 LUT mapping 32-class ids -> 12-class ids.

    Pure-function replacement for the reference's in-place boolean-mask remap
    (dataset/camvid.py:138-159). Ids >= len(codes) map to themselves, which
    matches the reference (pixels not covered by any mask keep their value).
    """
    lut = np.arange(256, dtype=np.uint8)
    for cls_id_32, name_32 in enumerate(codes):
        name_12 = CAMVID_LABEL_GROUPS[name_32]
        lut[cls_id_32] = CAMVID_CLASS_NAMES.index(name_12)
    return lut


def group_label_ids(label: np.ndarray, codes: Sequence[str]) -> np.ndarray:
    """Map a 32-class label image to 12 classes. Bit-for-bit equal to
    dataset/camvid.py:138-159 on decoded masks (verified in tests)."""
    return group_id_lut(codes)[label]


def label_path_for(image_path: str) -> str:
    """Image path -> label path: labels/ dir and '_P.' suffix
    (dataset/camvid.py:113 rule, applied to the basename only so roots
    containing '.' or 'images' are safe)."""
    d, base = os.path.split(image_path)
    parent, leaf = os.path.split(d)
    assert leaf == "images", image_path
    stem, ext = os.path.splitext(base)
    return os.path.join(parent, "labels", stem + "_P" + ext)


def list_split_files(camvid_dir: str, image_set: str):
    """(sorted image paths of the split, codes list). Split rule
    (dataset/camvid.py:119-128): train = images NOT in valid.txt."""
    with open(os.path.join(camvid_dir, "codes.txt")) as f:
        codes = [line.strip() for line in f.readlines()]
    with open(os.path.join(camvid_dir, "valid.txt")) as f:
        valids = set(line.strip() for line in f.readlines())
    all_images = sorted(glob.glob(os.path.join(camvid_dir, "images",
                                               "*.png")))
    if image_set == "train":
        files = [p for p in all_images
                 if os.path.basename(p) not in valids]
    else:
        files = [p for p in all_images if os.path.basename(p) in valids]
    if not files:
        raise FileNotFoundError(
            f"no CamVid images under {camvid_dir}/images")
    return files, codes


def _resize_pair(image: np.ndarray, label: np.ndarray,
                 size_wh: Tuple[int, int]):
    import cv2  # host-side decode/prep only; never on the training hot path
    img = cv2.resize(image, size_wh)  # bilinear (transforms.py:58)
    lab = cv2.resize(label, size_wh, interpolation=cv2.INTER_NEAREST)
    return img, lab


def cache_path(root: str, image_set: str,
               image_size: Optional[Tuple[int, int]]) -> str:
    """The packed cache of a split at ``image_size`` (W, H; None = native):
    the JAX package's name for it."""
    tag = ("native" if image_size is None
           else f"{image_size[0]}x{image_size[1]}")
    return os.path.join(root, "camvid",
                        f"cache_v{CACHE_VERSION}_{image_set}_{tag}.npz")


def write_cache(path: str, images: np.ndarray, labels: np.ndarray,
                names: List[str]) -> None:
    """Write a split's packed cache atomically: uint8 ``images`` (N,H,W,3)
    BGR, ``labels`` (N,H,W) grouped to 12 classes and the file ``names``,
    under the JAX package's keys."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp[:-4], images=images, labels=labels, names=json.dumps(names))
    os.replace(tmp, path)


class CamVid:
    """CamVid with the reference's constructor surface
    (root, download=False, image_set='train', transforms=None) plus packed
    in-memory arrays for the on-device pipeline.

    ``self.images`` (N,H,W,3) uint8 BGR and ``self.labels`` (N,H,W) uint8 are
    the whole split, already grouped to 12 classes and resized to
    ``image_size`` (None = keep native 720x960).
    """

    def __init__(self, root: str, download: bool = False,
                 image_set: str = "train", transforms=None,
                 image_size: Optional[Tuple[int, int]] = (480, 360)):
        self._root = root
        self._image_set = image_set
        self.transforms = transforms
        self._image_size = image_size

        self.class_names = list(CAMVID_CLASS_NAMES)
        self.class_num = len(self.class_names)
        self.ignore_index = self.class_names.index("Void")

        if download:
            self._download()

        if image_set not in ("train", "val"):
            raise RuntimeError("image set should only be train or set")

        self._maybe_extract()
        self.images, self.labels, self.names = self._load_or_build_cache()

    # ---- download / extraction ----
    def _camvid_dir(self) -> str:
        return os.path.join(self._root, "camvid")

    def _download(self, timeout: float = 30.0):
        """Fetch the fast.ai tarball + md5-check it (dataset/camvid.py:25-31
        via torchvision download_url). Skips when the data or the tarball is
        already present; FAILS LOUDLY when the fetch is impossible (e.g. a
        zero-egress environment) instead of deferring to a confusing
        FileNotFoundError later."""
        import hashlib
        import urllib.request

        tgz = os.path.join(self._root, "camvid.tgz")
        if os.path.exists(self._camvid_dir()) or os.path.exists(tgz):
            return  # already downloaded/extracted (download_url's skip rule)
        os.makedirs(self._root, exist_ok=True)
        tmp = tgz + ".part"
        try:
            md5 = hashlib.md5()
            with urllib.request.urlopen(CAMVID_URL, timeout=timeout) as r, \
                    open(tmp, "wb") as f:
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    md5.update(chunk)
                    f.write(chunk)
            if md5.hexdigest() != CAMVID_MD5:
                raise RuntimeError(
                    f"camvid.tgz md5 {md5.hexdigest()} != expected "
                    f"{CAMVID_MD5} — corrupt download")
            os.replace(tmp, tgz)
        except RuntimeError:
            raise
        except Exception as e:
            raise RuntimeError(
                f"could not download {CAMVID_URL}: {e!r}. In an offline "
                f"environment, place camvid.tgz (or an extracted camvid/ "
                f"tree) under {self._root!r} and rerun without -download."
            ) from e
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def _maybe_extract(self):
        tgz = os.path.join(self._root, "camvid.tgz")
        if not os.path.exists(self._camvid_dir()) and os.path.exists(tgz):
            with tarfile.open(tgz, "r") as tar:
                tar.extractall(path=self._root)

    # ---- cache ----
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

    def _build_arrays(self):
        import cv2
        files, codes = list_split_files(self._camvid_dir(),
                                        self._image_set)
        lut = group_id_lut(codes)
        imgs, labs, names = [], [], []
        for p in files:
            img = cv2.imread(p)  # BGR, like the reference
            lab = cv2.imread(label_path_for(p), 0)
            lab = lut[lab]
            if self._image_size is not None:
                img, lab = _resize_pair(img, lab, self._image_size)
            imgs.append(img)
            labs.append(lab)
            names.append(os.path.basename(p))
        return (np.stack(imgs).astype(np.uint8),
                np.stack(labs).astype(np.uint8), names)

    # ---- torch-style per-sample surface (dataset/camvid.py:161-173) ----
    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int):
        image = self.images[index].copy()
        label = self.labels[index].copy()
        if self.transforms:
            image, label = self.transforms(image, label)
        return image, label
