"""One-shot VOC label prep (counterpart of
pytorch_camvid_tpu/data/segmentation_aug.py, a copy; reference:
dataset/segementation_aug.py): strip the PNG palette colormap from
``SegmentationClassAug/*`` into ``SegmentationClassAugRaw/`` so labels
decode as raw class ids. PIL is imported only inside ``strip_palette``.

    python -m pytorch_camvid_tpu_torch.data.segmentation_aug -voc_root <dir>
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def strip_palette(src_dir: str, dst_dir: str) -> int:
    """Convert every palette PNG in src_dir to a raw uint8 label PNG in
    dst_dir; returns the number converted (segementation_aug.py:9-46)."""
    from PIL import Image
    os.makedirs(dst_dir, exist_ok=True)
    count = 0
    for path in glob.glob(os.path.join(src_dir, "*.png")):
        arr = np.array(Image.open(path))  # palette index array
        out = Image.fromarray(arr.astype(np.uint8))
        out.save(os.path.join(dst_dir, os.path.basename(path)))
        count += 1
    return count


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("-voc_root", type=str, required=True,
                        help="VOC2012 root containing SegmentationClassAug")
    args = parser.parse_args()
    n = strip_palette(os.path.join(args.voc_root, "SegmentationClassAug"),
                      os.path.join(args.voc_root, "SegmentationClassAugRaw"))
    print(f"converted {n} label files")
