"""Predict CLI (counterpart of the JAX package's root predict.py; reference
predict.py): single-image inference.

    python -m pytorch_camvid_tpu_torch.predict -img in.png -weight <ckpt>
        [-net unet] [-c 12] [-device cuda]

Reads an image with cv2, resizes it to ``settings.IMAGE_SIZE``, runs it
through ``serving.Predictor`` in float32, as the JAX CLI computes (every
conv block on the fused kernel's f32 instance on CUDA), nearest-resizes the
class map
back to the source size and writes the JAX CLI's three files in the working
directory: ``src.jpg``, ``predict.jpg`` (class indices) and
``predict_color.png`` (12-class palette). Takes a reference ``.pth`` or a
``.ckpt.npz`` of either package. ``-device`` defaults to ``cuda`` and fails
without one.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from pytorch_camvid_tpu_torch.config import settings


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_camvid_tpu_torch.predict")
    p.add_argument("-img", type=str, required=True,
                   help="image path to predict")
    p.add_argument("-weight", type=str, required=True,
                   help="weight file path (.pth or .ckpt.npz)")
    p.add_argument("-c", type=int, default=12, help="class number")
    p.add_argument("-net", type=str, default="unet", help="network name")
    p.add_argument("-device", type=str, default="cuda",
                   help="torch device the model runs on (default cuda; no "
                   "fallback to the CPU)")
    return p


def main(argv=None) -> np.ndarray:
    """Run the CLI; returns the class map at the source size."""
    args = parser().parse_args(argv)
    import cv2

    from pytorch_camvid_tpu_torch.serving import Predictor
    from pytorch_camvid_tpu_torch.train.loop import check_device
    from pytorch_camvid_tpu_torch.utils.viz import colorize_mask

    check_device(args.device, "float32")
    src = cv2.imread(args.img)
    if src is None:
        raise FileNotFoundError(args.img)
    w, h = settings.IMAGE_SIZE
    image = cv2.resize(src, (w, h))
    with Predictor.from_checkpoint(args.net, args.weight, batch_size=1,
                                   image_hw=(h, w), num_classes=args.c,
                                   compute_dtype=torch.float32,
                                   device=args.device) as p:
        preds = p.predict(image[None])[0]
    preds = cv2.resize(preds, src.shape[:2][::-1],
                       interpolation=cv2.INTER_NEAREST)
    cv2.imwrite("src.jpg", src)
    cv2.imwrite("predict.jpg", preds)
    cv2.imwrite("predict_color.png", colorize_mask(preds, args.c))
    print(f"wrote src.jpg, predict.jpg, predict_color.png "
          f"(classes present: {sorted(np.unique(preds).tolist())})")
    return preds


if __name__ == "__main__":
    main()
    sys.exit(0)
