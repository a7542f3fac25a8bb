"""Batch serving CLI: folder -> class maps through ``serving.Predictor``
(counterpart of serve.py at the repo root).

Usage:
    python -m pytorch_camvid_tpu_torch.serve -weight model.pth \
        -input imgs/ -output masks/ [-net unet] [-b 8] [-c 12] [-color] \
        [-int8] [-dp 1] [-device cuda]

Writes ``<stem>_mask.png`` (class indices) and, with ``-color``,
``<stem>_color.png`` (12-class palette) per input image. Takes a reference
``.pth`` or a ``.ckpt.npz`` of either package. ``-device`` names where the model runs (default
``cuda``); without a CUDA device the default fails instead of running on
the CPU. ``-int8`` quantizes the model after post-training calibration on
the served images (``Predictor.quantize_int8``, as the JAX CLI's
serve.py:111-112), so every block of 64 or more output channels runs the
int8 kernel. ``-dp n`` serves with one replica on each of the first n
cards (``Predictor(devices=...)``; the batch must divide by n); more than
are visible exits with the JAX CLI's message. With ``-device cpu`` the n
replicas share the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from pytorch_camvid_tpu_torch.config import settings

IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff"}


def list_images(path: str):
    if os.path.isfile(path):
        return [path]
    files = sorted(
        os.path.join(path, f) for f in os.listdir(path)
        if os.path.splitext(f)[1].lower() in IMG_EXTS)
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    return files


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-weight", type=str, required=True,
                        help=".pth or .ckpt.npz checkpoint")
    parser.add_argument("-input", type=str, required=True,
                        help="image file or folder")
    parser.add_argument("-output", type=str, required=True,
                        help="output folder for masks")
    parser.add_argument("-net", type=str, default="unet")
    parser.add_argument("-b", type=int, default=8,
                        help="serving batch size")
    parser.add_argument("-c", type=int, default=settings.NUM_CLASSES,
                        help="class number")
    parser.add_argument("-color", action="store_true",
                        help="also write palette-colorized masks")
    parser.add_argument("-int8", action="store_true",
                        help="post-training int8 quantization: calibrate "
                        "on the request's first images, then run every "
                        "block of 64 or more output channels on the int8 "
                        "kernel")
    parser.add_argument("-dp", type=int, default=1,
                        help="data-parallel serving over the first N "
                        "devices (batch must divide by N)")
    parser.add_argument("-device", type=str, default="cuda",
                        help="torch device the model runs on")
    args = parser.parse_args(argv)

    devices = [args.device] * args.dp
    if args.dp > 1 and args.device.startswith("cuda"):
        import torch
        visible = torch.cuda.device_count()
        if visible < args.dp:
            raise SystemExit(f"-dp {args.dp} but only {visible} devices "
                             f"visible")
        devices = [f"cuda:{i}" for i in range(args.dp)]

    import cv2

    from pytorch_camvid_tpu_torch.serving import Predictor
    from pytorch_camvid_tpu_torch.utils.viz import colorize_mask

    files = list_images(args.input)
    os.makedirs(args.output, exist_ok=True)

    images = []
    for f in files:
        img = cv2.imread(f)
        if img is None:
            raise FileNotFoundError(f)
        images.append(img)

    with Predictor.from_checkpoint(args.net, args.weight, batch_size=args.b,
                                   num_classes=args.c, device=args.device,
                                   devices=devices) as predictor:
        # Predictor resizes uniform stacks on the device. Ragged folders are
        # resized per image on the host (cv2 bilinear, the device path's
        # convention): one max-extent canvas would misalign every smaller
        # image's mask with its content.
        if len({i.shape[:2] for i in images}) > 1:
            h, w = predictor.image_hw
            images = [cv2.resize(i, (w, h), interpolation=cv2.INTER_LINEAR)
                      for i in images]
        batch = np.stack(images)
        if args.int8:
            predictor.quantize_int8(batch)
        t0 = time.perf_counter()
        masks = predictor.predict(batch)
        dt = time.perf_counter() - t0

    for f, m in zip(files, masks):
        stem = os.path.splitext(os.path.basename(f))[0]
        cv2.imwrite(os.path.join(args.output, f"{stem}_mask.png"), m)
        if args.color:
            cv2.imwrite(os.path.join(args.output, f"{stem}_color.png"),
                        colorize_mask(m, args.c))
    print(f"served {len(files)} images in {dt:.2f}s "
          f"({len(files) / dt:.1f} img/s on {args.device}) -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
