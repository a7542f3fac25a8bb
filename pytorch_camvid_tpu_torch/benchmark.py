"""Data-pipeline throughput (counterpart of the JAX package's root
benchmark.py; reference benchmark.py iterates the Python/OpenCV per-sample
pipeline and prints samples/sec every 1000):

    python -m pytorch_camvid_tpu_torch.benchmark [-b 8] [-data data]
        [-epochs 500] [-synthetic] [-records] [-device cuda]

Default: augmented samples/s through what sits in front of the model on
the training path, on the device: the batch gathered from resident uint8
arrays (``data/pipeline.py::DeviceDataLoader``) and the reference
augmentation (``data/augment.py::make_train_augment``, CamVid's mean and
std, rotation and scale fill 11) drawn from an explicit ``torch.Generator``
on the device. The batch indices are JAX's: ``default_rng(0).integers(0, n,
b)`` per batch, ``ceil(n / b)`` batches an epoch. The data is CamVid's train
split at ``settings.IMAGE_SIZE`` (``-data``), or 64 synthetic images with
``-synthetic``. ``-records``: the host's per-sample decode throughput over
the record store (``data/camvid_records.py``), no device involved.

Prints the card's name and power limit first (on CUDA), then JAX's "total
N samples, total Ts, average R samples/sec" line every ~1000 samples, each
after a device sync, and once at the end; the run stops after the first
epoch that ends past 60 s. ``-device`` defaults to ``cuda`` (no fallback);
``-device cpu`` runs on the host.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Tuple

import numpy as np
import torch

from pytorch_camvid_tpu_torch import bench
from pytorch_camvid_tpu_torch.config import settings
from pytorch_camvid_tpu_torch.data.augment import (AugmentConfig,
                                                   make_train_augment)
from pytorch_camvid_tpu_torch.data.pipeline import DeviceDataLoader
from pytorch_camvid_tpu_torch.data.synthetic import synthetic_arrays
from pytorch_camvid_tpu_torch.train.loop import check_device

TIME_CAP_S = 60.0   # no new epoch after this many seconds (JAX's cap)


def _line(count: int, seconds: float) -> str:
    return ("total {} samples, total {:.2f}s, average {:.0f} samples/sec"
            .format(count, seconds, count / seconds))


def records_throughput(data: str, epochs: int, hw: Tuple[int, int]) -> int:
    """Decode every train record per epoch; returns the samples decoded."""
    from pytorch_camvid_tpu_torch.data.camvid_records import CamVidRecords
    from pytorch_camvid_tpu_torch.data.native import native_available
    ds = CamVidRecords(data, image_set="train", image_size=hw[::-1])
    print(f"record store: {len(ds)} records, native lib: "
          f"{native_available()}")
    count, start = 0, time.perf_counter()
    for _ in range(epochs):
        for i in range(len(ds)):
            ds[i]
            count += 1
            if count % 1000 == 0:
                print(_line(count, time.perf_counter() - start))
        if time.perf_counter() - start > TIME_CAP_S:
            break
    print(_line(count, time.perf_counter() - start))
    return count


def augment_throughput(images: np.ndarray, labels: np.ndarray, batch: int,
                       epochs: int, device: torch.device) -> int:
    """Gather + augment ``batch`` samples at a time on ``device``; returns
    the samples augmented."""
    n = images.shape[0]
    loader = DeviceDataLoader(images, labels, batch, device=device)
    aug = make_train_augment(AugmentConfig(
        mean=settings.MEAN, std=settings.STD, rotation_fill=11,
        scale_fill=11))
    gen = torch.Generator(device=device).manual_seed(0)
    rng = np.random.default_rng(0)

    def pipeline():
        return aug(gen, *loader.gather(rng.integers(0, n, size=batch)))

    x, _ = pipeline()   # warm-up
    float(x[0, 0, 0, 0])
    count, start = 0, time.perf_counter()
    for _ in range(epochs):
        for _ in range(0, n, batch):
            x, _ = pipeline()
            count += batch
            if count % 1000 < batch:
                float(x[0, 0, 0, 0])   # sync
                print(_line(count, time.perf_counter() - start))
        if time.perf_counter() - start > TIME_CAP_S:
            break
    float(x[0, 0, 0, 0])
    print(_line(count, time.perf_counter() - start))
    return count


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_camvid_tpu_torch.benchmark")
    p.add_argument("-b", type=int, default=8, help="batch size")
    p.add_argument("-data", type=str, default="data")
    p.add_argument("-epochs", type=int, default=500,
                   help="epochs to iterate (reference: 500)")
    p.add_argument("-synthetic", action="store_true", default=False,
                   help="use synthetic data (no dataset needed)")
    p.add_argument("-records", action="store_true", default=False,
                   help="benchmark the record-store decode pipeline on "
                   "the host (native mmap store + cv2.imdecode a sample)")
    p.add_argument("-device", type=str, default="cuda",
                   help="torch device of the augmentation (default cuda; "
                   "no fallback to the CPU)")
    return p


def run(args, hw: Tuple[int, int] = settings.image_hw) -> int:
    """The benchmark of parsed ``args`` at (H, W) ``hw``; returns the
    samples counted."""
    if args.records:
        return records_throughput(args.data, args.epochs, hw)
    dev = check_device(args.device, "float32")
    if dev.type == "cuda":
        print(f"device: {bench.card(dev.index or 0)}")
    if args.synthetic:
        images, labels = synthetic_arrays(64, hw=hw)
    else:
        from pytorch_camvid_tpu_torch.data.camvid import CamVid
        ds = CamVid(args.data, image_set="train", image_size=hw[::-1])
        images, labels = ds.images, ds.labels
    return augment_throughput(images, labels, args.b, args.epochs, dev)


def main(argv=None) -> int:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
    sys.exit(0)
