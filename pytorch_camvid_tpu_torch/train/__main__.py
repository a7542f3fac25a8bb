"""Train CLI (counterpart of the JAX package's root train.py; reference
train.py):

    python -m pytorch_camvid_tpu_torch.train -net unet [-b 10] [-e 120]
        [-lr 5e-4] [-wd 0] [-resume] [-data data] [-image_size W H]
        [-dtype float32] [-accum 1] [-remat] [-chain 8] [-seed 0] [-quiet]
        [-dataset camvid|voc2012] [-loader device|host] [-device cuda]

The JAX CLI's flags plus ``-device`` (default ``cuda``; without a CUDA
device it fails, ``-device cpu`` runs on the CPU). ``-dtype`` defaults to
``float32``, the JAX CLI's "reference numerics", which runs on the card's
f32 kernels; ``-dtype bfloat16`` runs the bf16 ones. Checkpoints and TB
logs land cwd-relative,
in ``checkpoints/<time>/`` and ``runs/<time>/``, as the reference's do.
``-dataset voc2012`` trains on the VOC caches (``data/voc2012.py``) with
VOC's mean and std and 255 (the ignore label and the letterbox pad) kept
out of the loss, as the JAX CLI does; ``-loader host`` streams the
batches from host memory (``data/pipeline.py::HostLoader``); ``-remat``
recomputes each model stage's activations in the backward (less memory,
one more forward; the same losses). Flags whose parts are not ported raise
``NotImplementedError`` naming their ROADMAP.md item: ``-dp`` > 1 and
``-multihost``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from pytorch_camvid_tpu_torch.config import settings as default_settings
from pytorch_camvid_tpu_torch.data.camvid import CamVid
from pytorch_camvid_tpu_torch.data.voc2012 import VOC2012Aug
from pytorch_camvid_tpu_torch.train.loop import (TrainConfig, check_device,
                                                 check_ported, not_ported,
                                                 run_training)
from pytorch_camvid_tpu_torch.utils.tb import SummaryLogger


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_camvid_tpu_torch.train")
    p.add_argument("-b", type=int, default=10,
                   help="batch size for dataloader")
    p.add_argument("-lr", type=float, default=5e-4,
                   help="initial learning rate")
    p.add_argument("-e", type=int, default=120, help="training epoches")
    p.add_argument("-wd", type=float, default=0, help="weight decay")
    p.add_argument("-resume", action="store_true", default=False,
                   help="if resume training")
    p.add_argument("-net", type=str, required=True, help="network name")
    p.add_argument("-download", action="store_true", default=False,
                   help="whether to download camvid dataset")
    p.add_argument("-data", type=str, default="data",
                   help="dataset root folder")
    p.add_argument("-dataset", type=str, default="camvid",
                   choices=["camvid", "voc2012"],
                   help="dataset to train on")
    p.add_argument("-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype (float32: reference numerics)")
    p.add_argument("-dp", type=int, default=0,
                   help="data-parallel devices (0 and 1: one device; more "
                   "is not ported yet)")
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-quiet", action="store_true", default=False)
    p.add_argument("-image_size", type=int, nargs=2, default=None,
                   metavar=("W", "H"),
                   help="working size in cv2 (W, H) order; default "
                   "settings.IMAGE_SIZE = (480, 360)")
    p.add_argument("-remat", action="store_true", default=False,
                   help="recompute each stage's activations in the "
                   "backward (less activation memory, one more forward)")
    p.add_argument("-accum", type=int, default=1,
                   help="gradient-accumulation microbatches per step "
                   "(batch must divide; lowers activation memory)")
    p.add_argument("-loader", type=str, default="device",
                   choices=["device", "host"],
                   help="input pipeline: device = the split resident on "
                   "the device (default); host = host arrays, native "
                   "gather and double-buffered copies")
    p.add_argument("-chain", type=int, default=8,
                   help="train steps queued per metrics copy to the host "
                   "(1 = one step at a time like the reference loop)")
    p.add_argument("-multihost", action="store_true", default=False,
                   help="multi-process training (not ported yet)")
    p.add_argument("-device", type=str, default="cuda",
                   help="torch device the run uses (default cuda; no "
                   "fallback to the CPU)")
    return p


def main(argv=None):
    """Run the CLI; returns the run's per-epoch history (see
    ``loop.run_training``)."""
    args = parser().parse_args(argv)
    check_device(args.device, args.dtype)
    if args.multihost:
        raise not_ported("-multihost", "multi-GPU")
    settings = default_settings
    image_size = (tuple(args.image_size) if args.image_size
                  else settings.IMAGE_SIZE)
    checkpoint_path = os.path.join(settings.CHECKPOINT_FOLDER,
                                   settings.TIME_NOW)
    log_dir = os.path.join(settings.LOG_FOLDER, settings.TIME_NOW)
    cfg = TrainConfig(
        net=args.net, batch_size=args.b, lr=args.lr, epochs=args.e,
        weight_decay=args.wd, resume=args.resume, seed=args.seed,
        compute_dtype=args.dtype, data_parallel=args.dp,
        checkpoint_dir=checkpoint_path, log_dir=log_dir, quiet=args.quiet,
        save_epoch=settings.SAVE_EPOCH, loader=args.loader,
        grad_accum=args.accum, remat=args.remat, dispatch_chain=args.chain,
        device=args.device)
    check_ported(cfg)
    os.makedirs(checkpoint_path, exist_ok=True)
    os.makedirs(log_dir, exist_ok=True)

    if args.dataset == "voc2012":
        train_dataset = VOC2012Aug(args.data, image_set="train",
                                   image_size=image_size)
        valid_dataset = VOC2012Aug(args.data, image_set="val",
                                   image_size=image_size)
        settings = dataclasses.replace(settings, MEAN=settings.VOC_MEAN,
                                       STD=settings.VOC_STD)
        # 255: the ignore label and the letterbox pad (train.py:105-114)
        cfg = dataclasses.replace(
            cfg, loss_ignore_index=train_dataset.ignore_index)
    else:
        train_dataset = CamVid(args.data, image_set="train",
                               download=args.download, image_size=image_size)
        valid_dataset = CamVid(args.data, image_set="val",
                               download=args.download, image_size=image_size)
    print()

    logger = SummaryLogger(log_dir)
    try:
        _, history = run_training(cfg, train_dataset, valid_dataset,
                                  settings=settings, logger=logger)
    finally:
        logger.close()
    return history


if __name__ == "__main__":
    main()
    sys.exit(0)
