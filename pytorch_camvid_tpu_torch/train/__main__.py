"""Train CLI (counterpart of the JAX package's root train.py; reference
train.py):

    python -m pytorch_camvid_tpu_torch.train -net unet [-b 10] [-e 120]
        [-lr 5e-4] [-wd 0] [-resume] [-data data] [-image_size W H]
        [-dtype float32] [-accum 1] [-remat] [-chain 8] [-seed 0] [-quiet]
        [-dataset camvid|voc2012] [-loader device|host] [-device cuda]
        [-dp 0] [-multihost]

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
one more forward; the same losses).

Data parallelism (``train/loop.py``): ``-dp n`` runs n ranks on this
host, one card each (``cuda:0`` .. ``cuda:n-1``), spawned by
``parallel/launch.py::spawn`` after the kernels are built; ``-dp 0`` (the
default, as the JAX CLI's) takes every visible card, and more than are
visible raise. With ``-device cpu`` the ranks are CPU processes (``-dp
0``: one). ``-b`` is the global batch. ``-multihost`` makes this process
one rank of a run set up by ``PCT_COORDINATOR`` (``host:port`` or an
init URL), ``PCT_NUM_PROCS``, ``PCT_PROC_ID`` and ``PCT_INIT_TIMEOUT``
(``parallel/multihost.py::init_distributed``), on the card of its place
among the host's ranks. The backend follows from the devices: NCCL with a
card per rank, gloo where ranks share one or run on the CPU. Rank 0 alone
prints the epochs and writes ``checkpoints/`` and ``runs/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from pytorch_camvid_tpu_torch.config import settings as default_settings
from pytorch_camvid_tpu_torch.data.camvid import CamVid
from pytorch_camvid_tpu_torch.data.voc2012 import VOC2012Aug
from pytorch_camvid_tpu_torch.parallel import launch, make_mesh, multihost
from pytorch_camvid_tpu_torch.train.loop import (TrainConfig, check_device,
                                                 check_ported, run_training)
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
                   help="data-parallel ranks on this host, one card each "
                   "(0 = every visible card)")
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
                   help="join a multi-process run set up by "
                   "PCT_COORDINATOR / PCT_NUM_PROCS / PCT_PROC_ID; rank 0 "
                   "owns console/TB/checkpoint writes")
    p.add_argument("-device", type=str, default="cuda",
                   help="torch device the run uses (default cuda; no "
                   "fallback to the CPU)")
    return p


def main(argv=None):
    """Run the CLI; returns the run's per-epoch history (see
    ``loop.run_training``; rank 0's in a data-parallel run)."""
    args = parser().parse_args(argv)
    check_device(args.device, args.dtype)
    if args.multihost:
        multihost.init_distributed(device=args.device)
        try:
            return run(args, make_mesh())
        finally:
            multihost.shutdown()
    n = launch.rank_count(args.dp, args.device)
    if n > 1:
        return launch.spawn(rank_main, n, argv,
                            devices=launch.local_devices(n, args.device))[0]
    return run(args, None)


def rank_main(mesh, argv):
    """A spawned rank of ``-dp n``: the run on ``mesh.device``."""
    return run(parser().parse_args(argv), mesh)


def run(args, mesh):
    """The run of one process: alone (``mesh`` None) or as a rank."""
    settings = default_settings
    primary = mesh is None or mesh.is_primary()
    device = args.device if mesh is None else str(mesh.device)
    image_size = (tuple(args.image_size) if args.image_size
                  else settings.IMAGE_SIZE)
    checkpoint_path = os.path.join(settings.CHECKPOINT_FOLDER,
                                   settings.TIME_NOW)
    log_dir = os.path.join(settings.LOG_FOLDER, settings.TIME_NOW)
    cfg = TrainConfig(
        net=args.net, batch_size=args.b, lr=args.lr, epochs=args.e,
        weight_decay=args.wd, resume=args.resume, seed=args.seed,
        compute_dtype=args.dtype, checkpoint_dir=checkpoint_path, log_dir=log_dir, quiet=args.quiet,
        save_epoch=settings.SAVE_EPOCH, loader=args.loader,
        grad_accum=args.accum, remat=args.remat, dispatch_chain=args.chain,
        device=device)
    check_ported(cfg)
    if primary:
        # rank 0 alone: other ranks' clocks would name other run folders
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

    logger = SummaryLogger(log_dir) if primary else None
    try:
        _, history = run_training(cfg, train_dataset, valid_dataset,
                                  settings=settings, logger=logger)
    finally:
        if logger is not None:
            logger.close()
    return history


if __name__ == "__main__":
    main()
    sys.exit(0)
