"""The legacy multi-replica trainer (counterpart of the JAX package's root
train_tpu.py; reference legacy/train_tpu.py):

    python -m pytorch_camvid_tpu_torch.train_tpu [-net unet] [-b 5]
        [-lr 0.01] [-e 150] [-warm 5] [-data data] [-dtype bfloat16]
        [-dp 0] [-device cuda]

The legacy recipe: SGD (momentum 0.9, nesterov, weight decay 1e-4), a
linear warmup over ``-warm`` epochs then MultiStepLR at
``settings.MILESTONES``, ``-b`` images per replica (the global batch is
``-b`` times the ranks), bf16 by default, in explicit mode
(``parallel/shard_map_dp.py``: each rank's mean loss, gradients and loss
averaged over the ranks, sync-BN, the confusion matrix summed). One rank a
visible card (``-dp 0``, the JAX script's every device) or ``-dp n``,
spawned as the train CLI's ``-dp`` spawns them; ``-device cpu`` runs CPU
ranks. Rank 0 prints a line per step, the epoch's time and the eval
pass's per-class IoU; nothing is saved, as in the JAX script.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from pytorch_camvid_tpu_torch.config import settings
from pytorch_camvid_tpu_torch.data.augment import (AugmentConfig,
                                                   make_train_augment)
from pytorch_camvid_tpu_torch.data.camvid import CamVid
from pytorch_camvid_tpu_torch.data.pipeline import DeviceDataLoader
from pytorch_camvid_tpu_torch.models import get_model
from pytorch_camvid_tpu_torch.parallel import (launch, make_mesh,
                                               put_global_tree,
                                               replicated_sharding,
                                               shard_map_eval_step,
                                               shard_map_train_step)
from pytorch_camvid_tpu_torch.train import (TrainState, make_eval_step,
                                            make_train_step, sgd,
                                            warmup_then_multistep)
from pytorch_camvid_tpu_torch.train.loop import (DTYPES, check_device,
                                                 eval_normalize, evaluate,
                                                 print_epoch_metrics)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_camvid_tpu_torch.train_tpu")
    p.add_argument("-b", type=int, default=5,
                   help="batch size for dataloader (per replica)")
    p.add_argument("-lr", type=float, default=0.01,
                   help="initial learning rate")
    p.add_argument("-e", type=int, default=150, help="training epoches")
    p.add_argument("-warm", type=int, default=5, help="warm up phase")
    p.add_argument("-net", type=str, default="unet")
    p.add_argument("-data", type=str, default=settings.DATA_PATH)
    p.add_argument("-dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("-image_size", type=int, nargs=2, default=None,
                   metavar=("W", "H"),
                   help="working size in cv2 (W, H) order; default "
                   "settings.IMAGE_SIZE = (480, 360)")
    p.add_argument("-dp", type=int, default=0,
                   help="replicas, one card each (0 = every visible card)")
    p.add_argument("-device", type=str, default="cuda",
                   help="torch device the ranks use (default cuda; no "
                   "fallback to the CPU)")
    return p


def main(argv=None):
    """Run the trainer; returns rank 0's per-epoch history (epoch, miou,
    loss: the eval pass's, train_s)."""
    args = parser().parse_args(argv)
    check_device(args.device, args.dtype)
    n = launch.rank_count(args.dp, args.device)
    if n > 1:
        return launch.spawn(rank_main, n, argv,
                            devices=launch.local_devices(n, args.device))[0]
    return rank_main(make_mesh(1, device=args.device), argv)


def rank_main(mesh, argv):
    """One replica's run on ``mesh.device``."""
    args = parser().parse_args(argv)
    dtype = DTYPES[args.dtype]
    dev = mesh.device
    primary = mesh.is_primary()
    ndev = mesh.world
    global_batch = args.b * ndev   # legacy: batches round-robin the cores
    image_size = (tuple(args.image_size) if args.image_size
                  else settings.IMAGE_SIZE)
    if primary:
        print(f"{ndev} replicas on {dev.type}")

    train_ds = CamVid(args.data, image_set="train", image_size=image_size)
    val_ds = CamVid(args.data, image_set="val", image_size=image_size)
    train_loader = DeviceDataLoader(train_ds.images, train_ds.labels,
                                    global_batch, shuffle=True,
                                    drop_last=True, device=dev, mesh=mesh)
    val_loader = DeviceDataLoader(val_ds.images, val_ds.labels,
                                  global_batch, device=dev, mesh=mesh,
                                  pad_to_batch=ndev > 1)
    iter_per_epoch = len(train_loader)
    if iter_per_epoch == 0:
        raise ValueError(f"global batch {global_batch} exceeds the train "
                         f"split ({train_ds.images.shape[0]} images)")
    schedule = warmup_then_multistep(args.lr, iter_per_epoch * args.warm,
                                     settings.MILESTONES, iter_per_epoch)

    model = get_model(args.net, 3, train_ds.class_num,
                      generator=torch.Generator().manual_seed(0)).to(dev)
    opt = sgd(momentum=0.9, nesterov=True, weight_decay=1e-4)
    state = put_global_tree(TrainState.create(model, opt),
                            replicated_sharding(mesh))
    aug = make_train_augment(
        AugmentConfig(mean=settings.MEAN, std=settings.STD,
                      rotation_fill=train_ds.ignore_index,
                      scale_fill=train_ds.ignore_index),
        compute_dtype=dtype)
    train_step = shard_map_train_step(make_train_step(
        opt, schedule, augment_fn=aug, compute_dtype=dtype,
        log_grad_norms=False), mesh)
    eval_step = shard_map_eval_step(make_eval_step(
        train_ds.class_num, ignore_index=train_ds.ignore_index,
        loss_ignore_index=255, compute_dtype=dtype), mesh)
    normalize = eval_normalize(settings.MEAN, settings.STD, dtype, dev)

    history = []
    for epoch in range(1, args.e + 1):
        if primary:
            print(f"training epoch {epoch}")
        t1 = time.perf_counter()
        for images, masks in train_loader.epoch(epoch - 1):
            state, metrics = train_step(state, (images, masks))
            loss = float(metrics["loss"])
            if primary:
                print(f"Epoch: {epoch}, devices: {ndev}, loss: {loss:0.4f},"
                      f" lr: {float(metrics['lr']):0.6f}")
        train_s = time.perf_counter() - t1
        if primary:
            print(train_s)
        loss_sum, cm, n_batches = evaluate(state, eval_step, val_loader,
                                           normalize)
        miou, _ = print_epoch_metrics(cm, train_ds.class_names,
                                      train_ds.ignore_index,
                                      quiet=not primary)
        history.append({"epoch": epoch, "miou": miou,
                        "loss": loss_sum / max(n_batches, 1),
                        "train_s": train_s})
    return history


if __name__ == "__main__":
    main()
    sys.exit(0)
