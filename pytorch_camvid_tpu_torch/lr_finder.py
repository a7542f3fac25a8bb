"""LR range finder (counterpart of the JAX package's root lr_finder.py;
reference lr_finder.py, a fastai-style sweep):

    python -m pytorch_camvid_tpu_torch.lr_finder -net unet [-b 10]
        [-start_lr 1e-7] [-end_lr 10] [-num_it 100] [-skip_start 10]
        [-skip_end 5] [-weight_decay 0] [-smoothing reference|fastai]
        [-data data] [-image_size W H] [-dtype bfloat16] [-device cuda]

Runs up to ``-num_it`` train steps on CamVid's train split with the
geometric sweep ``exponential_sweep_lr`` and saves a log-x loss-vs-lr
curve, ``lr_finder.jpg``. The default smoothing and stop rules are the
reference's: the first recorded loss is the raw loss, later ones are
``smooth_f * loss + (1 - smooth_f) * previous`` with smooth_f 0.05, the
recorded lr is the one *after* the step (the next iteration's), and the
sweep stops only when the raw loss goes NaN (the step has then already
been applied; the run ends there). ``-smoothing fastai`` takes fastai's
bias-corrected beta 0.98 average and stops when it exceeds 4x the best.
The recipe adds rotation (p 0.5, which fires under the reference's skip
rule) and RandomScale to the training one (lr_finder.py:144-153).

The JAX CLI's flags plus ``-image_size``, ``-dtype`` (default bfloat16:
the card's kernels take bf16) and ``-device`` (default cuda, no fallback),
as the port's other CLIs. ``sweep(args)`` runs the sweep alone; ``plot``
imports matplotlib only when it draws.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from pytorch_camvid_tpu_torch.config import settings
from pytorch_camvid_tpu_torch.data.augment import (AugmentConfig,
                                                   make_train_augment)
from pytorch_camvid_tpu_torch.data.camvid import CamVid
from pytorch_camvid_tpu_torch.data.pipeline import DeviceDataLoader
from pytorch_camvid_tpu_torch.models import get_model
from pytorch_camvid_tpu_torch.train import (TrainState, adamw,
                                            exponential_sweep_lr,
                                            make_train_step)
from pytorch_camvid_tpu_torch.train.loop import DTYPES, check_device

SEED = 0   # the model's initialization (the JAX CLI's PRNGKey(0))


def recorded_lr(lr_fn, it: int) -> float:
    """The lr the reference records after iteration ``it`` (1-based): its
    scheduler has stepped, so the next iteration's (lr_finder.py:83-89)."""
    return float(lr_fn(it))


def lr_finder(loader, model, *, start_lr, end_lr, num_it, stop_div,
              weight_decay, augment_fn, smooth_f=0.05, beta=0.98,
              smoothing="reference", compute_dtype=torch.float32):
    """LR range test (lr_finder.py:17-96) from ``model``'s state, which
    the sweep trains in place. Returns (losses, lrs): ``num_it`` entries
    each unless a stop rule ended the sweep early.

    smoothing='reference' reproduces lr_finder.py:76-88: first loss raw,
    then the smooth_f blend with the previous recorded loss; stop on NaN
    only (stop_div then has no effect, like the reference where it is
    unused). smoothing='fastai': bias-corrected average (beta), stop when
    it exceeds 4x the best seen (if stop_div)."""
    opt = adamw(weight_decay=weight_decay)
    lr_fn = exponential_sweep_lr(start_lr, end_lr, num_it)
    step_fn = make_train_step(opt, lr_fn, augment_fn=augment_fn,
                              compute_dtype=compute_dtype,
                              log_grad_norms=False)
    state = TrainState.create(model, opt, seed=SEED + 1)

    losses, lrs = [], []
    avg_loss, best_loss = 0.0, None
    it = 0
    while it < num_it:
        for batch in loader.epoch(it):
            if it >= num_it:
                break
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            it += 1
            if smoothing == "reference":
                if np.isnan(loss):
                    # the NaN stop (lr_finder.py:76-78); the batch is left
                    # out of the curve like the reference's break
                    print("Stopping early, the loss has diverged")
                    return np.asarray(losses), np.asarray(lrs)
                lrs.append(recorded_lr(lr_fn, it))
                smoothed = (loss if it == 1
                            else smooth_f * loss
                            + (1 - smooth_f) * losses[-1])
                losses.append(smoothed)
                print("iteration: {}, lr: {:08f}, loss: {:04f}".format(
                    it, lrs[-1], loss))
            else:  # fastai
                lrs.append(float(metrics["lr"]))
                avg_loss = beta * avg_loss + (1 - beta) * loss
                smoothed = avg_loss / (1 - beta ** it)
                losses.append(smoothed)
                best_loss = (smoothed if best_loss is None
                             else min(best_loss, smoothed))
                print(f"iter {it}/{num_it} lr {lrs[-1]:.3e} "
                      f"loss {smoothed:.4f}")
                if stop_div and (smoothed > 4 * best_loss
                                 or np.isnan(smoothed)):
                    print("Stopping early, the loss has diverged")
                    return np.asarray(losses), np.asarray(lrs)
    return np.asarray(losses), np.asarray(lrs)


def plot(loss, lr, skip_start=10, skip_end=5, image_name="lr_finder.jpg"):
    """Loss-vs-lr log-x curve (lr_finder.py:99-114)."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    if skip_end:
        loss, lr = loss[skip_start:-skip_end], lr[skip_start:-skip_end]
    else:
        loss, lr = loss[skip_start:], lr[skip_start:]
    plt.plot(lr, loss)
    plt.xscale("log")
    plt.xlabel("Learning rate")
    plt.ylabel("Loss")
    plt.savefig(image_name)
    plt.close()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_camvid_tpu_torch.lr_finder")
    p.add_argument("-b", type=int, default=10,
                   help="batch size for dataloader")
    p.add_argument("-start_lr", type=float, default=1e-7,
                   help="initial learning rate")
    p.add_argument("-end_lr", type=float, default=10,
                   help="final learning rate")
    # the reference declares this type=bool (any string is truthy);
    # parse real booleans instead, as the JAX CLI does
    p.add_argument("-stop_div", default=True,
                   type=lambda s: s.lower() not in ("false", "0", "no"),
                   help="stops when loss diverges")
    p.add_argument("-num_it", type=int, default=100,
                   help="number of iterations")
    p.add_argument("-skip_start", type=int, default=10,
                   help="number of batches to trim from the start")
    p.add_argument("-skip_end", type=int, default=5,
                   help="number of batches to trim from the end")
    p.add_argument("-weight_decay", type=float, default=0,
                   help="weight decay factor")
    p.add_argument("-smoothing", type=str, default="reference",
                   choices=["reference", "fastai"],
                   help="loss smoothing/stop rule (reference = "
                   "lr_finder.py:76-88 parity)")
    p.add_argument("-net", type=str, required=True, help="network name")
    p.add_argument("-data", type=str, default=settings.DATA_PATH)
    p.add_argument("-image_size", type=int, nargs=2, default=None,
                   metavar=("W", "H"),
                   help="working size in cv2 (W, H) order; default "
                   "settings.IMAGE_SIZE")
    p.add_argument("-dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="compute dtype (default bfloat16, unlike the JAX "
                   "CLI's float32: the card's kernels take bf16 only)")
    p.add_argument("-device", type=str, default="cuda",
                   help="torch device (default cuda; no fallback to the "
                   "CPU)")
    return p


def sweep(args: argparse.Namespace):
    """The CLI's sweep from its parsed ``args``: CamVid's train split,
    the model from seed 0, the LR finder's recipe. Returns lr_finder's
    (losses, lrs)."""
    dev = check_device(args.device, args.dtype)
    image_size = (tuple(args.image_size) if args.image_size
                  else settings.IMAGE_SIZE)
    train = CamVid(args.data, image_set="train", image_size=image_size)
    loader = DeviceDataLoader(train.images, train.labels, args.b,
                              shuffle=True, drop_last=True, device=dev)
    # the reference lr_finder pipeline adds RandomScale
    # (lr_finder.py:144-153)
    cfg = AugmentConfig(mean=settings.MEAN, std=settings.STD,
                        rotation_p=0.5, rotation_angle=10,
                        rotation_fill=train.ignore_index, random_scale=True,
                        scale_fill=train.ignore_index)
    dtype = DTYPES[args.dtype]
    model = get_model(args.net, 3, train.class_num,
                      generator=torch.Generator().manual_seed(SEED)).to(dev)
    return lr_finder(loader, model, start_lr=args.start_lr,
                     end_lr=args.end_lr, num_it=args.num_it,
                     stop_div=args.stop_div, weight_decay=args.weight_decay,
                     augment_fn=make_train_augment(cfg, dtype),
                     smoothing=args.smoothing, compute_dtype=dtype)


def main(argv=None):
    """Run the CLI: the sweep, then the plot. Returns (losses, lrs)."""
    args = parser().parse_args(argv)
    loss, lr = sweep(args)
    plot(loss, lr, skip_start=args.skip_start, skip_end=args.skip_end)
    return loss, lr


if __name__ == "__main__":
    main()
    sys.exit(0)
