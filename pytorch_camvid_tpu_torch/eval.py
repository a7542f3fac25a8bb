"""Eval CLI (counterpart of the JAX package's root eval.py; reference
eval.py):

    python -m pytorch_camvid_tpu_torch.eval -weight <ckpt> [-net unet]
        [-b 10] [-data data] [-image_size W H] [-dtype bfloat16]
        [-dataset camvid|voc2012] [-device cuda]

Loads a checkpoint (a reference ``.pth``, or a ``.ckpt.npz`` of either
package), runs the validation split and prints the JAX CLI's lines: the
per-class IoU, then ``miou``, ``precision``, ``recall`` and ``loss`` from
the eval pass's confusion matrix (``train/loop.py::evaluate``, the loop's
own). The model's width follows the checkpoint.

As the train CLI: ``-device`` defaults to ``cuda`` and fails without one;
``-dtype`` defaults to ``bfloat16`` (the JAX CLI's default is
``float32``), and ``-dtype float32`` on a CUDA device is refused. On CUDA
every conv block runs the fused kernel (K4), so ``-pallas`` (the JAX CLI's
switch to its fused kernels) changes nothing here. ``-dataset voc2012``
evaluates the VOC val cache with VOC's mean and std (eval.py:61-65).
``-int8`` raises ``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from pytorch_camvid_tpu_torch.config import settings
from pytorch_camvid_tpu_torch.data.camvid import CamVid
from pytorch_camvid_tpu_torch.data.pipeline import DeviceDataLoader
from pytorch_camvid_tpu_torch.data.voc2012 import VOC2012Aug
from pytorch_camvid_tpu_torch.models import get_model, spec_from_state_dict
from pytorch_camvid_tpu_torch.ops.metrics import (
    iou_from_confusion, precision_recall_from_confusion)
from pytorch_camvid_tpu_torch.train import TrainState, make_eval_step
from pytorch_camvid_tpu_torch.train.checkpoint import load_weights
from pytorch_camvid_tpu_torch.train.loop import (DTYPES, check_device,
                                                 eval_normalize, evaluate,
                                                 not_ported)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_camvid_tpu_torch.eval")
    p.add_argument("-weight", type=str, required=True,
                   help="weight file path (.pth or .ckpt.npz)")
    p.add_argument("-b", type=int, default=10,
                   help="batch size for dataloader")
    p.add_argument("-net", type=str, default="unet", help="network name")
    p.add_argument("-data", type=str, default=settings.DATA_PATH,
                   help="dataset root folder")
    p.add_argument("-pallas", action="store_true", default=False,
                   help="the JAX CLI's fused-kernel switch; on CUDA the "
                   "port always runs its fused kernel")
    p.add_argument("-int8", action="store_true", default=False,
                   help="post-training int8 quantization (not ported yet)")
    p.add_argument("-image_size", type=int, nargs=2, default=None,
                   metavar=("W", "H"),
                   help="working size in cv2 (W, H) order; default "
                   "settings.IMAGE_SIZE")
    p.add_argument("-dataset", type=str, default="camvid",
                   choices=["camvid", "voc2012"],
                   help="dataset to evaluate on")
    p.add_argument("-dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="compute dtype (default bfloat16, unlike the JAX "
                   "CLI's float32: the card's kernels take bf16 only, and "
                   "float32 runs on -device cpu only)")
    p.add_argument("-device", type=str, default="cuda",
                   help="torch device the model runs on (default cuda; no "
                   "fallback to the CPU)")
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns the printed figures (miou, precision, recall,
    loss)."""
    args = parser().parse_args(argv)
    dev = check_device(args.device, args.dtype)
    if args.int8:
        raise not_ported("-int8", "int8")
    dtype = DTYPES[args.dtype]
    image_size = (tuple(args.image_size) if args.image_size
                  else settings.IMAGE_SIZE)
    mean, std = settings.MEAN, settings.STD
    if args.dataset == "voc2012":
        valid_dataset = VOC2012Aug(args.data, image_set="val",
                                   image_size=image_size)
        mean, std = settings.VOC_MEAN, settings.VOC_STD
    else:
        valid_dataset = CamVid(args.data, image_set="val",
                               image_size=image_size)

    state_dict = load_weights(args.weight, args.net)
    model = get_model(args.net, spec=spec_from_state_dict(args.net,
                                                          state_dict))
    model.load_state_dict(state_dict, strict=True)
    state = TrainState(model=model.to(dev), opt_state={}, step=0,
                       generator=torch.Generator())
    eval_fn = make_eval_step(valid_dataset.class_num,
                             ignore_index=valid_dataset.ignore_index,
                             loss_ignore_index=255, compute_dtype=dtype)
    loader = DeviceDataLoader(valid_dataset.images, valid_dataset.labels,
                              args.b, device=dev)
    loss_sum, cm, n_batches = evaluate(
        state, eval_fn, loader,
        eval_normalize(mean, std, dtype, dev))

    cmt = torch.from_numpy(cm)
    iou = iou_from_confusion(cmt).numpy()
    precision, recall = (a.numpy() for a in
                         precision_recall_from_confusion(cmt))
    ig = valid_dataset.ignore_index
    keep = [i for i in range(valid_dataset.class_num) if i != ig]
    out = {"miou": float(np.nanmean(iou[keep])),
           "precision": float(np.nanmean(precision[keep])),
           "recall": float(np.nanmean(recall[keep])),
           "loss": loss_sum / max(n_batches, 1)}
    print("Iou for each class:")
    print(", ".join(f"{n}:{v:.4f}" for n, v in
                    zip(valid_dataset.class_names, iou)))
    for k, v in out.items():
        # the loss per batch, like the reference (eval.py:68)
        print(f"{k}: {v:.4f}")
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
