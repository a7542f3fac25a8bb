"""Library-level training and evaluation loops (counterpart of
pytorch_camvid_tpu/train/loop.py; reference train.py:116-240).

The JAX package's console, TB and checkpoint surface, on one device:

- per-batch 'Training Epoch:{e} [{seen}/{total}] Lr:… Loss:… Beta1:…'
  (train.py:136-144), printed one dispatch behind the device: step t is
  queued before step t-1's metrics are read. Each dispatch's metrics go to
  the host in one stacked copy (into pinned memory, fenced by an event, on
  CUDA), so reading them waits for that dispatch and not for the one
  queued after it;
- ``dispatch_chain`` k: k steps are queued back to back and their metrics
  cross in one copy. Eager PyTorch queues steps asynchronously anyway, so
  this is the JAX package's ``lax.scan`` chain without a compiled program;
  the steps and their numerics are those of k = 1;
- per-epoch per-class IoU/acc and 'Mean_iou'/'All_acc' (train.py:200-209)
  from the epoch's confusion matrix; TB scalars Train/LearningRate,
  Train/Beta1, Test/mIOU, Test/Acc, Test/Loss, last-layer grad norms and
  parameter histograms;
- best/regular checkpoints with the SAVE_EPOCH cadence and its quirk (a
  best save skips the regular one, train.py:232-240); the best IoU is never
  reset; a SIGTERM (or ``stop_after_batches``) mid-epoch saves
  ``<epoch>-preempt`` with the first batch not applied, and ``resume``
  restarts there step-exactly (the loader's permutation depends only on
  seed and epoch; the generator's state is in the checkpoint);
- the NaN guard raises ``FloatingPointError``; the SIGTERM handler is
  restored on every exit.

Eval runs a ragged last batch as it is: eval-mode BN uses the running
stats, so its loss and confusion matrix equal the JAX package's, which pads
the batch with ignored 255 labels to keep one compiled shape.

``loader='host'`` streams the batches from host memory
(``data/pipeline.py::HostLoader``): the loop names each next batch one
step ahead (``prefetch``), so its gather and copy overlap the current
step; the default ``'device'`` keeps the split on the device. Options
whose parts are not ported raise ``NotImplementedError`` naming their
ROADMAP.md item: ``data_parallel > 1``. ``remat`` recomputes each model
stage in the backward (``train/steps.py``). Both compute dtypes run
on the card: bfloat16 on the bf16 conv kernels, float32 (the default, the
JAX package's reference numerics) on the split-TF32 f32 kernels
(``csrc/conv3x3_f32.cu``).
"""

from __future__ import annotations

import os
import signal
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from pytorch_camvid_tpu_torch.config import settings as default_settings
from pytorch_camvid_tpu_torch.data.augment import (AugmentConfig,
                                                   make_train_augment)
from pytorch_camvid_tpu_torch.data.normalize import to_tensor_normalize
from pytorch_camvid_tpu_torch.data.pipeline import (DeviceDataLoader,
                                                    HostLoader)
from pytorch_camvid_tpu_torch.interop.weights import load_torch_checkpoint
from pytorch_camvid_tpu_torch.models import get_model
from pytorch_camvid_tpu_torch.ops.metrics import (accuracy_from_confusion,
                                                  iou_from_confusion)
from pytorch_camvid_tpu_torch.train import (TrainState, adamw,
                                            make_eval_step, make_train_step,
                                            onecycle_beta1, onecycle_lr)
from pytorch_camvid_tpu_torch.train.checkpoint import (
    checkpoint_name, get_weight_path, load_checkpoint, parse_epoch,
    save_checkpoint)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class TrainConfig:
    net: str = "unet"
    batch_size: int = 10          # train.py:22 default
    lr: float = 5e-4              # train.py:24
    epochs: int = 120             # train.py:26
    weight_decay: float = 0.0     # train.py:27
    resume: bool = False
    seed: int = 0
    compute_dtype: str = "float32"
    data_parallel: int = 0        # 0 and 1: this device
    checkpoint_dir: Optional[str] = None
    log_dir: Optional[str] = None
    class_weights: Optional[Sequence[float]] = None
    loss_ignore_index: Optional[int] = None  # reference default: None
    quiet: bool = False
    save_epoch: int = 10
    loader: str = "device"
    # microbatches per step, each with its own BN statistics
    grad_accum: int = 1
    remat: bool = False
    # stop with a clear error when the loss goes NaN/Inf
    nan_guard: bool = True
    # act as if SIGTERM arrived after exactly this many applied batches:
    # deterministic preemption for smoke runs and for testing the
    # mid-epoch resume (None = only a real SIGTERM stops)
    stop_after_batches: Optional[int] = None
    # train steps queued per metrics copy to the host
    dispatch_chain: int = 8
    # where the run lives: "cuda" (default) or "cpu"; no fallback
    device: str = "cuda"


def not_ported(what: str, item: str):
    """The error of an option whose part is not ported yet."""
    return NotImplementedError(
        f"{what} is not ported to pytorch_camvid_tpu_torch yet "
        f"(ROADMAP.md Queue 1: {item})")


def check_device(device: str, compute_dtype: str) -> torch.device:
    """The device an entry point runs on, for either compute dtype: a CUDA
    device (its kernels) must be there; the CPU runs the plain versions of
    the kernels. Nothing falls back to the CPU."""
    dev = torch.device(device)
    if compute_dtype not in DTYPES:
        raise ValueError(f"unknown compute dtype {compute_dtype!r}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is "
                f"available; pass -device cpu to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def check_ported(cfg: TrainConfig) -> None:
    if cfg.data_parallel > 1:
        raise not_ported(f"data_parallel={cfg.data_parallel}", "multi-GPU")
    if cfg.loader not in ("device", "host"):
        raise ValueError(f"unknown loader {cfg.loader!r}")


def eval_normalize(mean, std, dtype: torch.dtype, device: torch.device):
    """images_u8 -> normalized ``dtype`` (make_eval_normalize), with the
    mean and std on the device once."""
    m, s = (torch.tensor(v, dtype=torch.float32, device=device)
            for v in (mean, std))
    return lambda images: to_tensor_normalize(images, m, s, dtype)


def evaluate(state: TrainState, eval_fn, loader: DeviceDataLoader,
             normalize):
    """The eval pass: returns (batch_loss_sum, confusion matrix float64,
    n_batches). The reference reports the loss as the per-batch-mean sum
    over the number of batches (eval.py:68); callers divide. The loss sum
    and the int64 matrix accumulate on the device and cross to the host
    once."""
    loss_sum = cm_sum = None
    n_batches = 0
    for images, labels in loader.epoch(0):
        loss, cm = eval_fn(state, (normalize(images), labels))
        cm = cm.long()
        loss_sum = loss if loss_sum is None else loss_sum + loss
        cm_sum = cm if cm_sum is None else cm_sum + cm
        n_batches += 1
    if n_batches == 0:
        return 0.0, None, 0
    return (float(loss_sum), cm_sum.cpu().numpy().astype(np.float64),
            n_batches)


def print_epoch_metrics(cm: np.ndarray, class_names: Sequence[str],
                        ignore_index: int, quiet=False):
    """Per-class IoU/acc + mean IoU / all-acc (train.py:200-209 surface,
    correctly normalized). Returns (miou, all_acc)."""
    cmt = torch.from_numpy(np.asarray(cm, np.float64))
    iou = iou_from_confusion(cmt).numpy()
    all_acc, acc = accuracy_from_confusion(cmt)
    all_acc, acc = float(all_acc), acc.numpy()
    keep = [i for i in range(len(class_names)) if i != ignore_index]
    miou = float(np.nanmean(iou[keep]))
    if not quiet:
        print("Iou for each class:")
        print(", ".join(f"{n}:{i:.4f}" for n, i in zip(class_names, iou)))
        print(f"Mean_iou {miou:.4f}")
        print("Acc for each class:")
        print(", ".join(f"{n}:{a:.4f}" for n, a in zip(class_names, acc)))
        print(f"All_acc {all_acc:.4f}")
    return miou, all_acc


class _Dispatch:
    """The metrics of k queued steps on their way to the host: the device
    scalars stacked and copied in one transfer (pinned and fenced by an
    event on CUDA), the host scalars (lr, beta1) kept as they are."""

    def __init__(self, b0: int, ms: list):
        self.b0, self.k = b0, len(ms)
        self.dev_keys = [k for k, v in ms[0].items()
                         if isinstance(v, torch.Tensor)]
        self.host = [{k: v for k, v in m.items() if k not in self.dev_keys}
                     for m in ms]
        stacked = torch.stack([torch.stack([m[k].float() for m in ms])
                               for k in self.dev_keys])
        self.event = None
        if stacked.device.type == "cuda":
            self.vals = torch.empty(stacked.shape, pin_memory=True)
            self.vals.copy_(stacked, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.vals = stacked

    def metrics(self) -> list:
        """One dict of floats per step, in order; waits for this dispatch
        only."""
        if self.event is not None:
            self.event.synchronize()
        vals = self.vals.numpy()
        return [dict(self.host[j], **{k: float(vals[i, j]) for i, k in
                                      enumerate(self.dev_keys)})
                for j in range(self.k)]


def run_training(cfg: TrainConfig, train_ds, val_ds,
                 settings=default_settings, logger=None):
    """Full training run (reference train.py:116-240). train_ds/val_ds
    expose .images/.labels (packed uint8), .class_num, .ignore_index,
    .class_names. Returns (state, history): one dict per epoch trained in
    this run (epoch, miou, all_acc, and the wall seconds of its training
    and of its eval pass, train_s and eval_s)."""
    dev = check_device(cfg.device, cfg.compute_dtype)
    check_ported(cfg)
    dtype = DTYPES[cfg.compute_dtype]
    quiet = cfg.quiet

    model = get_model(cfg.net, 3, train_ds.class_num,
                      generator=torch.Generator().manual_seed(cfg.seed))
    model = model.to(dev)
    opt = adamw(weight_decay=cfg.weight_decay)
    state = TrainState.create(model, opt, seed=cfg.seed + 1)

    loader_cls = HostLoader if cfg.loader == "host" else DeviceDataLoader
    train_loader = loader_cls(train_ds.images, train_ds.labels,
                              cfg.batch_size, shuffle=True, seed=cfg.seed,
                              drop_last=True, device=dev)
    val_loader = loader_cls(val_ds.images, val_ds.labels, cfg.batch_size,
                            device=dev)
    steps_per_epoch = len(train_loader)
    if steps_per_epoch == 0:
        raise ValueError(
            f"batch size {cfg.batch_size} exceeds the train split "
            f"({train_ds.images.shape[0]} images) — no full batch to train "
            "on (training drops the last partial batch)")
    total_steps = steps_per_epoch * cfg.epochs

    aug_cfg = AugmentConfig(mean=settings.MEAN, std=settings.STD,
                            rotation_fill=train_ds.ignore_index,
                            scale_fill=train_ds.ignore_index)
    augment = make_train_augment(aug_cfg, compute_dtype=dtype)
    normalize = eval_normalize(settings.MEAN, settings.STD, dtype, dev)

    cw = (torch.tensor(cfg.class_weights, dtype=torch.float32, device=dev)
          if cfg.class_weights is not None else None)
    loss_ignore = cfg.loss_ignore_index
    if loss_ignore is None and train_ds.ignore_index is not None \
            and train_ds.ignore_index >= train_ds.class_num:
        # out-of-range ignore labels (VOC's 255) must stay out of the loss;
        # CamVid's in-range Void (11) is trained like the reference
        loss_ignore = train_ds.ignore_index
    train_step = make_train_step(opt, onecycle_lr(cfg.lr, total_steps),
                                 onecycle_beta1(total_steps),
                                 class_weights=cw, ignore_index=loss_ignore,
                                 augment_fn=augment, compute_dtype=dtype,
                                 grad_accum=cfg.grad_accum, remat=cfg.remat)
    # the eval loss drops the pad sentinel 255 and whatever the training
    # loss ignores, so Test/Loss measures the same objective as JAX's
    eval_loss_ignore = {255} | ({loss_ignore} if loss_ignore is not None
                                else set())
    eval_step = make_eval_step(train_ds.class_num,
                               ignore_index=train_ds.ignore_index,
                               class_weights=cw,
                               loss_ignore_index=tuple(eval_loss_ignore),
                               compute_dtype=dtype)

    if logger is not None and cfg.log_dir:
        from pytorch_camvid_tpu_torch.utils.summary import visualize_network
        visualize_network(logger, model, cfg.net)

    trained_epochs = 0
    resume_epoch = 0      # epoch a preemption interrupted (0 = none)
    resume_skip = 0       # batches of that epoch already applied
    if cfg.resume and cfg.checkpoint_dir:
        weight_path = get_weight_path(os.path.dirname(cfg.checkpoint_dir))
        if weight_path:
            print(f"Loading weight file: {weight_path}...")
            if weight_path.endswith(".pth"):
                # reference torch checkpoint: weights and BN only; the
                # schedule fast-forwards like train.py:114
                model.load_state_dict(load_torch_checkpoint(weight_path),
                                      strict=True)
                trained_epochs = parse_epoch(weight_path)
                state.step = trained_epochs * steps_per_epoch
            else:
                state, meta = load_checkpoint(weight_path, state)
                trained_epochs = meta.get("epoch", parse_epoch(weight_path))
                resume_epoch = meta.get("preempted_in_epoch", 0)
                resume_skip = meta.get("resume_batch_idx", 0)
            print("Done loading!")

    ckpt_dir = cfg.checkpoint_dir
    best_iou = 0.0  # never reset (fixes SURVEY.md §2.5.4)
    history = []
    n_train = train_ds.images.shape[0]

    stop = {"flag": False}
    prev_handler = None
    try:
        prev_handler = signal.signal(
            signal.SIGTERM, lambda *_: stop.update(flag=True))
    except ValueError:
        pass  # not the main thread (e.g. under a test runner)

    # quiet runs with no logger and one step per dispatch read metrics
    # every 16 steps, like the JAX package's
    sync_every = 16 if (cfg.quiet and logger is None) else 1
    chain = max(cfg.dispatch_chain, 1)

    applied = 0  # batches applied in this run (drives stop_after_batches)
    try:
        for epoch in range(trained_epochs + 1, cfg.epochs + 1):
            start = time.perf_counter()
            pending = None  # the dispatch whose metrics are read next
            last = None

            def emit(b_idx, m):
                loss = m["loss"]
                if cfg.nan_guard and not np.isfinite(loss):
                    raise FloatingPointError(
                        f"loss diverged to {loss} at epoch {epoch} step "
                        f"{b_idx} — lower the lr or inspect the data (NaN "
                        "guard; disable with nan_guard=False)")
                if not quiet:
                    print("Training Epoch:{epoch} [{seen}/{total}] "
                          "Lr:{lr:0.6f} Loss:{loss:0.4f} Beta1:{beta:0.4f}"
                          .format(epoch=epoch,
                                  seen=(b_idx + 1) * cfg.batch_size,
                                  total=n_train, lr=float(m["lr"]),
                                  loss=loss, beta=float(m["beta1"])))
                if logger is not None:
                    n_iter = (epoch - 1) * steps_per_epoch + b_idx + 1
                    logger.last_layer_grad_norms(m, n_iter)

            def report(d: _Dispatch):
                ms = d.metrics()
                for j, m in enumerate(ms):
                    emit(d.b0 + j, m)
                return ms[-1]

            def preempt_save(next_batch_idx):
                if ckpt_dir:
                    save_checkpoint(
                        checkpoint_name(ckpt_dir, epoch - 1, "preempt"),
                        state, {"epoch": epoch - 1, "net": cfg.net,
                                "preempted_in_epoch": epoch,
                                "resume_batch_idx": next_batch_idx})
                    print(f"SIGTERM: saved preemption checkpoint "
                          f"{epoch - 1}-preempt (next batch "
                          f"{next_batch_idx}); resume with -resume")

            skip = resume_skip if epoch == resume_epoch else 0
            idx_all = train_loader.epoch_indices(epoch - 1)
            pos = skip
            while pos < len(idx_all):
                if stop["flag"]:
                    preempt_save(pos)
                    return state, history
                kk = min(chain, len(idx_all) - pos)
                if cfg.stop_after_batches is not None:
                    # never overshoot a deterministic stop point
                    kk = min(kk, max(cfg.stop_after_batches - applied, 1))
                ms = []
                for t in range(pos, pos + kk):
                    state, m = train_step(state,
                                          train_loader.gather(idx_all[t]))
                    ms.append(m)
                    if t + 1 < len(idx_all):
                        # queued behind step t: the host loader's gather
                        # and copy of batch t + 1 overlap it
                        train_loader.prefetch(idx_all[t + 1])
                applied += kk
                if cfg.stop_after_batches is not None \
                        and applied >= cfg.stop_after_batches:
                    stop["flag"] = True
                if pending is not None and (chain > 1 or sync_every == 1
                                            or pending.b0 % sync_every == 0):
                    # the next dispatch is queued: reading this one's
                    # metrics overlaps with it
                    last = report(pending)
                pending = _Dispatch(pos, ms)
                pos += kk
            if pending is not None:
                last = report(pending)
            if logger is not None and last is not None:
                logger.scalar("Train/LearningRate", last["lr"], epoch)
                logger.scalar("Train/Beta1", last["beta1"], epoch)
                logger.param_histograms(model.named_parameters(), epoch)
            train_s = time.perf_counter() - start
            if not quiet:
                print(f"time for training epoch {epoch} : {train_s:.2f}s")

            test_start = time.perf_counter()
            loss_sum, cm, n_batches = evaluate(state, eval_step, val_loader,
                                               normalize)
            eval_s = time.perf_counter() - test_start
            if not quiet:
                print(f"Evaluation time comsumed:{eval_s:.2f}s")
            miou, all_acc = print_epoch_metrics(
                cm, train_ds.class_names, train_ds.ignore_index, quiet)
            if logger is not None:
                logger.scalar("Test/mIOU", miou, epoch)
                logger.scalar("Test/Acc", all_acc, epoch)
                # per-batch normalization like the reference (eval.py:68)
                logger.scalar("Test/Loss", loss_sum / max(n_batches, 1),
                              epoch)
            history.append({"epoch": epoch, "miou": miou,
                            "all_acc": all_acc, "train_s": train_s,
                            "eval_s": eval_s})

            if ckpt_dir:
                meta = {"epoch": epoch, "miou": miou, "net": cfg.net}
                if best_iou < miou and epoch > cfg.epochs // 2:
                    best_iou = miou
                    save_checkpoint(
                        checkpoint_name(ckpt_dir, epoch, "best"), state,
                        meta)
                    continue  # same cadence quirk as train.py:232-240
                if not epoch % cfg.save_epoch:
                    save_checkpoint(
                        checkpoint_name(ckpt_dir, epoch, "regular"), state,
                        meta)
    finally:
        # restored on every exit, the NaN guard's too, so a stale handler
        # never swallows a later SIGTERM
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
    return state, history
