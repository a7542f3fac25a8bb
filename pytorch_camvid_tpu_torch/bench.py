"""Training throughput on one CUDA card (counterpart of bench.py's
``measure_train`` and the conv FLOP count it uses, bench.py:61-182).

The measured step: the uint8 batch gathered on the device from resident
synthetic data (``DeviceDataLoader``), the reference augmentation, the
train-mode forward (K1 on every conv3x3; SegNet's pools on K2), the
cross-entropy, the backward, OneCycle lr and beta1, AdamW; bf16 compute,
360x480 (bench.py's headlines: UNet at batch 24, SegNet at batch 32). Step
time comes from CUDA events around ``steps`` steps after ``warmup`` steps.

MFU counts the timed model's useful FLOPs (its conv blocks' forward, x3 for
training) against the card's dense bf16 peak; it leaves out augmentation,
BN, pools, the loss and the optimizer, so it understates the card's work.

Also the port's one copy of the card's peaks, of the card's name and
power limit, and of device-busy time in a torch.profiler trace, which
``chip_smoke.py``, ``profile.py`` and ``perf_probe.py`` share.
"""

from __future__ import annotations

import functools
import subprocess
from typing import List, Tuple

import numpy as np
import torch

from pytorch_camvid_tpu_torch.config import settings
from pytorch_camvid_tpu_torch.data.augment import (AugmentConfig,
                                                   make_train_augment)
from pytorch_camvid_tpu_torch.data.pipeline import DeviceDataLoader
from pytorch_camvid_tpu_torch.data.synthetic import synthetic_arrays
from pytorch_camvid_tpu_torch.models import get_model, model_class
from pytorch_camvid_tpu_torch.train import (TrainState, adamw,
                                            make_train_step, onecycle_beta1,
                                            onecycle_lr)

# dense bf16 tensor-core peak (FLOP/s) and memory rate (bytes/s) of an
# H100 SXM at its full power limit (NVIDIA data sheet); MFU is left out on
# other cards
H100_BF16_PEAK = 989e12
H100_HBM_RATE = 3.35e12
H100_F32_PEAK = 67e12   # f32 FLOP/s outside the tensor cores
MAX_LR = 5e-4  # OneCycle's peak lr, as the JAX bench (bench.py:134)


@functools.cache
def card(index: int = 0) -> str:
    """Card ``index``'s name and power limit, as nvidia-smi's
    ``--query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[index]


def device_spans(prof) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of every kernel, memset and copy in a
    torch.profiler trace."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def busy_ms(spans) -> float:
    """Device-busy milliseconds: the union of (start, end) microsecond
    spans, so kernels that overlap (cuDNN's Hopper wgrad runs several at
    once) count once."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def block_shapes(net: str = "unet", hw: Tuple[int, int] = (360, 480),
                 spec=None):
    """(H, W, Cin, Cout) of each conv block of one forward at ``hw``, in
    spec order (``spec``: the model's, default the full-width one)."""
    cls = model_class(net)
    spec = spec or cls.base_spec(3, 12)
    pairs = [p for _, stage in spec for p in stage]
    return [size + p for size, p in zip(cls.block_sizes(hw), pairs)]


def conv_fwd_flops(net: str = "unet", hw: Tuple[int, int] = (360, 480),
                   spec=None) -> float:
    """A model's forward conv FLOPs per image: 2*9*cin*cout*h*w per block
    at its actual size (pools floor; UNet's upsample doubles before the
    pad, SegNet's unpool restores the pre-pool size)."""
    return sum(2.0 * 9.0 * h * w * ci * co
               for h, w, ci, co in block_shapes(net, hw, spec))


def he_model(net: str, generator: torch.Generator) -> torch.nn.Module:
    """Full-width model with He-scaled conv weights (std sqrt(2/fan_in)),
    zero conv biases and identity BN stats, so activations stay O(1)
    through 23-26 blocks (the torch-default init shrinks their second
    moment about sixfold per block). The weights chip_smoke.py and
    ``profile.py`` run."""
    model = get_model(net, 3, 12, generator=generator)
    with torch.no_grad():
        for blk in model.blocks():
            conv, _ = blk.conv_bn()
            conv.weight.normal_(0.0, (2.0 / conv.weight[0].numel()) ** 0.5,
                                generator=generator)
            conv.bias.zero_()
    return model


def resident_batch(batch_size: int, hw: Tuple[int, int], seed: int,
                   device: torch.device):
    """One (uint8 images, labels) batch gathered on ``device`` from
    resident synthetic data: the first batch ``measure_train`` would
    take."""
    images, labels = synthetic_arrays(max(4 * batch_size, 64), hw=hw,
                                      seed=seed)
    loader = DeviceDataLoader(images, labels, batch_size, shuffle=True,
                              seed=seed, drop_last=True, device=device)
    return loader.gather(loader.epoch_indices(0)[0])


def make_bench_step(total_steps: int, plain: bool = False):
    """bench.py's step: default augmentation (reference recipe with the
    CamVid mean/std), OneCycle lr/beta1, AdamW (wd 0), bf16 compute.
    Returns (optimizer, step_fn)."""
    cfg = AugmentConfig(mean=settings.MEAN, std=settings.STD)
    opt = adamw(weight_decay=0.0)
    step = make_train_step(opt, onecycle_lr(MAX_LR, total_steps),
                           onecycle_beta1(total_steps),
                           augment_fn=make_train_augment(cfg, torch.bfloat16),
                           compute_dtype=torch.bfloat16,
                           log_grad_norms=False, plain=plain)
    return opt, step


def measure_train(model, batch_size: int = 24, steps: int = 20,
                  warmup: int = 3, hw: Tuple[int, int] = (360, 480),
                  plain: bool = False, seed: int = 0) -> dict:
    """Time ``steps`` train steps of ``model`` (on a CUDA device) after
    ``warmup``. Returns img/s, step ms, MFU, the losses and the peak
    device memory of the run."""
    dev = next(model.parameters()).device
    if dev.type != "cuda":
        raise RuntimeError("measure_train times a CUDA device")
    n_data = max(4 * batch_size, 64)
    images, labels = synthetic_arrays(n_data, hw=hw, seed=seed)
    loader = DeviceDataLoader(images, labels, batch_size, shuffle=True,
                              seed=seed, drop_last=True, device=dev)
    total = steps + warmup + 1
    opt, step = make_bench_step(total, plain)
    state = TrainState.create(model, opt, seed=seed)

    def batches():
        e = 0
        while True:
            for idx in loader.epoch_indices(e):
                yield loader.gather(idx)
            e += 1

    it = batches()
    torch.cuda.reset_peak_memory_stats(dev)
    losses = []
    for _ in range(warmup):
        state, m = step(state, next(it))
        losses.append(m["loss"])
    torch.cuda.synchronize(dev)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(steps):
        state, m = step(state, next(it))
        losses.append(m["loss"])
    e1.record()
    torch.cuda.synchronize(dev)
    ms = e0.elapsed_time(e1) / steps
    losses = [float(v) for v in losses]
    ips = batch_size * 1000.0 / ms
    flops = 3.0 * conv_fwd_flops(model.net, hw, model.spec)
    h100 = "H100" in torch.cuda.get_device_name(dev)
    return {
        "images_per_sec": ips,
        "step_ms": ms,
        "mfu": ips * flops / H100_BF16_PEAK if h100 else None,
        "batch_size": batch_size,
        "train_tflop_per_image": flops / 1e12,
        "losses": losses,
        "finite": bool(np.all(np.isfinite(losses))),
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
    }
