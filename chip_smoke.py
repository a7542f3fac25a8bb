"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):
1. device: needs CUDA; prints torch's version and the card's name and
   power limit (nvidia-smi).
2. build: compiles the fused conv3x3+BN+ReLU kernel from csrc/ with nvcc.
3. kernel vs plain: the kernel against its plain PyTorch version in bf16 at
   every distinct conv block shape of UNet at 360x480, batch 8: error and
   both times (CUDA events).
4. slice: a full-width UNet (random He-scaled weights from a seed) saved as
   a reference-named .pth, loaded by ``Predictor.from_checkpoint`` and
   serving three requests (8 images, 13 images, 8 images at 480x640 that
   are resized on the device). Checks the class maps, that every forward
   launched the kernel once per conv block, the logits of the kernel path
   against the plain path, and measures serving throughput.

The last line is {"ok": true, "device": {...}}; the line before it names
the card and its power limit; the line before that is the per-kernel JSON.
Imports neither jax nor cv2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_camvid_tpu_torch.config import settings
from pytorch_camvid_tpu_torch.data.normalize import to_tensor_normalize
from pytorch_camvid_tpu_torch.models import get_model
from pytorch_camvid_tpu_torch.models.unet import unet_spec
from pytorch_camvid_tpu_torch.ops import fused_conv
from pytorch_camvid_tpu_torch.serving import Predictor

KERNEL_TOL = 2e-2   # max|kernel - plain| / max|plain|, one bf16 block
LOGITS_TOL = 5e-2   # max|kernel - plain| / max|plain| logits, 23 blocks
BATCH, HW = 8, (360, 480)
SEED = 0


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def block_shapes(h: int, w: int):
    """(H, W, Cin, Cout) of UNet's 23 conv blocks in forward order."""
    out, sizes = [], [(h, w)]
    for _ in range(4):
        sizes.append((sizes[-1][0] // 2, sizes[-1][1] // 2))
    level = {f"down{k}": k - 1 for k in range(1, 6)}
    level.update({f"upsample{k}": 4 - k for k in range(1, 5)})
    level.update({f"up{k}": 4 - k for k in range(1, 5)})
    level["output"] = 0
    for name, pairs in unet_spec(3, 12):
        for cin, cout in pairs:
            out.append(sizes[level[name]] + (cin, cout))
    return out


def phase_kernels(gen: torch.Generator):
    """Kernel vs plain at each distinct block shape; returns per-shape
    (err, kernel ms, plain ms)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    res = {}
    for shape in dict.fromkeys(block_shapes(*HW)):
        h, w, cin, cout = shape
        x = torch.randn(BATCH, h, w, cin, generator=gen, device=dev
                        ).to(torch.bfloat16)
        wt = (torch.randn(3, 3, cin, cout, generator=gen, device=dev)
              * (2.0 / (9 * cin)) ** 0.5).to(torch.bfloat16)
        a = torch.rand(cout, generator=gen, device=dev) + 0.5
        b = torch.randn(cout, generator=gen, device=dev) * 0.1
        got = fused_conv.conv3x3_bn_relu(x, wt, a, b)
        ref = fused_conv.conv3x3_bn_relu_plain(x, wt, a, b)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        ms = cuda_ms(lambda: fused_conv.conv3x3_bn_relu(x, wt, a, b))
        plain_ms = cuda_ms(
            lambda: fused_conv.conv3x3_bn_relu_plain(x, wt, a, b))
        # the plain version's cuDNN conv alone, without its epilogue
        xc, wc = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
        conv_ms = cuda_ms(lambda: F.conv2d(xc, wc, padding=1))
        tflops = 2 * 9 * BATCH * h * w * cin * cout / ms / 1e9
        print(f"kernel {BATCH}x{h}x{w} {cin}->{cout}: max|err| {err:.4g} "
              f"/ max|ref| {scale:.4g} = {err / scale:.3g} "
              f"(tol {KERNEL_TOL}); kernel {ms:.4f} ms "
              f"({tflops:.1f} TFLOP/s), plain {plain_ms:.4f} ms "
              f"(its cuDNN conv alone {conv_ms:.4f} ms)", flush=True)
        check(err <= KERNEL_TOL * scale, f"kernel vs plain at {shape}")
        res[shape] = (err, ms, plain_ms)
    return res


def he_unet(gen: torch.Generator):
    """Full-width UNet with He-scaled conv weights (std sqrt(2/fan_in)) and
    identity BN stats, so activations stay O(1) through 23 blocks (the
    torch-default init shrinks their second moment about sixfold per
    block)."""
    model = get_model("unet", 3, 12, generator=gen)
    with torch.no_grad():
        for blk in model.blocks():
            conv = blk.conv[0]
            conv.weight.normal_(0.0, (2.0 / conv.weight[0].numel()) ** 0.5,
                                generator=gen)
            conv.bias.zero_()
    return model


def phase_slice(cpu_gen: torch.Generator, rng: np.random.Generator):
    n_blocks = sum(len(p) for _, p in unet_spec(3, 12))
    counter = fused_conv.conv3x3_bn_relu
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "unet_he.pth")
        torch.save(he_unet(cpu_gen).state_dict(), path)
        predictor = Predictor.from_checkpoint("unet", path,
                                              batch_size=BATCH,
                                              image_hw=HW)
    with predictor:
        requests = [
            rng.integers(0, 256, (8,) + HW + (3,), dtype=np.uint8),
            rng.integers(0, 256, (13,) + HW + (3,), dtype=np.uint8),
            rng.integers(0, 256, (8, 480, 640, 3), dtype=np.uint8),
        ]
        forwards = sum(-(-len(r) // BATCH) for r in requests)
        counter.launches = 0
        outs = [predictor.predict(r) for r in requests]
        torch.cuda.synchronize()
        launches = counter.launches
        print(f"slice: served {[len(r) for r in requests]} images in "
              f"{forwards} forwards; kernel launches {launches} "
              f"(expected {n_blocks} x {forwards})", flush=True)
        for r, o in zip(requests, outs):
            check(o.shape == (len(r),) + HW and o.dtype == np.uint8,
                  f"class map shape {o.shape} {o.dtype}")
            check(int(o.max()) < 12, "class index >= 12")
        check(launches == n_blocks * forwards, "launches per forward")

        # kernel path vs plain path on one batch, same normalized input
        x = torch.from_numpy(requests[0]).cuda()
        with torch.inference_mode():
            xn = to_tensor_normalize(x, settings.MEAN, settings.STD,
                                     torch.bfloat16)
            got = predictor.model(xn)
            ref = predictor.model(xn, plain=True)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
            ok_vals = bool(torch.isfinite(got).all())
            fwd_ms = cuda_ms(lambda: predictor.model(xn), iters=10)
            fwd_plain_ms = cuda_ms(lambda: predictor.model(xn, plain=True),
                                   iters=10)
        print(f"slice logits: max|kernel - plain| {err:.4g} / max|plain| "
              f"{scale:.4g} = {err / scale:.3g} (tol {LOGITS_TOL}); "
              f"argmax agreement {agree:.4f} (information only); "
              f"model forward b{BATCH}: kernel path {fwd_ms:.3f} ms, plain "
              f"path {fwd_plain_ms:.3f} ms", flush=True)
        check(ok_vals, "non-finite logits")
        check(err <= LOGITS_TOL * scale, "slice logits kernel vs plain")

        # serving throughput at the working size (warm), three repeats
        imgs = rng.integers(0, 256, (8 * BATCH,) + HW + (3,), dtype=np.uint8)
        predictor.predict(imgs[:BATCH])
        rates = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predictor.predict(imgs)
            torch.cuda.synchronize()
            rates.append(len(imgs) / (time.perf_counter() - t0))
        print(f"slice throughput: median {sorted(rates)[1]:.2f} img/s of "
              f"{', '.join(f'{r:.2f}' for r in rates)} ({len(imgs)} images "
              f"{HW[0]}x{HW[1]}, batch {BATCH}, predict() end to end) on "
              f"{card()}", flush=True)
    return launches, fwd_ms, fwd_plain_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(f"device: torch {torch.__version__} (CUDA {torch.version.cuda}); "
          f"{card()}", flush=True)

    path, secs, log = fused_conv.build()
    regs = sorted({ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln})
    print(f"build: {path.name} in {secs:.1f} s; ptxas: "
          f"{' | '.join(regs)}", flush=True)
    torch.cuda.synchronize()

    per_shape = phase_kernels(
        torch.Generator(device="cuda").manual_seed(SEED))
    launches, _, _ = phase_slice(torch.Generator().manual_seed(SEED),
                                 np.random.default_rng(SEED))
    check("jax" not in sys.modules, "jax was imported")

    shapes = block_shapes(*HW)
    kernels = [{
        "name": "conv3x3_bn_relu",
        "route": "cuda",
        "source": "pytorch_camvid_tpu_torch/csrc/conv3x3_bn_relu.cu",
        "replaces": "pytorch_camvid_tpu/ops/pallas_conv.py:190",
        "launches": launches,
        "max_abs_err": max(v[0] for v in per_shape.values()),
        # the 23 blocks of one batch-8 360x480 forward, summed per shape
        "ms": sum(per_shape[s][1] for s in shapes),
        "plain_ms": sum(per_shape[s][2] for s in shapes),
    }]
    print(json.dumps({"kernels": kernels}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
