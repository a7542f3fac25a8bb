"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):
1. device: needs CUDA; prints torch's version and the card's name and
   power limit (nvidia-smi).
2. build: compiles both kernels from csrc/ with nvcc, in parallel: the
   fused conv3x3+BN+ReLU (K4) and the conv3x3 weight gradient (K1's dW);
   prints ptxas's register and spill lines.
3. K4 vs plain: the kernel against its plain PyTorch version in bf16 at
   every distinct conv block shape of UNet at 360x480, batch 8: error and
   both times (CUDA events).
4. K1 vs plain at the same 15 shapes at batch 24: forward and dx (K4's
   kernel, unit affine, no ReLU) against F.conv2d and
   torch.nn.grad.conv2d_input, dW against the f32 plain version; kernel,
   plain and cuDNN-bf16-wgrad times.
5. serving slice: a full-width UNet (random He-scaled weights from a seed)
   saved as a reference-named .pth, loaded by ``Predictor.from_checkpoint``
   and serving three requests (8 images, 13 images, 8 images at 480x640
   that are resized on the device). Checks the class maps, that every
   forward launched K4 once per conv block, the logits of the kernel path
   against the plain path, and measures serving throughput.
6. training slice: full-width UNet, batch 24, 360x480, bf16, synthetic
   uint8 data resident on the card, the port's ``make_train_step`` with
   the default augmentation, AdamW and OneCycle. One step on the kernel
   path and one on the plain path from the same state: loss, per-leaf
   gradients (norm and difference) and BN running stats must agree
   (``train_parity``); the kernel step must
   launch 23 forward, 22 dx and 23 dW kernels. Then 20 timed steps (img/s,
   step ms, MFU, peak memory) with a finite loss throughout.

The last line is {"ok": true, "device": {...}}; the line before it names
the card and its power limit; the line before that is the per-kernel JSON.
Imports neither jax nor cv2.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_camvid_tpu_torch import bench
from pytorch_camvid_tpu_torch.config import settings
from pytorch_camvid_tpu_torch.data.normalize import to_tensor_normalize
from pytorch_camvid_tpu_torch.data.pipeline import DeviceDataLoader
from pytorch_camvid_tpu_torch.data.synthetic import synthetic_arrays
from pytorch_camvid_tpu_torch.models import get_model
from pytorch_camvid_tpu_torch.models.unet import unet_spec
from pytorch_camvid_tpu_torch.ops import conv_train, cuda_build, fused_conv
from pytorch_camvid_tpu_torch.serving import Predictor
from pytorch_camvid_tpu_torch.train import TrainState

KERNEL_TOL = 2e-2   # max|kernel - plain| / max|plain|, one bf16 block
LOGITS_TOL = 5e-2   # max|kernel - plain| / max|plain| logits, 23 blocks
K1_TOL = {"fwd": 2e-2, "dx": 2e-2, "wgrad": 1e-2}  # / max|plain|, per shape
# training slice, kernel path vs plain path after one step from the same
# state (both bf16; the two differ in accumulation order and so in bf16
# roundings, compounded through 23 blocks forward and back). Each limit is
# set from the H100 readings in PERF.md, where planted faults fail them.
TRAIN_LOSS_TOL = 1e-4        # |loss_k - loss_p| / loss_p
TRAIN_GRAD_TOL = 5e-2        # per leaf |norm(g_k) - norm(g_p)| / norm(g_p)
# per leaf norm(g_k - g_p) / norm(g_p): catches a permuted or flipped dW,
# whose norm is right; BN-parameter gradients (sums that cancel) carry up
# to 0.17 of rounding noise, so this limit is only ~3x the reading
TRAIN_GRAD_DIFF_TOL = 5e-1
TRAIN_STAT_TOL = 1e-3        # per BN buffer max|k - p| / max|p|
BATCH, HW = 8, (360, 480)
TRAIN_BATCH, TRAIN_STEPS = 24, 20
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


def phase_k1(gen: torch.Generator):
    """K1's three pieces vs their plain versions at each distinct block
    shape at batch 24; returns per-shape {piece: (err, ms, plain_ms)}."""
    dev = torch.device("cuda")
    res = {}
    for shape in dict.fromkeys(block_shapes(*HW)):
        h, w, cin, cout = shape
        n = TRAIN_BATCH
        x = torch.randn(n, h, w, cin, generator=gen, device=dev
                        ).to(torch.bfloat16)
        g = torch.randn(n, h, w, cout, generator=gen, device=dev
                        ).to(torch.bfloat16)
        wt = (torch.randn(3, 3, cin, cout, generator=gen, device=dev)
              * (2.0 / (9 * cin)) ** 0.5).to(torch.bfloat16)
        pieces = {
            "fwd": (lambda: conv_train.conv3x3_fwd(x, wt),
                    lambda: conv_train.conv3x3_train_plain(x, wt)),
            "wgrad": (lambda: conv_train.conv3x3_wgrad(x, g),
                      lambda: conv_train.conv3x3_wgrad_plain(x, g)),
        }
        if cin != 3:  # the stem's input is the image: no dx on the path
            pieces["dx"] = (lambda: conv_train.conv3x3_dgrad(g, wt),
                            lambda: conv_train.conv3x3_dgrad_plain(g, wt))
        res[shape] = {}
        line = [f"K1 {n}x{h}x{w} {cin}->{cout}:"]
        for name, (kern, plain) in pieces.items():
            got, ref = kern().float(), plain().float()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            ms = cuda_ms(kern, iters=10)
            plain_ms = cuda_ms(plain, iters=10)
            line.append(f"{name} err {err:.4g}/{scale:.4g}={err / scale:.3g}"
                        f" (tol {K1_TOL[name]}) {ms:.4f} ms, plain "
                        f"{plain_ms:.4f} ms;")
            check(err <= K1_TOL[name] * scale, f"K1 {name} at {shape}")
            res[shape][name] = (err, ms, plain_ms)
        xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        cudnn_ms = cuda_ms(lambda: torch.nn.grad.conv2d_weight(
            xc, (cout, cin, 3, 3), gc, padding=1), iters=10)
        line.append(f"cuDNN bf16 wgrad {cudnn_ms:.4f} ms")
        res[shape]["cudnn_wgrad_ms"] = cudnn_ms
        print(" ".join(line), flush=True)
    return res


def train_setup(cpu_gen: torch.Generator, dev=torch.device("cuda")):
    """The He-scaled full-width UNet on the card and one uint8 batch
    gathered on the card from resident synthetic data."""
    model = he_unet(cpu_gen).to(dev)
    images, labels = synthetic_arrays(4 * TRAIN_BATCH, hw=HW, seed=SEED)
    loader = DeviceDataLoader(images, labels, TRAIN_BATCH, shuffle=True,
                              seed=SEED, drop_last=True, device=dev)
    return model, loader.gather(loader.epoch_indices(0)[0])


def _worst(errs: dict):
    name = max(errs, key=errs.get)
    median = sorted(errs.values())[len(errs) // 2]
    return name, errs[name], median


def train_parity(model, batch) -> dict:
    """One step on the kernel path and one on the plain path from the same
    state: loss, per-leaf gradients and BN running stats must agree.
    Returns the kernel path's K1 launches."""
    out = {}
    for plain in (True, False):
        m = copy.deepcopy(model)
        opt, step = bench.make_bench_step(TRAIN_STEPS + 10, plain=plain)
        state = TrainState.create(m, opt, seed=SEED)
        torch.cuda.synchronize()
        conv_train.reset_launches()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        # AdamW's first moment after one update from zero is (1 - beta1) g
        out[plain] = {
            "loss": float(met["loss"]), "counts": conv_train.launches(),
            "grads": {k: v / (1.0 - met["beta1"])
                      for k, v in state.opt_state["m"].items()},
            "stats": {k: v.float().clone() for k, v in m.state_dict().items()
                      if "running" in k}}
        del m, state, step
        torch.cuda.empty_cache()
    k, p = out[False], out[True]
    print(f"train step b{TRAIN_BATCH}: loss kernel {k['loss']:.6f} plain "
          f"{p['loss']:.6f}; K1 launches kernel path {k['counts']}, plain "
          f"path {p['counts']}", flush=True)
    loss_err = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    norm = {n: torch.linalg.vector_norm(g).item()
            for n, g in p["grads"].items()}

    # A conv bias feeds train-mode BN, which removes the batch mean, so its
    # exact gradient is zero and both paths hold rounding noise there: it
    # is held against the same block's conv-weight gradient norm instead.
    def scale_of(n):
        return max(norm[n[:-len("bias")] + "weight"]
                   if n.endswith(".0.bias") else norm[n], 1e-30)
    norm_errs = {n: abs(torch.linalg.vector_norm(k["grads"][n]).item()
                        - norm[n]) / scale_of(n) for n in norm}
    diff_errs = {n: torch.linalg.vector_norm(k["grads"][n] - g).item()
                 / scale_of(n) for n, g in p["grads"].items()}
    stat_errs = {n: ((k["stats"][n] - v).abs().max()
                     / v.abs().max().clamp_min(1e-30)).item()
                 for n, v in p["stats"].items()}
    worst_n, worst_d, worst_s = (_worst(e) for e in
                                 (norm_errs, diff_errs, stat_errs))
    print(f"train step kernel vs plain: loss rel {loss_err:.3g} (tol "
          f"{TRAIN_LOSS_TOL}); per leaf, grad norm rel max {worst_n[1]:.3g} "
          f"at {worst_n[0]}, median {worst_n[2]:.3g} (tol "
          f"{TRAIN_GRAD_TOL}); |grad diff| rel max {worst_d[1]:.3g} at "
          f"{worst_d[0]}, median {worst_d[2]:.3g} (tol "
          f"{TRAIN_GRAD_DIFF_TOL}); BN stats rel max {worst_s[1]:.3g} at "
          f"{worst_s[0]}, median {worst_s[2]:.3g} (tol {TRAIN_STAT_TOL})",
          flush=True)
    n_blocks = sum(len(pr) for _, pr in unet_spec(3, 12))
    check(k["counts"] == {"fwd": n_blocks, "dgrad": n_blocks - 1,
                          "wgrad": n_blocks}, "K1 launches per step")
    check(p["counts"] == {"fwd": 0, "dgrad": 0, "wgrad": 0},
          "plain path launched a kernel")
    check(np.isfinite(k["loss"]) and loss_err <= TRAIN_LOSS_TOL,
          "train loss kernel vs plain")
    check(worst_n[1] <= TRAIN_GRAD_TOL, "grad norms kernel vs plain")
    check(worst_d[1] <= TRAIN_GRAD_DIFF_TOL, "grads kernel vs plain")
    check(worst_s[1] <= TRAIN_STAT_TOL, "BN stats kernel vs plain")
    return k["counts"]


def phase_train(cpu_gen: torch.Generator):
    """One step on each path from the same state, then the timed run."""
    model, batch = train_setup(cpu_gen)
    counts = train_parity(model, batch)
    n_blocks = sum(len(pr) for _, pr in unet_spec(3, 12))
    for plain in (False, True):
        m = copy.deepcopy(model)
        conv_train.reset_launches()
        r = bench.measure_train(m, TRAIN_BATCH, TRAIN_STEPS, hw=HW,
                                plain=plain, seed=SEED)
        r["counts"] = conv_train.launches()
        print(f"train {'plain' if plain else 'kernel'} path: "
              f"{r['images_per_sec']:.2f} img/s, step {r['step_ms']:.2f} ms, "
              f"MFU {r['mfu']:.4f}, peak memory "
              f"{r['max_memory_allocated'] / 2 ** 30:.2f} GiB, losses "
              f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, K1 launches "
              f"{r['counts']} ({TRAIN_STEPS} steps + 3 warm-up, batch "
              f"{TRAIN_BATCH}, {HW[0]}x{HW[1]}) on {card()}", flush=True)
        check(r["finite"], "non-finite training loss")
        want = 0 if plain else n_blocks * (TRAIN_STEPS + 3)
        check(r["counts"] == {"fwd": want, "dgrad": want - (want > 0) * (
            TRAIN_STEPS + 3), "wgrad": want}, "K1 launches in the timed run")
        del m
        torch.cuda.empty_cache()
    return counts


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

    sources = (fused_conv.SOURCE, conv_train.WGRAD_SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = list(pool.map(cuda_build.build, sources))
    for path, secs, log in builds:
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"build: {path.name} in {secs:.1f} s; ptxas: "
              f"{' | '.join(regs)}", flush=True)
    torch.cuda.synchronize()

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    per_shape = phase_kernels(
        torch.Generator(device="cuda").manual_seed(SEED))
    k1 = phase_k1(torch.Generator(device="cuda").manual_seed(SEED))
    launches, _, _ = phase_slice(torch.Generator().manual_seed(SEED),
                                 np.random.default_rng(SEED))
    k1_counts = phase_train(torch.Generator().manual_seed(SEED))
    check("jax" not in sys.modules, "jax was imported")

    shapes = block_shapes(*HW)
    src = "pytorch_camvid_tpu_torch/csrc/"
    kernels = [{
        "name": "conv3x3_bn_relu",
        "route": "cuda",
        "source": src + "conv3x3_bn_relu.cu",
        "replaces": "pytorch_camvid_tpu/ops/pallas_conv.py:230",
        "launches": launches,
        "max_abs_err": max(v[0] for v in per_shape.values()),
        # the 23 blocks of one batch-8 360x480 forward, summed per shape
        "ms": sum(per_shape[s][1] for s in shapes),
        "plain_ms": sum(per_shape[s][2] for s in shapes),
    }]
    # K1 at batch 24, summed over the blocks of one training step
    for piece, name, source, replaces in (
            ("fwd", "conv3x3_train.fwd", "conv3x3_bn_relu.cu",
             "pytorch_camvid_tpu/ops/pallas_conv.py:230"),
            ("dx", "conv3x3_train.dgrad", "conv3x3_bn_relu.cu",
             "pytorch_camvid_tpu/ops/pallas_conv.py:230"),
            ("wgrad", "conv3x3_train.wgrad", "conv3x3_wgrad.cu",
             "pytorch_camvid_tpu/ops/pallas_conv_train.py:172")):
        on_path = [s for s in shapes if piece in k1[s]]
        kernels.append({
            "name": name, "route": "cuda", "source": src + source,
            "replaces": replaces,
            "launches": k1_counts["dgrad" if piece == "dx" else piece],
            "max_abs_err": max(k1[s][piece][0] for s in on_path),
            "ms": sum(k1[s][piece][1] for s in on_path),
            "plain_ms": sum(k1[s][piece][2] for s in on_path),
        })
    print(json.dumps({"kernels": kernels}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
