"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):
1. device: needs CUDA; prints torch's version and the card's name and
   power limit (nvidia-smi).
2. build: compiles the three kernel sources of csrc/ with nvcc, in
   parallel: the fused conv3x3+BN+ReLU (K4), the conv3x3 weight gradient
   (K1's dW) and the 2x2 max pool / unpool / phase gather (K3, K2); prints
   ptxas's register and spill lines.
3. K4 vs plain: the kernel against its plain PyTorch version in bf16 at
   every distinct conv block shape of UNet and SegNet at 360x480, batch 8:
   error, both times and cuDNN's conv alone (CUDA events).
4. K1 vs plain at each model's block shapes at its training batch (UNet
   24, SegNet 32): forward and dx (K4's kernel, unit affine, no ReLU)
   against F.conv2d and torch.nn.grad.conv2d_input, dW against the f32
   plain version; kernel, plain and cuDNN-bf16-wgrad times. Then, per
   model, K4's and K1's times summed over its blocks beside their bounds.
5. UNet serving: a full-width UNet (random He-scaled weights from a seed)
   saved as a reference-named .pth, loaded by ``Predictor.from_checkpoint``
   and serving three requests (8 images, 13 images, 8 images at 480x640
   that are resized on the device). Checks the class maps, that every
   forward launched K4 once per conv block, the logits of the kernel path
   against the plain path, and measures serving throughput.
6. UNet training: full-width UNet, batch 24, 360x480, bf16, synthetic
   uint8 data resident on the card, the port's ``make_train_step`` with
   the default augmentation, AdamW and OneCycle. One step on the kernel
   path and one on the plain path from the same state: loss, per-leaf
   gradients (norm and difference) and BN running stats must agree
   (``train_parity``); the kernel step must launch 23 forward, 22 dx and
   23 dW kernels. Then 20 timed steps (img/s, step ms, MFU, peak memory)
   with a finite loss throughout.
7. K3 and K2 vs plain at SegNet's five pool shapes (K3 at batch 8, K2 at
   batch 32, bf16): pool, unpool and phase gather must equal their plain
   versions bit for bit; also ties on odd sizes (45x61 -> 22x30 -> 45x61,
   bf16 and f32, vector and scalar channel counts) and NaN in a window.
   Kernel, plain and library-call times and the share of the byte bound.
8. SegNet serving: as phase 5 with a full-width SegNet; every forward
   launches K4 26 times and the K3 pool and unpool 5 times each.
9. SegNet training: as phase 6 at batch 32; the kernel step launches K1
   26/25/26 times, the K2 pool 5, the phase unpool 10 (5 unpools and 5
   pool backwards) and the phase gather 5 times.
In phases 8 and 9 the plain path replays the kernel path's pool choices
(``recorded_choices``, ``replayed_choices``): a 1-ulp difference between
the two paths' convs would otherwise flip the choice of near-tied windows
and move values across the unpool. So the two paths differ only by the
convs' rounding, and logits, loss and BN stats are held to UNet's limits.
In phases 6 and 9 every kernel call of the kernel step is also held
against its plain version on the same inputs (``shadowed_kernels``); that
is SegNet's gradient check (``GRADS_END_TO_END``). ``chip_faults.py``
plants faults that these checks must catch.

The last line is {"ok": true, "device": {...}}; the line before it names
the card and its power limit; the line before that is the per-kernel JSON.
Imports neither jax nor cv2.
"""

from __future__ import annotations

import contextlib
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
from pytorch_camvid_tpu_torch.models.common import halvings
from pytorch_camvid_tpu_torch.models.segnet import segnet_spec
from pytorch_camvid_tpu_torch.ops import (conv_train, cuda_build, fused_conv,
                                          fused_pool, pooling)
from pytorch_camvid_tpu_torch.serving import Predictor
from pytorch_camvid_tpu_torch.train import TrainState

KERNEL_TOL = 2e-2   # max|kernel - plain| / max|plain|, one bf16 block
LOGITS_TOL = 5e-2   # max|kernel - plain| / max|plain| logits, 23-26 blocks
K1_TOL = {"fwd": 2e-2, "dx": 2e-2, "wgrad": 1e-2}  # / max|plain|, per shape
# training, kernel path vs plain path after one step from the same state
# (both bf16, SegNet's pools at the same choices; the two differ in
# accumulation order and so in bf16 roundings, compounded through 23-26
# blocks forward and back). Each limit is set from the H100 readings in
# PERF.md, where planted faults fail them (chip_faults.py).
TRAIN_LOSS_TOL = 1e-4        # |loss_k - loss_p| / loss_p
TRAIN_GRAD_TOL = 5e-2        # per leaf |norm(g_k) - norm(g_p)| / norm(g_p)
# per leaf norm(g_k - g_p) / norm(g_p): catches a permuted or flipped dW,
# whose norm is right; BN-parameter gradients (sums that cancel) carry up
# to 0.17 of rounding noise, so this limit is only ~3x the reading
TRAIN_GRAD_DIFF_TOL = 5e-1
TRAIN_STAT_TOL = 1e-3        # per BN buffer max|k - p| / max|p|
# whether the per-leaf gradient limits apply end to end. SegNet's do not:
# with no skip connection, the two paths' 1-ulp differences grow through
# its backward (PERF.md: a conv weight's |grad diff| reads 0.006 at the
# head, 0.35 six blocks back, 0.62 at the stem), so its gradients are held
# call by call on the step's own data (``shadowed_kernels``) instead
GRADS_END_TO_END = {"unet": True, "segnet": False}
BATCH, HW = 8, (360, 480)
TRAIN_BATCH = {"unet": 24, "segnet": 32}   # bench.py's headline batches
TRAIN_STEPS = 20
SEED = 0
POOLS = {"unet": 0, "segnet": 5}   # K3 / K2 pools per forward
# dense bf16 tensor-core peak and memory rate of an H100 SXM (data sheet)
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12


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


def bound_ms(flops: float, nbytes: float) -> tuple:
    """(least ms on the card, "operations" or "bytes")."""
    f, b = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (f, "operations") if f >= b else (b, "bytes")


def conv_bound(n, h, w, cin, cout, piece="fwd"):
    """Bound of one conv3x3 pass; fwd, dx and dW do the same FLOPs and
    move different bytes: bf16 activations and weight, f32 dW."""
    flops = 2.0 * 9 * n * h * w * cin * cout
    act_in, act_out, weight = n * h * w * cin, n * h * w * cout, 9 * cin * cout
    nbytes = {"fwd": 2 * (act_in + weight + act_out),
              "dx": 2 * (act_out + weight + act_in),
              "wgrad": 2 * (act_in + act_out) + 4 * weight}[piece]
    return bound_ms(flops, nbytes)


def all_block_shapes():
    """Every distinct conv block shape of both models at HW."""
    return list(dict.fromkeys(bench.block_shapes("unet", HW)
                              + bench.block_shapes("segnet", HW)))


def phase_kernels(gen: torch.Generator):
    """K4 vs plain at each distinct block shape; returns per shape
    (err, kernel ms, plain ms, cuDNN conv ms)."""
    dev = torch.device("cuda")
    res = {}
    for shape in all_block_shapes():
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
        res[shape] = (err, ms, plain_ms, conv_ms)
    return res


def phase_k1(gen: torch.Generator):
    """K1's three pieces vs their plain versions at each model's distinct
    block shapes at its training batch; returns {net: {shape: {piece:
    (err, ms, plain_ms)}}}, each shape also with cuDNN's bf16 wgrad ms."""
    dev = torch.device("cuda")
    res = {net: {} for net in TRAIN_BATCH}
    for net, shape in ((net, s) for net in TRAIN_BATCH
                       for s in dict.fromkeys(bench.block_shapes(net, HW))):
        h, w, cin, cout = shape
        n = TRAIN_BATCH[net]
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
        res[net][shape] = got_shape = {}
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
            got_shape[name] = (err, ms, plain_ms)
        xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        cudnn_ms = cuda_ms(lambda: torch.nn.grad.conv2d_weight(
            xc, (cout, cin, 3, 3), gc, padding=1), iters=10)
        line.append(f"cuDNN bf16 wgrad {cudnn_ms:.4f} ms")
        got_shape["cudnn_wgrad_ms"] = cudnn_ms
        print(" ".join(line), flush=True)
    return res


# -------------------------------------------------------------- pools (7)

def pool_stages():
    """(H, W, C) entering each of SegNet's five pools at HW."""
    spec = segnet_spec(3, 12)
    return [size + (spec[k][1][-1][1],)
            for k, size in enumerate(halvings(HW, 5))]


def bit_equal(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(equal bit for bit, NaN where NaN; max |got - ref| elsewhere)."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return False, float("inf")
    if not got.dtype.is_floating_point:
        return torch.equal(got, ref), float(
            (got.long() - ref.long()).abs().max()) if got.numel() else 0.0
    nan = torch.isnan(ref)
    if not torch.equal(torch.isnan(got), nan):
        return False, float("inf")
    as_int = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    same = torch.equal(got.view(as_int[got.dtype])[~nan],
                       ref.view(as_int[ref.dtype])[~nan])
    diff = (got.float() - ref.float())[~nan].abs()
    return same, float(diff.max()) if diff.numel() else 0.0


def check_pool_pair(x: torch.Tensor, what: str, g=None) -> dict:
    """Every pool function of both pairs on ``x`` against its plain
    version; returns {kernel name: max abs error}."""
    hw = (x.shape[1], x.shape[2])
    p, idx = pooling.max_pool_2x2_with_argmax(x)
    pp_, k = pooling.max_pool_2x2_argmax_phase(x)
    if g is None:
        g = torch.randn(x.shape, generator=torch.Generator(
            device=x.device).manual_seed(1), device=x.device).to(x.dtype)
    cases = {
        "maxpool2x2.pool_flat": (fused_pool.max_pool_2x2_argmax(x),
                                 (p, idx)),
        "maxpool2x2.unpool_flat": (fused_pool.max_unpool_2x2(p, idx, hw),
                                   pooling.max_unpool_2x2(p, idx, hw)),
        "maxpool2x2.pool_phase": (fused_pool.max_pool_2x2_phase(x),
                                  (pp_, k)),
        "maxpool2x2.unpool_phase": (
            fused_pool.max_unpool_2x2_phase(pp_, k, hw),
            pooling.max_unpool_2x2_from_phase(pp_, k, hw)),
        "maxpool2x2.phase_gather": (fused_pool.gather_phase(g, k),
                                    pooling.gather_phase(g, k)),
    }
    torch.cuda.synchronize()
    errs = {}
    for name, (got, ref) in cases.items():
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        results = [bit_equal(a, b) for a, b in zip(got, ref)]
        check(all(r[0] for r in results), f"{name} bit equality ({what})")
        errs[name] = max(r[1] for r in results)
    return errs


def pool_bytes(n, h, w, c, item):
    """Least bytes of each function: inputs read once, outputs written
    once (flat index int32, phase int8)."""
    x, s = n * h * w * c, n * (h // 2) * (w // 2) * c
    return {"maxpool2x2.pool_flat": x * item + s * (item + 4),
            "maxpool2x2.unpool_flat": s * (item + 4) + x * item,
            "maxpool2x2.pool_phase": x * item + s * (item + 1),
            "maxpool2x2.unpool_phase": s * (item + 1) + x * item,
            "maxpool2x2.phase_gather": x * item + s * 1 + s * item}


def phase_pools(gen: torch.Generator) -> dict:
    """K3 and K2 against their plain versions, bit for bit, at SegNet's
    pool shapes (K3 at batch 8, K2 at batch 32), plus ties on odd sizes and
    NaN; per kernel: max error and summed kernel, plain, library and bound
    times over the five stages."""
    dev = torch.device("cuda")
    out = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                  "library_ms": 0.0, "bound_ms": 0.0}
           for name in fused_pool.KERNELS}
    for h, w, c in pool_stages():
        for n, names in ((BATCH, ("maxpool2x2.pool_flat",
                                  "maxpool2x2.unpool_flat")),
                         (TRAIN_BATCH["segnet"], (
                             "maxpool2x2.pool_phase",
                             "maxpool2x2.unpool_phase",
                             "maxpool2x2.phase_gather"))):
            x = torch.randn(n, h, w, c, generator=gen, device=dev
                            ).to(torch.bfloat16)
            g = torch.randn(n, h, w, c, generator=gen, device=dev
                            ).to(torch.bfloat16)
            errs = check_pool_pair(x, f"{n}x{h}x{w}x{c}", g)
            hw = (h, w)
            p, idx = pooling.max_pool_2x2_with_argmax(x)
            _, k = pooling.max_pool_2x2_argmax_phase(x)
            nchw = (lambda t: t.permute(0, 3, 1, 2))
            xc, pc = nchw(x), nchw(p)
            idx64 = nchw(idx).long()
            idx64_nhwc = idx.long().reshape(n, -1, c)
            fns = {
                "maxpool2x2.pool_flat": (
                    lambda: fused_pool.max_pool_2x2_argmax(x),
                    lambda: pooling.max_pool_2x2_with_argmax(x),
                    lambda: F.max_pool2d(xc, 2, 2, return_indices=True)),
                "maxpool2x2.unpool_flat": (
                    lambda: fused_pool.max_unpool_2x2(p, idx, hw),
                    lambda: pooling.max_unpool_2x2(p, idx, hw),
                    lambda: F.max_unpool2d(pc, idx64, 2, 2,
                                           output_size=hw)),
                "maxpool2x2.pool_phase": (
                    lambda: fused_pool.max_pool_2x2_phase(x),
                    lambda: pooling.max_pool_2x2_argmax_phase(x),
                    lambda: F.max_pool2d(xc, 2, 2, return_indices=True)),
                "maxpool2x2.unpool_phase": (
                    lambda: fused_pool.max_unpool_2x2_phase(p, k, hw),
                    lambda: pooling.max_unpool_2x2_from_phase(p, k, hw),
                    lambda: F.max_unpool2d(pc, idx64, 2, 2,
                                           output_size=hw)),
                "maxpool2x2.phase_gather": (
                    lambda: fused_pool.gather_phase(g, k),
                    lambda: pooling.gather_phase(g, k),
                    lambda: torch.gather(g.reshape(n, h * w, c), 1,
                                         idx64_nhwc)),
            }
            nbytes = pool_bytes(n, h, w, c, 2)
            line = [f"pools {n}x{h}x{w}x{c}:"]
            for name in names:
                kern, plain, lib = fns[name]
                t = {"ms": cuda_ms(kern), "plain_ms": cuda_ms(plain),
                     "library_ms": cuda_ms(lib),
                     "bound_ms": nbytes[name] / PEAK_BYTES * 1e3}
                for key, v in t.items():
                    out[name][key] += v
                out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                               errs[name])
                line.append(f"{name.split('.')[1]} {t['ms']:.4f} ms (plain "
                            f"{t['plain_ms']:.4f}, library "
                            f"{t['library_ms']:.4f}, bound "
                            f"{t['bound_ms']:.4f}: "
                            f"{t['bound_ms'] / t['ms']:.2f} of it);")
            if n == TRAIN_BATCH["segnet"]:   # autograd's pool backward
                bwd_ms = cuda_ms(
                    lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                        pc, xc, [2, 2], [2, 2], [0, 0], [1, 1], False,
                        idx64))
                line.append(f"autograd pool backward {bwd_ms:.4f} ms")
            print(" ".join(line), flush=True)
            del x, g
    # ties (a grid of five values) on odd sizes, both dtypes, vector and
    # scalar channel counts; then NaN in a window
    for dtype in (torch.bfloat16, torch.float32):
        for c in (64, 3):
            x = (torch.randint(-2, 3, (2, 45, 61, c), generator=gen,
                               device=dev) * 0.5).to(dtype)
            errs = check_pool_pair(x, f"ties 45x61x{c} {dtype}")
            check(max(errs.values()) == 0, "ties: nonzero error")
    x = torch.randn(2, 8, 10, 16, generator=gen, device=dev
                    ).to(torch.bfloat16)
    x[0, 1, 0, 3] = float("nan")                  # phase 2 of window (0,0)
    x[1, 2, 5, 7] = x[1, 3, 5, 7] = float("nan")  # two NaNs: the last wins
    errs = check_pool_pair(x, "NaN")
    check(torch.isnan(fused_pool.max_pool_2x2_argmax(x)[0]).sum() == 2,
          "NaN pooled")
    print(f"pools: bit-equal to the plain versions at SegNet's 5 pool "
          f"shapes, on ties at 45x61 (bf16 and f32, C 64 and 3) and with "
          f"NaN in a window; max error {max(errs.values())}", flush=True)
    return out


# ----------------------------------------------------- models and slices

def n_blocks(net: str) -> int:
    return len(bench.block_shapes(net, HW))


def reset_counts() -> None:
    fused_conv.conv3x3_bn_relu.launches = 0
    conv_train.reset_launches()
    fused_pool.reset_launches()


def train_counts() -> dict:
    return {**conv_train.launches(), **fused_pool.launches()}


def expected_train_counts(net: str, steps: int) -> dict:
    """Launches of ``steps`` kernel-path steps."""
    nb, pools = n_blocks(net), POOLS[net]
    return {"fwd": nb * steps, "dgrad": (nb - 1) * steps,
            "wgrad": nb * steps, "maxpool2x2.pool_flat": 0,
            "maxpool2x2.unpool_flat": 0,
            "maxpool2x2.pool_phase": pools * steps,
            "maxpool2x2.unpool_phase": 2 * pools * steps,
            "maxpool2x2.phase_gather": pools * steps}


def train_setup(net: str, cpu_gen: torch.Generator,
                dev=torch.device("cuda")):
    """The He-scaled full-width model on the card and one uint8 batch
    gathered on the card from resident synthetic data."""
    return (bench.he_model(net, cpu_gen).to(dev),
            bench.resident_batch(TRAIN_BATCH[net], HW, SEED, dev))


# ------------------------------------------------- shared pool choices

@contextlib.contextmanager
def recorded_choices(model):
    """Yields a list that holds, after the block, the index each of the
    model's pools chose in it: the plain version of the mode's pool (flat
    in eval mode, phase in train mode) applied to the pool's input, its
    encoder stage's output. The kernel's own index is not read, so a
    kernel that chose otherwise makes the two paths differ. Empty for a
    model without pools."""
    inputs, choices = [], []
    hooks = [stage.register_forward_hook(
        lambda _m, _args, y: inputs.append(y.detach()))
        for name, stage in model.named_children()
        if name.startswith("encoder")]
    try:
        yield choices
    finally:
        for hook in hooks:
            hook.remove()
    pool = (pooling.max_pool_2x2_argmax_phase if model.training
            else pooling.max_pool_2x2_with_argmax)
    choices.extend(pool(x)[1] for x in inputs)


def _pool_at_flat(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (N,H,W,C) at the flat indices idx (N,H2,W2,C) of its planes."""
    n, c = x.shape[0], x.shape[3]
    return x.reshape(n, -1, c).gather(
        1, idx.reshape(n, -1, c).long()).reshape(idx.shape)


@contextlib.contextmanager
def replayed_choices(choices: list):
    """Inside the block the plain pools take ``choices`` in turn (from
    ``recorded_choices``) instead of choosing: each returns x at the given
    index and that index, so the plain path pools, unpools and routes the
    pool's gradient (autograd of the gather) where the kernel path did."""
    left = iter(choices)
    saved = (pooling.max_pool_2x2_with_argmax,
             pooling.max_pool_2x2_argmax_phase)

    def flat(x):
        idx = next(left)
        return _pool_at_flat(x, idx), idx

    def phase(x):
        k = next(left)
        return pooling.gather_phase(x, k), k

    (pooling.max_pool_2x2_with_argmax,
     pooling.max_pool_2x2_argmax_phase) = flat, phase
    try:
        yield
    finally:
        (pooling.max_pool_2x2_with_argmax,
         pooling.max_pool_2x2_argmax_phase) = saved
    check(next(left, None) is None, "a recorded pool choice was not used")


# ------------------------------------------- kernels on the step's data

# per piece: max|kernel - plain| / max|plain| on one call (K2: bit equality)
SHADOW_TOL = {"K1 fwd": K1_TOL["fwd"], "K1 dx": K1_TOL["dx"],
              "K1 dW": K1_TOL["wgrad"], "K2 pool": 0.0,
              "K2 pool backward": 0.0, "K2 unpool": 0.0,
              "K2 unpool backward": 0.0}


def _note(errs: dict, piece: str, err: float) -> None:
    errs[piece] = max(errs.get(piece, 0.0), err)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def _bits(got: torch.Tensor, want: torch.Tensor) -> float:
    """0 when bit-equal; else the max error, or inf if that is 0."""
    same, err = bit_equal(got, want)
    return 0.0 if same else (err or float("inf"))


def _plain_grad(fn, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """d<fn(x), g>/dx by autograd of a plain version."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_()
        return torch.autograd.grad(fn(xr), xr, g)[0]


@contextlib.contextmanager
def shadowed_kernels(errs: dict):
    """Inside the block every call of the kernel path's autograd Functions
    is held, forward and backward, against plain versions on the same
    inputs, and ``errs`` gets each piece's worst error (``SHADOW_TOL``):
    K1's conv (``conv_train._Conv3x3Train``) against F.conv2d,
    ``conv2d_input`` and the f32 wgrad; K2's pool and unpool
    (``fused_pool._PoolPhaseTrain``, ``_UnpoolPhaseTrain``) against their
    plain versions and autograd's derivatives of those. A wrong kernel, or
    a Function that wires a right kernel wrongly, shows here on the step's
    own data, however much the model compounds the two paths' roundings.
    The plain versions launch no counted kernel."""
    conv_cls = conv_train._Conv3x3Train
    pool_cls, unpool_cls = fused_pool._PoolPhaseTrain, \
        fused_pool._UnpoolPhaseTrain
    saved = [(cls, name, cls.__dict__[name])
             for cls in (conv_cls, pool_cls, unpool_cls)
             for name in ("forward", "backward")]
    conv_fwd, conv_bwd = conv_cls.forward, conv_cls.backward
    pool_fwd, pool_bwd = pool_cls.forward, pool_cls.backward
    unpool_fwd, unpool_bwd = unpool_cls.forward, unpool_cls.backward

    def conv_forward(ctx, x, w):
        y = conv_fwd(ctx, x, w)
        _note(errs, "K1 fwd", _rel(y, conv_train.conv3x3_train_plain(x, w)))
        return y

    def conv_backward(ctx, g):
        dx, dw = conv_bwd(ctx, g)
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        if dx is not None:
            _note(errs, "K1 dx",
                  _rel(dx, conv_train.conv3x3_dgrad_plain(g, w)))
        _note(errs, "K1 dW", _rel(dw, conv_train.conv3x3_wgrad_plain(x, g)))
        return dx, dw

    def pool_forward(ctx, x):
        pooled, k = pool_fwd(ctx, x)
        want = pooling.max_pool_2x2_argmax_phase(x)
        _note(errs, "K2 pool", max(_bits(pooled, want[0]),
                                   _bits(k, want[1])))
        ctx.shadow_x = x.detach()
        return pooled, k

    def pool_backward(ctx, g, gk):
        dx = pool_bwd(ctx, g, gk)
        want = _plain_grad(
            lambda t: pooling.max_pool_2x2_argmax_phase(t)[0],
            ctx.shadow_x, g)
        _note(errs, "K2 pool backward", _bits(dx, want))
        return dx

    def unpool_forward(ctx, x, k, out_hw):
        out = unpool_fwd(ctx, x, k, out_hw)
        _note(errs, "K2 unpool", _bits(
            out, pooling.max_unpool_2x2_from_phase(x, k, out_hw)))
        ctx.shadow = (x.detach(), k, out_hw)
        return out

    def unpool_backward(ctx, g):
        dx, dk, dhw = unpool_bwd(ctx, g)
        x, k, out_hw = ctx.shadow
        want = _plain_grad(
            lambda t: pooling.max_unpool_2x2_from_phase(t, k, out_hw),
            x, g)
        _note(errs, "K2 unpool backward", _bits(dx, want))
        return dx, dk, dhw

    for cls, fwd, bwd in ((conv_cls, conv_forward, conv_backward),
                          (pool_cls, pool_forward, pool_backward),
                          (unpool_cls, unpool_forward, unpool_backward)):
        cls.forward, cls.backward = staticmethod(fwd), staticmethod(bwd)
    try:
        yield errs
    finally:
        for cls, name, attr in saved:
            setattr(cls, name, attr)


# --------------------------------------------------- parity of the paths

def _worst(errs: dict):
    name = max(errs, key=errs.get)
    median = sorted(errs.values())[len(errs) // 2]
    return name, errs[name], median


def one_step(model, batch, plain: bool, choices=None) -> dict:
    """One bench step from ``model``'s state on a copy: loss, launches,
    per-leaf gradients and BN running stats after it; on the kernel path
    also the step's pool choices and its kernels' errors on the step's data
    (``shadowed_kernels``). ``choices`` (the plain path): replayed."""
    m = copy.deepcopy(model)
    opt, step = bench.make_bench_step(TRAIN_STEPS + 10, plain=plain)
    state = TrainState.create(m, opt, seed=SEED)
    shadow, made = {}, choices
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.ExitStack() as stack:
        if choices is None:
            made = stack.enter_context(recorded_choices(m))
            stack.enter_context(shadowed_kernels(shadow))
        else:
            stack.enter_context(replayed_choices(choices))
        state, met = step(state, batch)
    torch.cuda.synchronize()
    counts = train_counts()
    # AdamW's first moment after one update from zero is (1 - beta1) g
    out = {"loss": float(met["loss"]), "counts": counts, "shadow": shadow,
           "choices": made,
           "grads": {k: v / (1.0 - met["beta1"])
                     for k, v in state.opt_state["m"].items()},
           "stats": {k: v.float().clone() for k, v in m.state_dict().items()
                     if "running" in k}}
    del m, state, step
    torch.cuda.empty_cache()
    return out


def grad_errors(model, got: dict, want: dict) -> tuple:
    """Per leaf |norm(got) - norm(want)| and norm(got - want), over
    norm(want). A conv bias feeds train-mode BN, which removes the batch
    mean, so its exact gradient is zero and every path holds rounding
    noise there: it is held against its conv weight's gradient norm."""
    norm = {n: torch.linalg.vector_norm(g).item() for n, g in want.items()}
    conv_weight = {}   # conv bias name -> its conv weight's name
    for stage, pairs in model.spec:
        for i in range(len(pairs)):
            names = model.block_names(stage, i)
            conv_weight[names["b"]] = names["w"]

    def scale_of(n):
        return max(norm[conv_weight.get(n, n)], 1e-30)
    norm_errs = {n: abs(torch.linalg.vector_norm(got[n]).item() - norm[n])
                 / scale_of(n) for n in norm}
    diff_errs = {n: torch.linalg.vector_norm(got[n] - g).item()
                 / scale_of(n) for n, g in want.items()}
    return norm_errs, diff_errs


def train_parity(net: str, model, batch) -> dict:
    """One step on the kernel path and one on the plain path from the same
    state, the plain path at the kernel path's pool choices: loss and BN
    running stats must agree, and so must the per-leaf gradients where
    ``GRADS_END_TO_END``; every kernel call of the kernel step must agree
    with its plain version on the same inputs (``shadowed_kernels``).
    Returns the kernel path's launches."""
    k = one_step(model, batch, plain=False)
    p = one_step(model, batch, plain=True, choices=k["choices"])
    print(f"{net} train step b{TRAIN_BATCH[net]}: loss kernel "
          f"{k['loss']:.6f} plain {p['loss']:.6f} (plain path at the kernel "
          f"path's {len(k['choices'])} pool choices); launches kernel path "
          f"{k['counts']}, plain path {p['counts']}", flush=True)
    loss_err = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    norm_errs, diff_errs = grad_errors(model, k["grads"], p["grads"])
    stat_errs = {n: ((k["stats"][n] - v).abs().max()
                     / v.abs().max().clamp_min(1e-30)).item()
                 for n, v in p["stats"].items()}
    worst_n, worst_d, worst_s = (_worst(e) for e in
                                 (norm_errs, diff_errs, stat_errs))
    print(f"{net} train step kernel vs plain: loss rel {loss_err:.3g} (tol "
          f"{TRAIN_LOSS_TOL}); per leaf, grad norm rel max {worst_n[1]:.3g} "
          f"at {worst_n[0]}, median {worst_n[2]:.3g} (tol "
          f"{TRAIN_GRAD_TOL}); |grad diff| rel max {worst_d[1]:.3g} at "
          f"{worst_d[0]}, median {worst_d[2]:.3g} (tol "
          f"{TRAIN_GRAD_DIFF_TOL}); BN stats rel max {worst_s[1]:.3g} at "
          f"{worst_s[0]}, median {worst_s[2]:.3g} (tol {TRAIN_STAT_TOL})",
          flush=True)
    weights = [model.block_names(stage, i)["w"]
               for stage, pairs in model.spec for i in range(len(pairs))]
    print(f"{net} train step kernel vs plain, |grad diff| rel of each conv "
          f"weight in forward order: "
          f"{' '.join(f'{diff_errs[w]:.3g}' for w in weights)}", flush=True)
    print(f"{net} train step, each kernel call against its plain version "
          f"on the same inputs, worst per piece: " + "; ".join(
              f"{piece} {e:.3g} (tol {SHADOW_TOL[piece]})"
              for piece, e in k["shadow"].items()), flush=True)
    check(k["counts"] == expected_train_counts(net, 1),
          f"{net} launches per step")
    want = [p for p in SHADOW_TOL if POOLS[net] or p.startswith("K1")]
    check(sorted(k["shadow"]) == sorted(want), f"{net} kernel pieces seen")
    for piece, e in k["shadow"].items():
        check(e <= SHADOW_TOL[piece], f"{net} {piece} on the step's data")
    check(set(p["counts"].values()) == {0}, "plain path launched a kernel")
    check(np.isfinite(k["loss"]) and loss_err <= TRAIN_LOSS_TOL,
          "train loss kernel vs plain")
    check(worst_s[1] <= TRAIN_STAT_TOL, "BN stats kernel vs plain")
    if GRADS_END_TO_END[net]:
        check(worst_n[1] <= TRAIN_GRAD_TOL, "grad norms kernel vs plain")
        check(worst_d[1] <= TRAIN_GRAD_DIFF_TOL, "grads kernel vs plain")
    return k["counts"]


def phase_train(net: str, cpu_gen: torch.Generator):
    """One step on each path from the same state, then the timed run."""
    model, batch = train_setup(net, cpu_gen)
    counts = train_parity(net, model, batch)
    b = TRAIN_BATCH[net]
    for plain in (False, True):
        m = copy.deepcopy(model)
        reset_counts()
        r = bench.measure_train(m, b, TRAIN_STEPS, hw=HW, plain=plain,
                                seed=SEED)
        r["counts"] = train_counts()
        print(f"{net} train {'plain' if plain else 'kernel'} path: "
              f"{r['images_per_sec']:.2f} img/s, step {r['step_ms']:.2f} ms, "
              f"MFU {r['mfu']:.4f}, peak memory "
              f"{r['max_memory_allocated'] / 2 ** 30:.2f} GiB, losses "
              f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, launches "
              f"{r['counts']} ({TRAIN_STEPS} steps + 3 warm-up, batch "
              f"{b}, {HW[0]}x{HW[1]}) on {card()}", flush=True)
        check(r["finite"], "non-finite training loss")
        want = expected_train_counts(net, 0 if plain else TRAIN_STEPS + 3)
        check(r["counts"] == want, f"{net} launches in the timed run")
        del m
        torch.cuda.empty_cache()
    del model, batch
    torch.cuda.empty_cache()
    return counts


def logits_parity(net: str, model, x_u8: torch.Tensor) -> torch.Tensor:
    """The eval-mode model's logits for one uint8 batch on the kernel path
    and on the plain path (at the kernel path's pool choices): within
    LOGITS_TOL of max|plain|. Returns the normalized batch."""
    with torch.inference_mode():
        xn = to_tensor_normalize(x_u8, settings.MEAN, settings.STD,
                                 torch.bfloat16)
        with recorded_choices(model) as choices:
            got = model(xn)
        with replayed_choices(choices):
            ref = model(xn, plain=True)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        finite = bool(torch.isfinite(got).all())
    print(f"{net} serving logits: max|kernel - plain| {err:.4g} / "
          f"max|plain| {scale:.4g} = {err / scale:.3g} (tol {LOGITS_TOL}; "
          f"plain path at the kernel path's {len(choices)} pool choices); "
          f"argmax agreement {agree:.4f} (information only)", flush=True)
    check(finite, "non-finite logits")
    check(err <= LOGITS_TOL * scale, f"{net} logits kernel vs plain")
    return xn


def phase_slice(net: str, cpu_gen: torch.Generator,
                rng: np.random.Generator):
    """Serve three requests through ``Predictor``; returns the launches of
    those requests."""
    nb, pools = n_blocks(net), POOLS[net]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{net}_he.pth")
        torch.save(bench.he_model(net, cpu_gen).state_dict(), path)
        predictor = Predictor.from_checkpoint(net, path, batch_size=BATCH,
                                              image_hw=HW)
    with predictor:
        requests = [
            rng.integers(0, 256, (8,) + HW + (3,), dtype=np.uint8),
            rng.integers(0, 256, (13,) + HW + (3,), dtype=np.uint8),
            rng.integers(0, 256, (8, 480, 640, 3), dtype=np.uint8),
        ]
        forwards = sum(-(-len(r) // BATCH) for r in requests)
        torch.cuda.synchronize()
        reset_counts()
        outs = [predictor.predict(r) for r in requests]
        torch.cuda.synchronize()
        launches = {"conv3x3_bn_relu": fused_conv.conv3x3_bn_relu.launches,
                    **fused_pool.launches()}
        want = {"conv3x3_bn_relu": nb * forwards,
                "maxpool2x2.pool_flat": pools * forwards,
                "maxpool2x2.unpool_flat": pools * forwards,
                "maxpool2x2.pool_phase": 0, "maxpool2x2.unpool_phase": 0,
                "maxpool2x2.phase_gather": 0}
        print(f"{net} serving: {[len(r) for r in requests]} images in "
              f"{forwards} forwards; launches {launches} (expected "
              f"{want})", flush=True)
        for r, o in zip(requests, outs):
            check(o.shape == (len(r),) + HW and o.dtype == np.uint8,
                  f"class map shape {o.shape} {o.dtype}")
            check(int(o.max()) < 12, "class index >= 12")
        check(launches == want, f"{net} launches per forward")

        # kernel path vs plain path on one batch, same normalized input
        xn = logits_parity(net, predictor.model,
                           torch.from_numpy(requests[0]).cuda())
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: predictor.model(xn), iters=10)
            fwd_plain_ms = cuda_ms(lambda: predictor.model(xn, plain=True),
                                   iters=10)
        print(f"{net} model forward b{BATCH}: kernel path {fwd_ms:.3f} ms, "
              f"plain path {fwd_plain_ms:.3f} ms", flush=True)

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
        print(f"{net} serving throughput: median {sorted(rates)[1]:.2f} "
              f"img/s of {', '.join(f'{r:.2f}' for r in rates)} "
              f"({len(imgs)} images {HW[0]}x{HW[1]}, batch {BATCH}, "
              f"predict() end to end) on {card()}", flush=True)
    return launches


# ------------------------------------------------------------------ main

def summed_bound(n: int, piece: str, shapes) -> tuple:
    """Bound of one pass over ``shapes`` (one per block), named by what
    bounds most of it."""
    by = {}
    for s in shapes:
        t, kind = conv_bound(n, *s, piece=piece)
        by[kind] = by.get(kind, 0.0) + t
    return sum(by.values()), max(by, key=by.get)


def conv_sums(per_shape, k1) -> dict:
    """Per model, K4 over the blocks of one batch-8 forward ("k4") and
    K1's pieces over the blocks of one training step at the model's
    batch: {net: {piece: {max_abs_err, ms, plain_ms, library_ms, bound_ms,
    bound_by}}}, printed. Library: cuDNN's conv alone for K4 (there is no
    fused conv+BN+ReLU call), the plain versions for K1's fwd and dx
    (cuDNN's calls themselves), cuDNN's bf16 wgrad for dW (the plain one
    is f32)."""
    sums = {}
    for net, n in TRAIN_BATCH.items():
        shapes = bench.block_shapes(net, HW)
        b, by = summed_bound(BATCH, "fwd", shapes)
        sums[net] = {"k4": {
            "max_abs_err": max(per_shape[s][0] for s in shapes),
            "ms": sum(per_shape[s][1] for s in shapes),
            "plain_ms": sum(per_shape[s][2] for s in shapes),
            "library_ms": sum(per_shape[s][3] for s in shapes),
            "bound_ms": b, "bound_by": by}}
        for piece in ("fwd", "dx", "wgrad"):
            on_path = [s for s in shapes if piece in k1[net][s]]
            b, by = summed_bound(n, piece, on_path)
            sums[net][piece] = {
                "max_abs_err": max(k1[net][s][piece][0] for s in on_path),
                "ms": sum(k1[net][s][piece][1] for s in on_path),
                "plain_ms": sum(k1[net][s][piece][2] for s in on_path),
                "library_ms": sum(k1[net][s]["cudnn_wgrad_ms"]
                                  if piece == "wgrad" else
                                  k1[net][s][piece][2] for s in on_path),
                "bound_ms": b, "bound_by": by}
        label = {"k4": f"K4 b{BATCH}", "fwd": f"K1 fwd b{n}",
                 "dx": f"K1 dx b{n}", "wgrad": f"K1 dW b{n}"}
        print(f"{net} conv sums over its {len(shapes)} blocks: " + "; ".join(
            f"{label[p]} {t['ms']:.3f} ms (plain {t['plain_ms']:.3f}, library "
            f"{t['library_ms']:.3f}, bound {t['bound_ms']:.3f} by "
            f"{t['bound_by']}: {t['bound_ms'] / t['ms']:.2f} of it)"
            for p, t in sums[net].items()), flush=True)
    return sums


def conv_entries(unet_sums, serve_launches, k1_counts):
    """The JSON entries of K4 and K1's three pieces: UNet's sums, as in
    earlier runs (``conv_sums``); launches from the main paths."""
    src = "pytorch_camvid_tpu_torch/csrc/"
    entries = []
    for piece, name, source, replaces, launches in (
            ("k4", "conv3x3_bn_relu", "conv3x3_bn_relu.cu",
             "pytorch_camvid_tpu/ops/pallas_conv.py:230", serve_launches),
            ("fwd", "conv3x3_train.fwd", "conv3x3_bn_relu.cu",
             "pytorch_camvid_tpu/ops/pallas_conv.py:230", k1_counts["fwd"]),
            ("dx", "conv3x3_train.dgrad", "conv3x3_bn_relu.cu",
             "pytorch_camvid_tpu/ops/pallas_conv.py:230",
             k1_counts["dgrad"]),
            ("wgrad", "conv3x3_train.wgrad", "conv3x3_wgrad.cu",
             "pytorch_camvid_tpu/ops/pallas_conv_train.py:172",
             k1_counts["wgrad"])):
        entries.append({"name": name, "route": "cuda",
                        "source": src + source, "replaces": replaces,
                        "launches": launches, **unet_sums[piece]})
    return entries


POOL_REPLACES = {
    "maxpool2x2.pool_flat": "pytorch_camvid_tpu/ops/pallas_pool.py:100",
    "maxpool2x2.unpool_flat": "pytorch_camvid_tpu/ops/pallas_pool.py:558",
    "maxpool2x2.pool_phase": "pytorch_camvid_tpu/ops/pallas_pool.py:400; "
                             "pytorch_camvid_tpu/ops/pallas_pool.py:177",
    "maxpool2x2.unpool_phase": "pytorch_camvid_tpu/ops/pallas_pool.py:313; "
                               "pytorch_camvid_tpu/ops/pallas_pool.py:222",
    "maxpool2x2.phase_gather": "pytorch_camvid_tpu/ops/pallas_pool.py:452; "
                               "pytorch_camvid_tpu/ops/pallas_pool.py:262",
}


def start() -> None:
    """Phases 1 and 2: the device, then the three kernel sources built in
    parallel; TF32 off for the plain versions."""
    print(f"device: torch {torch.__version__} (CUDA {torch.version.cuda}); "
          f"{card()}", flush=True)
    sources = (fused_conv.SOURCE, conv_train.WGRAD_SOURCE, fused_pool.SOURCE)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    start()
    per_shape = phase_kernels(
        torch.Generator(device="cuda").manual_seed(SEED))
    k1 = phase_k1(torch.Generator(device="cuda").manual_seed(SEED))
    sums = conv_sums(per_shape, k1)
    unet_serve = phase_slice("unet", torch.Generator().manual_seed(SEED),
                             np.random.default_rng(SEED))
    unet_train = phase_train("unet", torch.Generator().manual_seed(SEED))
    pools = phase_pools(torch.Generator(device="cuda").manual_seed(SEED))
    seg_serve = phase_slice("segnet", torch.Generator().manual_seed(SEED),
                            np.random.default_rng(SEED))
    seg_train = phase_train("segnet", torch.Generator().manual_seed(SEED))
    check("jax" not in sys.modules, "jax was imported")

    kernels = conv_entries(sums["unet"], unet_serve["conv3x3_bn_relu"],
                           unet_train)
    for name, t in pools.items():
        launches = (seg_serve if name.endswith("flat") else seg_train)[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pytorch_camvid_tpu_torch/csrc/maxpool2x2.cu",
            "replaces": POOL_REPLACES[name], "launches": launches,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
