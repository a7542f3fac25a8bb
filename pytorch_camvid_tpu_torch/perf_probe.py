"""Per-shape conv and pool probe on one CUDA card: counterpart of
``tools/perf_probe.py``, with its names and its JSON row keys.

    python -m pytorch_camvid_tpu_torch.perf_probe [--batch 24] [--k 30]
        [--kernel] [--pair] [--shapes {unet,segnet,dominant,pool,shallow64}]
        [--mode {fwd,dgrad,wgrad,blockvjp}]
        [--pool-impl {argmax,phase,k3,k2}] [--device cuda]

For every distinct conv3x3 shape of UNet or SegNet at 360x480 (with its
multiplicity in one forward) it prints one JSON line: the op's device ms,
achieved TFLOP/s and the shape's roofline min(peak, intensity * memory rate)
at the H100's 989 TFLOP/s and 3.35 TB/s.

Modes: ``fwd`` is the conv3x3+affine+ReLU block on K5 (``--pair``,
``ops/fused_conv_pair.py``), on K4 (``--kernel``, ``ops/fused_conv.py``) or
else on its plain version (cuDNN's conv, then the epilogue). ``dgrad`` and
``wgrad`` time cuDNN's bf16 input and weight gradients, as the JAX tool
times XLA's; ``dgrad`` as autograd runs it, ``convolution_backward`` with
the real channels-last input (``conv_train.conv3x3_dgrad_library``).
``blockvjp`` times the train block's forward and backward
(``ops/conv.py::ConvBNReLU`` in train mode on its plain path: cuDNN's
convs and the f32 BN+ReLU tail), as the JAX tool differentiates
``conv_bn_relu_apply``. ``--kernel`` applies to ``fwd`` only.

``--shapes pool`` times SegNet's pool + unpool pair at its five stages
against the byte bound. The JAX tool's ``--pool-impl`` values map so:
``argmax`` is the plain flat-index pair and ``phase`` the plain phase pair
(``ops/pooling.py``); the JAX tool's ``hybrid``, a second TPU layout of
the same function, is the port's ``phase``; ``pallas`` becomes ``k3``,
the flat-index kernels, and ``packed`` becomes ``k2``, the phase pool and
phase unpool kernels (``ops/fused_pool.py``).

Timing: eager PyTorch needs no chained loop against common-subexpression
elimination, so the op runs ``k`` times back to back after a warm-up,
under torch.profiler as in ``profile.py``. ``ms_gross`` is CUDA events
around those launches; ``ms`` is the time the device was busy with them
(``bench.busy_ms``, the union of the spans of every kernel, memset and
copy in the trace, as ``profile.py`` counts it), so kernels a library call
overlaps count once and helper kernels (cuDNN's layout transforms) count
as the op's. ``ms_chain_tax = ms_gross - ms`` is the time the device
waited on the host, the counterpart of the JAX tool's chain tax; it
includes the profiler's own cost per launch. A row above its roofline is
re-measured with 3x the launches, up to twice, and then flagged
``suspect``. The profiler now and then returns traces without their device
records (seen on the H100 for microsecond ops, three times in a row in
one run of ``chip_smoke.py``); after ``TRACE_TRIES`` such traces ``ms``
is the CUDA events' time, and a line on stderr says so. On the CPU (``--device cpu``) ``ms = ms_gross`` from the host
clock and the tax is 0; those rows time PyTorch's CPU kernels and say
nothing about the card. Every row names the device it ran on.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from typing import Callable, Dict, Tuple

import torch

from pytorch_camvid_tpu_torch import bench
from pytorch_camvid_tpu_torch.models.common import halvings
from pytorch_camvid_tpu_torch.ops import (conv_train, fused_conv,
                                          fused_conv_pair, fused_pool,
                                          pooling)
from pytorch_camvid_tpu_torch.ops.conv import ConvBNReLU

HW = (360, 480)
# the JAX tool's units: TFLOP/s and GB/s
PEAK_TFLOPS = bench.H100_BF16_PEAK / 1e12
HBM_GBPS = bench.H100_HBM_RATE / 1e9
WARMUP = 3
TRACE_TRIES = 3     # traces taken before time_op falls back to events
SEGNET_POOL_CHANNELS = (64, 128, 256, 512, 512)
POOL_IMPLS = ("argmax", "phase", "k3", "k2")


def unet_conv_shapes(hw=HW) -> Dict[Tuple[int, int, int, int], int]:
    """{(h, w, cin, cout): multiplicity in one UNet forward}."""
    return dict(collections.Counter(bench.block_shapes("unet", hw)))


def segnet_conv_shapes(hw=HW) -> Dict[Tuple[int, int, int, int], int]:
    """{(h, w, cin, cout): multiplicity in one SegNet forward}."""
    return dict(collections.Counter(bench.block_shapes("segnet", hw)))


def roofline_tflops(batch, h, w, cin, cout, dtype_bytes=2,
                    peak_tflops=PEAK_TFLOPS, hbm_gbps=HBM_GBPS):
    """(achievable TFLOP/s of the conv3x3 shape, its FLOPs): min(peak,
    FLOP per byte of input, output and weight * memory rate)."""
    flops = 2.0 * 9.0 * batch * h * w * cin * cout
    bytes_ = dtype_bytes * batch * h * w * (cin + cout) \
        + dtype_bytes * 9 * cin * cout
    return min(peak_tflops, flops / bytes_ * hbm_gbps / 1000.0), flops


def op_calls(k_start: int, k_final: int) -> int:
    """Calls of the op behind a row that started at ``k_start`` launches
    and ended at ``k_final``: per attempt a warm-up and the timed
    launches."""
    calls, kk = 0, k_start
    while kk <= k_final:
        calls += WARMUP + kk
        kk *= 3
    return calls


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("perf_probe: no CUDA device (pass --device cpu "
                           "to run on the host)")
    return dev


def _device_name(dev: torch.device) -> str:
    """The card's name and power limit (nvidia-smi), or 'cpu'."""
    if dev.type != "cuda":
        return "cpu"
    return bench.card(dev.index if dev.index is not None
                      else torch.cuda.current_device())


def time_op(fn: Callable[[], object], k: int,
            dev: torch.device) -> Tuple[float, float]:
    """(ms_gross, ms) per call of ``fn`` over ``k`` calls after a warm-up
    (module docstring)."""
    for _ in range(WARMUP):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        ms = (time.perf_counter() - t0) / k * 1e3
        return ms, ms
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # the profiler now and then returns a trace without its device records
    # (seen on the H100 for microsecond ops): such a trace is taken again
    for _ in range(TRACE_TRIES):
        torch.cuda.synchronize(dev)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.profiler.profile(activities=acts) as prof:
            e0.record()
            for _ in range(k):
                fn()
            e1.record()
            torch.cuda.synchronize(dev)
        spans = [(a, b) for _, a, b in bench.device_spans(prof)]
        if spans:
            return e0.elapsed_time(e1) / k, bench.busy_ms(spans) / k
    gross = e0.elapsed_time(e1) / k
    print(f"perf_probe: {TRACE_TRIES} traces held no device records; the "
          f"time is by CUDA events ({gross:.5f} ms a call)", file=sys.stderr,
          flush=True)
    return gross, gross


def _op(batch, h, w, cin, cout, mode, kernel, pair, dev):
    """The op to time, as a closure over its inputs (made from seed 0)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)
    x = randn(batch, h, w, cin)
    wgt = (randn(3, 3, cin, cout).float() * 0.05).to(bf16)
    a = torch.ones(cout, device=dev)
    b = torch.zeros(cout, device=dev)
    if mode == "fwd":
        fn = (fused_conv_pair.conv3x3_pair_bn_relu if pair
              else fused_conv.conv3x3_bn_relu if kernel
              else fused_conv.conv3x3_bn_relu_plain)
        return lambda: fn(x, wgt, a, b)
    g = randn(batch, h, w, cout)
    if mode == "dgrad":
        return lambda: conv_train.conv3x3_dgrad_library(g, wgt, x)
    if mode == "wgrad":
        xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        return lambda: torch.nn.grad.conv2d_weight(
            xc, (cout, cin, 3, 3), gc, padding=1)
    if mode == "blockvjp":
        blk = ConvBNReLU(cin, cout).to(dev).train()
        with torch.no_grad():
            blk.conv_bn()[0].weight.copy_(wgt.permute(3, 2, 0, 1))
        xr = x.detach().requires_grad_()

        def vjp():
            y = blk(xr, plain=True)
            return torch.autograd.grad(y, (xr, blk.conv_bn()[0].weight), g)
        return vjp
    raise ValueError(f"unknown mode {mode!r}")


def probe_shape(batch, h, w, cin, cout, k=30, kernel=False, mode="fwd",
                pair=False, device="cuda") -> dict:
    """One JSON row: the op's device time at (batch, h, w, cin, cout) against
    the shape's roofline (module docstring)."""
    dev = _device(device)
    op = _op(batch, h, w, cin, cout, mode, kernel, pair, dev)
    bound, flops = roofline_tflops(batch, h, w, cin, cout)
    kk = k
    for _ in range(3):
        gross, ms = time_op(op, kk, dev)
        achieved = flops / max(ms, 1e-9) / 1e9
        if achieved <= bound:
            break
        kk *= 3
    row = {
        "shape": [batch, h, w, cin, cout],
        "ms": ms,
        "ms_gross": gross,
        "ms_chain_tax": gross - ms,
        "tflops": achieved,
        "roofline_tflops": bound,
        "pct_of_roofline": 100.0 * achieved / bound,
        "impl": ("pair" if pair else "kernel" if kernel else "plain")
                if mode == "fwd" else "plain",
        "mode": mode,
        "k": kk,
        "device": _device_name(dev),
    }
    if achieved > bound:
        row["suspect"] = ("exceeds roofline after retries: the device time "
                          "is below this shape's physical limit")
    return row


def _pool_pair(impl: str):
    """(pool, unpool, index bytes) of a --pool-impl value."""
    if impl == "argmax":
        return pooling.max_pool_2x2_with_argmax, pooling.max_unpool_2x2, 4
    if impl == "phase":
        return (pooling.max_pool_2x2_argmax_phase,
                pooling.max_unpool_2x2_from_phase, 1)
    if impl == "k3":
        return fused_pool.max_pool_2x2_argmax, fused_pool.max_unpool_2x2, 4
    if impl == "k2":
        return (fused_pool.max_pool_2x2_phase,
                fused_pool.max_unpool_2x2_phase, 1)
    raise ValueError(f"unknown pool impl {impl!r}")


def probe_pool_ops(batch, hw=HW, k=30, impl="argmax",
                   device="cuda") -> list:
    """SegNet's pool + unpool pair at each of its five stages, against the
    byte bound of the pair's unavoidable traffic at 3.35 TB/s: x read and
    the unpooled output written (bf16), the pooled values and indices
    written and read back."""
    dev = _device(device)
    pool_fn, unpool_fn, idx_bytes = _pool_pair(impl)
    gen = torch.Generator(device=dev).manual_seed(0)
    name = _device_name(dev)
    rows = []
    for i, ((hh, ww), c) in enumerate(zip(halvings(hw, 5),
                                          SEGNET_POOL_CHANNELS)):
        x = torch.randn((batch, hh, ww, c), generator=gen,
                        device=dev).to(torch.bfloat16)

        def pair():
            y, idx = pool_fn(x)
            return unpool_fn(y, idx, (hh, ww))
        gross, ms = time_op(pair, k, dev)
        y_elems = batch * (hh // 2) * (ww // 2) * c
        traffic = x.numel() * 2 * 2 + y_elems * (2 + idx_bytes) * 2
        bound_ms = traffic / (HBM_GBPS * 1e9) * 1e3
        rows.append({
            "stage": i + 1, "impl": impl, "shape": [batch, hh, ww, c],
            "pool_unpool_ms": ms, "ms_gross": gross,
            "ms_chain_tax": gross - ms, "bw_bound_ms": bound_ms,
            "pct_of_bw_bound": 100.0 * bound_ms / max(ms, 1e-9),
            "k": k, "device": name,
        })
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pytorch_camvid_tpu_torch.perf_probe")
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--k", type=int, default=30)
    ap.add_argument("--kernel", action="store_true",
                    help="fwd on K4 (ops/fused_conv.py)")
    ap.add_argument("--pair", action="store_true",
                    help="fwd on K5 (ops/fused_conv_pair.py); H must be "
                         "even")
    ap.add_argument("--shapes", default="unet",
                    choices=["unet", "segnet", "dominant", "pool",
                             "shallow64"])
    ap.add_argument("--mode", default="fwd",
                    choices=["fwd", "dgrad", "wgrad", "blockvjp"])
    ap.add_argument("--pool-impl", default="argmax", choices=POOL_IMPLS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    try:
        _device(args.device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    if args.device.startswith("cuda"):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    if args.shapes == "pool":
        for row in probe_pool_ops(args.batch, k=args.k, impl=args.pool_impl,
                                  device=args.device):
            print(json.dumps(row), flush=True)
        return 0

    if args.shapes == "shallow64":
        # K5's target family at full resolution
        shapes = {(360, 480, 64, 64): 2, (360, 480, 128, 64): 2}
    else:
        shapes = (segnet_conv_shapes() if args.shapes == "segnet"
                  else unet_conv_shapes())
    if args.shapes == "dominant":
        # the three UNet shapes with the most FLOPs per forward
        ranked = sorted(shapes.items(),
                        key=lambda kv: -kv[1] * kv[0][0] * kv[0][1]
                        * kv[0][2] * kv[0][3])
        shapes = dict(ranked[:3])

    for (h, w, cin, cout), mult in sorted(shapes.items()):
        row = probe_shape(args.batch, h, w, cin, cout, k=args.k,
                          kernel=args.kernel, mode=args.mode,
                          pair=args.pair, device=args.device)
        row["multiplicity"] = mult
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
