"""Where the device time goes: a bench train step or a serving forward on
one CUDA card, traced with torch.profiler, summed by kernel name.

Usage:
    python -m pytorch_camvid_tpu_torch.profile -net segnet -mode train -b 32
    python -m pytorch_camvid_tpu_torch.profile -net unet -mode serve -b 8

The train mode times ``bench.make_bench_step`` (augmentation, forward,
loss, backward, AdamW; bf16, 360x480) on one uint8 batch resident on the
card (``bench.resident_batch``); the serve mode times the eval-mode model
forward on a normalized bf16 batch. The model is chip_smoke.py's:
``bench.he_model`` from seed 0, at 360x480. After two untraced warm-up
iterations, three are traced; the output gives, per iteration, the device
span, the busy time (``bench.busy_ms``: the union of the kernels' spans,
as ``perf_probe.py`` counts it) and share, the summed kernel time (above
the busy time where kernels overlap), the time by kernel group
(``GROUPS``) and the ``-top`` kernels by device time, as shares of the
summed kernel time, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import sys

import torch

from pytorch_camvid_tpu_torch import bench
from pytorch_camvid_tpu_torch.train import TrainState

HW, SEED, STEPS = (360, 480), 0, 3

# kernel-name groups, first match wins
GROUPS = (
    ("K4/K1 conv (fwd, dx)", ("conv3x3_bn_relu", "conv_f32_",
                              "split_weights_kernel")),
    ("K1 dW", ("conv3x3_wgrad", "wgrad_f32_", "sum_splits_kernel")),
    ("K3/K2 pools", ("pool_kernel", "phase_gather_kernel")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise and copies", ("elementwise_kernel", "copy_kernel")),
)


def _workload(net: str, mode: str, batch: int):
    """A callable that runs one iteration on the card."""
    dev = torch.device("cuda")
    model = bench.he_model(net, torch.Generator().manual_seed(SEED)).to(dev)
    if mode == "serve":
        model.eval().prepare(torch.bfloat16)
        x = torch.randn((batch,) + HW + (3,), device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED)
                        ).to(torch.bfloat16)

        def forward():
            with torch.inference_mode():
                model(x)
        return forward
    data = bench.resident_batch(batch, HW, SEED, dev)
    opt, step = bench.make_bench_step(100)
    state = TrainState.create(model, opt, seed=SEED)

    def train_step():
        step(state, data)
    return train_step


def summarize(kernels, steps: int = STEPS) -> dict:
    """Per-iteration ms of a trace's device spans ((name, start us, end
    us), ``bench.device_spans``): ``span`` from the first start to the
    last end, ``busy``, ``kernel`` (summed), and ``by_name`` and
    ``groups``, summed kernel time per name and per ``GROUPS`` entry."""
    by_name = collections.Counter()
    for name, a, b in kernels:
        by_name[name] += (b - a) / 1e3 / steps
    groups = collections.Counter()
    for name, ms in by_name.items():
        group = next((g for g, keys in GROUPS if any(k in name for k in keys)),
                     "other")
        groups[group] += ms
    return {
        "span": (max(b for _, _, b in kernels)
                 - min(a for _, a, _ in kernels)) / 1e3 / steps,
        "busy": bench.busy_ms([(a, b) for _, a, b in kernels]) / steps,
        "kernel": sum(by_name.values()),
        "by_name": by_name,
        "groups": groups,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("-net", default="segnet")
    parser.add_argument("-mode", choices=("train", "serve"), default="train")
    parser.add_argument("-b", type=int, default=32)
    parser.add_argument("-top", type=int, default=25)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile: needs a CUDA device", file=sys.stderr)
        return 1
    run = _workload(args.net, args.mode, args.b)
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEPS):
            run()
        torch.cuda.synchronize()
    kernels = bench.device_spans(prof)
    if not kernels:
        print("profile: the trace holds no device events", file=sys.stderr)
        return 1
    s = summarize(kernels)
    print(f"{args.net} {args.mode} batch {args.b} {HW[0]}x{HW[1]}: "
          f"device span {s['span']:.2f} ms, busy {s['busy']:.2f} ms, busy "
          f"share {s['busy'] / s['span']:.3f}, kernel time "
          f"{s['kernel']:.2f} ms per iteration ({STEPS} traced)")
    print("by group: " + "; ".join(
        f"{g} {ms:.2f} ms ({ms / s['kernel']:.1%})"
        for g, ms in s["groups"].most_common()))
    for name, ms in s["by_name"].most_common(args.top):
        print(f"{ms:9.3f} ms {ms / s['kernel']:6.1%}  {name[:110]}")
    print(bench.card(torch.cuda.current_device()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
