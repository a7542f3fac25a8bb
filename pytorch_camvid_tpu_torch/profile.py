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
span, the busy time and share, the time by kernel group (``GROUPS``) and
the ``-top`` kernels by device time, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import sys

import torch

from pytorch_camvid_tpu_torch import bench
from pytorch_camvid_tpu_torch.train import TrainState

HW, SEED, STEPS = (360, 480), 0, 3

# kernel-name groups, first match wins
GROUPS = (
    ("K4/K1 conv (fwd, dx)", ("conv3x3_bn_relu_kernel",)),
    ("K1 dW", ("conv3x3_wgrad_kernel", "sum_splits_kernel")),
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
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("profile: the trace holds no device events", file=sys.stderr)
        return 1
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.end - e.time_range.start
    busy = sum(by_name.values()) / 1e3 / STEPS
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e3 / STEPS
    print(f"{args.net} {args.mode} batch {args.b} {HW[0]}x{HW[1]}: "
          f"device span {span:.2f} ms, busy {busy:.2f} ms, busy share "
          f"{busy / span:.3f} per iteration ({STEPS} traced)")
    groups = collections.Counter()
    for name, us in by_name.items():
        group = next((g for g, keys in GROUPS if any(k in name for k in keys)),
                     "other")
        groups[group] += us / 1e3 / STEPS
    print("by group: " + "; ".join(f"{g} {ms:.2f} ms ({ms / busy:.1%})"
                                   for g, ms in groups.most_common()))
    for name, us in by_name.most_common(args.top):
        ms = us / 1e3 / STEPS
        print(f"{ms:9.3f} ms {ms / busy:6.1%}  {name[:110]}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
