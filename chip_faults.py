"""Planted faults against chip_smoke.py's SegNet parity checks on one NVIDIA
GPU (Hopper, sm_90a): each fault must make a check fail.

    python3 chip_faults.py

Builds the kernels (chip_smoke's phases 1 and 2), then runs, on a
full-width SegNet with chip_smoke's He-scaled weights from seed 0, the
serving logits check (``chip_smoke.logits_parity``, batch 8, 360x480) and
the one-step training check (``chip_smoke.train_parity``, batch 32), once
sound and once under each planted fault. Every fault keeps every kernel
launch, so only the values can show it. Prints each reading and the check
that failed; exits non-zero if the sound run fails a check or a fault
passes them all.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

import chip_smoke as smoke
from pytorch_camvid_tpu_torch import bench
from pytorch_camvid_tpu_torch.models.segnet import SegNet
from pytorch_camvid_tpu_torch.ops import (conv, conv_train, fused_conv,
                                          fused_pool)

# the 13th of a step's 26 dW launches (backward order): decoder5.0's
ZEROED_DW_CALL = 13


@contextlib.contextmanager
def planted(owner, name: str, value):
    """``owner.name`` (a module's function or a class's method) replaced by
    ``value`` inside the block."""
    saved = owner.__dict__[name]
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def k4_gain(x, w, a, b, relu=True):
    """The eval block's K4 launch with its output 1% too large."""
    out = fused_conv.conv3x3_bn_relu(x, w, a, b, relu)
    return (out.float() * 1.01).to(out.dtype)


_segnet_pools = SegNet._pools


def unpool_to_neighbour(self, plain):
    """The kernel path's K3 unpool puts each value at the other pixel of
    its window's row (flat index ^ 1: every SegNet plane is even-wide)."""
    pool, unpool = _segnet_pools(self, plain)
    if plain:
        return pool, unpool
    return pool, lambda x, idx, hw: unpool(x, idx ^ 1, hw)


def pool_backward_wrong_phase(ctx, g, _gk):
    """K2's pool backward unpooling the gradient at phase k ^ 1."""
    k, = ctx.saved_tensors
    return fused_pool.max_unpool_2x2_phase(g.contiguous(), k ^ 1, ctx.in_hw)


def unpool_backward_wrong_phase(ctx, g):
    """K2's unpool backward gathering at phase k ^ 1."""
    k, = ctx.saved_tensors
    return fused_pool.gather_phase(g.contiguous(), k ^ 1), None, None


_conv_forward = conv_train._Conv3x3Train.forward
_conv_backward = conv_train._Conv3x3Train.backward


def k1_gain(ctx, x, w):
    """K1's forward with its output 1% too large."""
    y = _conv_forward(ctx, x, w)
    return (y.float() * 1.01).to(y.dtype)


def zero_one_dw(ctx, g):
    """K1's backward with one block's dW zeroed (after its launch)."""
    dx, dw = _conv_backward(ctx, g)
    zero_one_dw.calls += 1
    if zero_one_dw.calls == ZEROED_DW_CALL:
        dw = torch.zeros_like(dw)
    return dx, dw


def failed_check(run, fault) -> str:
    """The message of the chip_smoke check that ``run`` fails under
    ``fault``, or '' when it passes."""
    try:
        with fault():
            run()
    except RuntimeError as e:
        if "chip_smoke check failed" not in str(e):
            raise
        return str(e)
    return ""


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_faults: no CUDA device", file=sys.stderr)
        return 1
    smoke.start()
    rng = np.random.default_rng(smoke.SEED)
    train = conv_train._Conv3x3Train
    cases = [
        ("serving", "K4 output x1.01 (every launch)",
         lambda: planted(conv, "conv3x3_bn_relu", k4_gain)),
        ("serving", "K3 unpool at the neighbouring pixel",
         lambda: planted(SegNet, "_pools", unpool_to_neighbour)),
        ("training", "K2 pool backward at a wrong phase",
         lambda: planted(fused_pool._PoolPhaseTrain, "backward",
                         staticmethod(pool_backward_wrong_phase))),
        ("training", "K2 unpool backward (gather) at a wrong phase",
         lambda: planted(fused_pool._UnpoolPhaseTrain, "backward",
                         staticmethod(unpool_backward_wrong_phase))),
        ("training", f"K1 dW zeroed on one leaf (call {ZEROED_DW_CALL})",
         lambda: planted(train, "backward", staticmethod(zero_one_dw))),
        ("training", "K1 forward output x1.01 (every launch)",
         lambda: planted(train, "forward", staticmethod(k1_gain))),
    ]
    ok = True
    for path in ("serving", "training"):
        gen = torch.Generator().manual_seed(smoke.SEED)
        if path == "serving":
            model = bench.he_model("segnet", gen).cuda().eval()
            model.prepare(torch.bfloat16)
            x = torch.from_numpy(rng.integers(
                0, 256, (smoke.BATCH,) + smoke.HW + (3,), dtype=np.uint8)
            ).cuda()

            def run():
                smoke.logits_parity("segnet", model, x)
        else:
            model, batch = smoke.train_setup("segnet", gen)

            def run():
                zero_one_dw.calls = 0
                smoke.train_parity("segnet", model, batch)
        print(f"{path}, sound:", flush=True)
        msg = failed_check(run, contextlib.nullcontext)
        print(f"{path}, sound: {'FAILED ' + msg if msg else 'passed'}",
              flush=True)
        ok &= not msg
        for _, what, fault in (c for c in cases if c[0] == path):
            print(f"{path}, fault: {what}", flush=True)
            msg = failed_check(run, fault)
            print(f"{path}, fault: {what}: "
                  f"{'caught: ' + msg if msg else 'NOT CAUGHT'}", flush=True)
            ok &= bool(msg)
        del model
        torch.cuda.empty_cache()
    print(smoke.card())
    print("chip_faults: " + ("every fault caught, sound runs pass" if ok
                             else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
