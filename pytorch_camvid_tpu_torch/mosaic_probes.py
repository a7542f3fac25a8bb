"""Layout probes on one CUDA card: counterpart of ``tools/mosaic_probes.py``.

    python -m pytorch_camvid_tpu_torch.mosaic_probes [--device cuda|cpu]

The JAX tool asked the TPU's compiler which layouts of a staged tile
compile and run correctly at offsets that are not aligned. This tool asks
the H100 the same questions through the hand-written kernels of
``ops/layout_probes.py``: a static slice of rows 1..32 (f32 and bf16), a
slice at an offset read from device memory, that slice feeding the tensor
cores, a roll of the rows (f32 and bf16), and three bulk async copies from
one array at width offsets 0, 1 and 2. Same inputs as the tool (numpy
``default_rng`` 0, 1 and 2), same order, same labels and the same numpy
expectations and tolerances.

It prints ``<label>: OK`` or ``FAIL (...)`` per probe, then one JSON line of
the tool's seven result keys. On the card each line also gives the kernel's
max |error| against the expectation and its time over ``ITERS`` launches
after a warm-up, as ``perf_probe.time_op`` takes it: the device's busy time
(torch.profiler) and, beside it, CUDA events around the launches. At these
shapes the events measure the host's launch path, not the kernel.
``--device cpu`` (the tool's ``--interpret``) runs the plain versions.
Unlike the tool, any FAIL makes the exit code 1; without a card the default
device exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from pytorch_camvid_tpu_torch import perf_probe
from pytorch_camvid_tpu_torch.ops import layout_probes as lp

ROWS, COLS, N = 64, 256, 32
DYN_START = 3
D_SHAPE = (16, 48, 128)   # xp of probe D: (h, w + 8, c)
D_W = 40
ITERS = 20
M4_TOL = {"rtol": 1e-3, "atol": 5e-2}   # the tool's, against the f32 product

# (result key, label, wrapper) in the tool's order
PROBES = (
    ("A_static_unaligned_sublane_slice_f32",
     "A  static unaligned sublane slice (f32)", lp.row_slice),
    ("A_static_unaligned_sublane_slice_bf16",
     "A16 static unaligned sublane slice (bf16)", lp.row_slice),
    ("B_dynamic_unaligned_sublane_slice",
     "B  dynamic (pl.ds) unaligned sublane slice", lp.row_slice_dynamic),
    ("B_unaligned_slice_to_mxu",
     "Bmm unaligned slice feeding MXU", lp.row_slice_matmul),
    ("C_roll_sublane_f32", "C  pltpu.roll sublane (f32)", lp.roll_rows),
    ("C_roll_sublane_bf16", "C16 pltpu.roll sublane (bf16)", lp.roll_rows),
    ("D_three_dmas_width_offsets", "D  3 DMAs from one padded HBM array",
     lp.sum_width_shifts),
)


def inputs(device="cpu") -> Dict[str, torch.Tensor]:
    """The tool's inputs, made with numpy and moved to ``device``."""
    x32 = np.random.default_rng(0).normal(size=(ROWS, COLS)).astype(
        np.float32)
    w = np.random.default_rng(1).normal(size=(COLS, 128)).astype(np.float32)
    xp = np.random.default_rng(2).normal(size=D_SHAPE).astype(np.float32)
    t = {"x32": torch.from_numpy(x32), "w": torch.from_numpy(w),
         "xp": torch.from_numpy(xp),
         "s": torch.tensor([DYN_START], dtype=torch.int32)}
    t["x16"] = t["x32"].to(torch.bfloat16)
    return {k: v.to(device) for k, v in t.items()}


def probes(t: Dict[str, torch.Tensor]) -> Dict[str, Callable]:
    """{result key: the probe's call on the inputs ``t``}."""
    return {
        PROBES[0][0]: lambda: lp.row_slice(t["x32"], 1, N),
        PROBES[1][0]: lambda: lp.row_slice(t["x16"], 1, N),
        PROBES[2][0]: lambda: lp.row_slice_dynamic(t["x32"], t["s"], N),
        PROBES[3][0]: lambda: lp.row_slice_matmul(t["x32"], t["w"], 1, N),
        PROBES[4][0]: lambda: lp.roll_rows(t["x32"], 1),
        PROBES[5][0]: lambda: lp.roll_rows(t["x16"], 1),
        PROBES[6][0]: lambda: lp.sum_width_shifts(t["xp"], D_W),
    }


def expectations(t: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    """{result key: (numpy expectation, assert_allclose keywords)}, as the
    tool computes them."""
    x32, x16 = t["x32"].cpu().numpy(), t["x16"].float().cpu().numpy()
    w, xp = t["w"].cpu().numpy(), t["xp"].cpu().numpy()
    return {
        PROBES[0][0]: (x32[1:1 + N], {}),
        PROBES[1][0]: (x16[1:1 + N], {}),
        PROBES[2][0]: (x32[DYN_START:DYN_START + N], {}),
        PROBES[3][0]: (x32[1:1 + N] @ w, M4_TOL),
        PROBES[4][0]: (np.roll(x32, 1, 0), {}),
        PROBES[5][0]: (np.roll(x16, 1, 0), {}),
        PROBES[6][0]: (xp[:, 0:D_W] + xp[:, 1:D_W + 1] + xp[:, 2:D_W + 2],
                       {"rtol": 1e-6}),
    }


def calls_per_probe(device) -> int:
    """Launches of a probe's kernel in one run: the checked call, then on
    the card the timing's warm-up and timed calls."""
    on_card = torch.device(device).type == "cuda"
    return 1 + (perf_probe.WARMUP + ITERS if on_card else 0)


def run(device, records: Optional[List[dict]] = None) -> Dict[str, bool]:
    """Runs the seven probes in the tool's order on ``device`` and prints
    one line each; returns {result key: OK}. ``records`` receives per probe
    {key, ok, max_abs_err, ms (device busy), ms_gross (CUDA events),
    launches}; the times are None off the card, they and the error None
    after a failure."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    t = inputs(dev)
    calls, want = probes(t), expectations(t)
    results = {}
    for key, label, wrapper in PROBES:
        before = wrapper.launches
        rec = {"key": key, "ok": False, "max_abs_err": None, "ms": None,
               "ms_gross": None}
        try:
            out = calls[key]()
            got = out.float().cpu().numpy()
            expected, tol = want[key]
            np.testing.assert_allclose(got, expected, **tol)
            rec["ok"] = True
            rec["max_abs_err"] = float(np.abs(got - expected).max())
            if on_card:
                rec["ms_gross"], rec["ms"] = perf_probe.time_op(
                    calls[key], ITERS, dev)
            detail = (f" (max|err| {rec['max_abs_err']:.3g}, kernel "
                      f"{rec['ms']:.5f} ms on the device, "
                      f"{rec['ms_gross']:.5f} ms by events)"
                      if on_card else "")
            print(f"{label}: OK{detail}", flush=True)
        except Exception as e:   # the tool's report: one line per probe
            msg = str(e).strip().split("\n")[0][:160]
            print(f"{label}: FAIL ({type(e).__name__}: {msg})", flush=True)
        rec["launches"] = wrapper.launches - before
        results[key] = rec["ok"]
        if records is not None:
            records.append(rec)
    return results


def main(argv=None, records: Optional[List[dict]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pytorch_camvid_tpu_torch.mosaic_probes")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu "
                         "(the plain versions)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("mosaic_probes: no CUDA device (pass --device cpu to run the "
              "plain versions on the host)", file=sys.stderr)
        return 1
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    results = run(dev, records)
    print(json.dumps(results), flush=True)
    return 0 if all(results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
