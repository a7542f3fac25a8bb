"""Train-throughput batch-size sweep on one CUDA card (counterpart of the
JAX package's ``tools/batch_sweep.py``):

    python -m pytorch_camvid_tpu_torch.batch_sweep -net unet
        [-batches 16 24 32 48] [-steps 60] [-remat] [-out rows.jsonl]
        [-device cuda]

``bench.measure_train`` (bf16, 360x480, ``bench.he_model``'s weights from
seed 0) at each batch size, so the bench's one batch sits on a measured
curve. One JSON row per (net, batch) to stdout and, with ``-out``, appended
to a JSONL file; each row has the card's name and power limit (``card``).
A (net, batch, remat) already recorded in ``-out`` without an error is
skipped. An out-of-memory error is caught and recorded as a row with
``error`` (the memory ceiling is part of the curve), and the allocator's
cache is emptied before the next batch. ``-remat`` recomputes each stage in
the backward: for batches past the plain step's memory ceiling.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

import torch

from pytorch_camvid_tpu_torch import bench


def recorded(path) -> set:
    """(net, batch_size, remat) of the rows in ``path`` without an error
    (failed rows may be retried)."""
    done = set()
    if path and os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except ValueError:
                    continue
                if "error" not in r:
                    done.add((r["net"], r["batch_size"],
                              r.get("remat", False)))
    return done


def measure_row(net: str, batch_size: int, steps: int, remat: bool,
                device: str) -> dict:
    """``measure_train`` of ``he_model(net)`` at ``batch_size`` (losses
    left out)."""
    dev = torch.device(device)
    model = bench.he_model(net, torch.Generator().manual_seed(0)).to(dev)
    r = bench.measure_train(model, batch_size, steps, remat=remat)
    r.pop("losses")
    return r


def main(argv=None) -> list:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_camvid_tpu_torch.batch_sweep")
    p.add_argument("-net", type=str, default="unet")
    p.add_argument("-batches", type=int, nargs="+",
                   default=[16, 24, 32, 48])
    p.add_argument("-steps", type=int, default=60)
    p.add_argument("-remat", action="store_true", default=False,
                   help="stage rematerialization: for batches past the "
                   "plain step's memory ceiling")
    p.add_argument("-out", type=str, default=None,
                   help="JSONL file to append rows to")
    p.add_argument("-device", type=str, default="cuda",
                   help="the CUDA device to measure (default cuda)")
    args = p.parse_args(argv)
    if torch.device(args.device).type != "cuda":
        raise ValueError(f"batch_sweep measures a CUDA device, not "
                         f"{args.device}")
    if not torch.cuda.is_available():
        raise RuntimeError("batch_sweep: no CUDA device is available")
    card = bench.card(torch.device(args.device).index or 0)

    done = recorded(args.out)
    rows = []
    for b in args.batches:
        if (args.net, b, args.remat) in done:
            print(json.dumps({"net": args.net, "batch_size": b,
                              "remat": args.remat,
                              "skipped": "already recorded"}), flush=True)
            continue
        row = {"net": args.net, "batch_size": b, "steps": args.steps,
               "remat": args.remat, "card": card}
        try:
            row.update(measure_row(args.net, b, args.steps, args.remat,
                                   args.device))
        except torch.cuda.OutOfMemoryError as e:
            row["error"] = f"{type(e).__name__}: {e}"[:1000]
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        rows.append(row)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()
    sys.exit(0)
