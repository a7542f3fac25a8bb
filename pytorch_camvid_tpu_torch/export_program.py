"""Export a trained checkpoint as a self-contained serving program
(counterpart of tools/export_stablehlo.py).

Usage:
    python -m pytorch_camvid_tpu_torch.export_program \
        -weight checkpoints/<run>/60-best.ckpt.npz -net unet -b 8 \
        -out unet.pt2 [-image_size 480 360] [-num_classes 12] \
        [-device cuda] [-no_verify]

The program (``serving.Predictor.export_program``, ``torch.export``) holds
the weights and has the fixed serving signature uint8 (B, H, W, 3) BGR ->
uint8 (B, H, W) class map, with the normalization and bf16 compute inside.
``pytorch_camvid_tpu_torch.ops.library.load_program(path, device)`` loads
it with no model code and no checkpoint machinery. Its kernel calls are
the ``camvid::`` ops, so one file runs the hand-written kernels on the card
and their plain versions on the CPU: ``-device`` (``cuda`` by default,
``cpu`` when asked) is where the Predictor is built and the program
traced, in place of the JAX tool's ``-platforms``. Takes a ``.ckpt.npz`` of
either package or a reference ``.pth``.

The verify pass (skipped by ``-no_verify``) loads the file back in this
process, runs it on a random batch from seed 0 and compares its class maps
with the live Predictor's; fewer than 99% equal pixels fails, as in the
JAX tool.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-weight", type=str, required=True,
                    help="checkpoint (.ckpt.npz or reference .pth)")
    ap.add_argument("-net", type=str, default="unet")
    ap.add_argument("-b", type=int, default=8, help="exported batch size")
    ap.add_argument("-image_size", type=int, nargs=2, default=(480, 360),
                    metavar=("W", "H"),
                    help="working size, cv2 (W, H) order like the reference")
    ap.add_argument("-num_classes", type=int, default=12)
    ap.add_argument("-out", type=str, required=True)
    ap.add_argument("-device", type=str, default="cuda",
                    help="torch device the program is traced and verified "
                         "on (the file runs on either)")
    ap.add_argument("-no_verify", action="store_true",
                    help="skip the load-and-compare pass")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from pytorch_camvid_tpu_torch.ops.library import load_program
    from pytorch_camvid_tpu_torch.serving import Predictor

    w, h = args.image_size
    with Predictor.from_checkpoint(
            args.net, args.weight, batch_size=args.b, image_hw=(h, w),
            num_classes=args.num_classes, device=args.device) as pred:
        pred.export_program(args.out)
        size_mb = os.path.getsize(args.out) / 1e6
        line = (f"wrote {args.out} ({size_mb:.1f} MB, device "
                f"[{pred.device}], signature uint8[{args.b},{h},{w},3] -> "
                f"uint8[{args.b},{h},{w}])")
        if args.no_verify:
            print(line)
            return

        program = load_program(args.out, pred.device)
        rng = np.random.default_rng(0)
        images = rng.integers(0, 256, (args.b, h, w, 3), dtype=np.uint8)
        with torch.inference_mode():
            got = program(torch.from_numpy(images).to(pred.device))
        got = got.cpu().numpy()
        want = pred.predict(images)
    agree = float((got == want).mean())
    if agree < 0.99:
        raise SystemExit(f"roundtrip mismatch: the loaded program agrees "
                         f"on only {100 * agree:.2f}% of pixels")
    print(f"{line} — roundtrip verified against the live predictor "
          f"({100 * agree:.2f}% pixel agreement)")


if __name__ == "__main__":
    main()
