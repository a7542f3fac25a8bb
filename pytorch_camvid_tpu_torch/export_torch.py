"""Export a checkpoint as a reference-compatible torch ``.pth``
(counterpart of tools/export_torch.py).

Usage:
    python -m pytorch_camvid_tpu_torch.export_torch \
        -weight checkpoints/<run>/60-best.ckpt.npz -net unet -out 60-best.pth

Reads any checkpoint the port reads (``train/checkpoint.py::load_weights``:
a ``.ckpt.npz`` of either package, or a ``.pth``) and writes
``torch.save`` of its reference-named state_dict, which the reference's own
model classes (and the port's) load with ``strict=True``. The port keeps
the reference's names, so this is the identity on the weights: the JAX
tool's layout conversion happens in ``load_weights``. ``-num_classes`` is
checked against the checkpoint's head.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-weight", type=str, required=True,
                    help="checkpoint (.ckpt.npz of either package, or .pth)")
    ap.add_argument("-net", type=str, default="unet",
                    help="network name (unet | segnet)")
    ap.add_argument("-out", type=str, required=True,
                    help="output .pth path")
    ap.add_argument("-num_classes", type=int, default=12)
    args = ap.parse_args(argv)

    import torch

    from pytorch_camvid_tpu_torch.models import spec_from_state_dict
    from pytorch_camvid_tpu_torch.train.checkpoint import (load_weights,
                                                           read_meta)

    sd = load_weights(args.weight, args.net)
    classes = spec_from_state_dict(args.net, sd)[-1][1][-1][1]
    if classes != args.num_classes:
        raise SystemExit(f"the checkpoint's head has {classes} classes, not "
                         f"-num_classes {args.num_classes}")
    torch.save({k: v.contiguous() for k, v in sd.items()}, args.out)
    meta = read_meta(args.weight)
    print(f"wrote {args.out} ({len(sd)} tensors, epoch "
          f"{meta.get('epoch', '?')}, miou {meta.get('miou', '?')}) — "
          f"loads strictly into the reference {args.net} class")


if __name__ == "__main__":
    main()
