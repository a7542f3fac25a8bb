"""Dataset statistics CLI (counterpart of the JAX package's
tools/compute_stats.py; reference utils.compute_mean_and_std,
utils.py:50-93, the helper that produced conf/settings.py's MEAN/STD):

    python -m pytorch_camvid_tpu_torch.compute_stats [-data data]
        [-dataset camvid|voc2012]

Prints the per-channel BGR mean and std in [0, 1] over the train split's
packed cache (``utils/stats.py``): CamVid at its native size, VOC at the
reader's default 480x360, as the JAX tool reads them.
"""

from __future__ import annotations

import argparse
import sys

from pytorch_camvid_tpu_torch.utils.stats import compute_mean_and_std


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_camvid_tpu_torch.compute_stats")
    p.add_argument("-data", type=str, default="data")
    p.add_argument("-dataset", type=str, default="camvid",
                   choices=["camvid", "voc2012"])
    return p


def main(argv=None):
    """Print and return (mean, std)."""
    args = parser().parse_args(argv)
    if args.dataset == "camvid":
        from pytorch_camvid_tpu_torch.data.camvid import CamVid
        ds = CamVid(args.data, image_set="train", image_size=None)
    else:
        from pytorch_camvid_tpu_torch.data.voc2012 import VOC2012Aug
        ds = VOC2012Aug(args.data, image_set="train")
    mean, std = compute_mean_and_std(ds.images)
    print(f"MEAN = {tuple(mean)}")
    print(f"STD = {tuple(std)}")
    return mean, std


if __name__ == "__main__":
    main()
    sys.exit(0)
