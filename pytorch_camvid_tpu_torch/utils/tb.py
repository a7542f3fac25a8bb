"""TensorBoard logging (counterpart of pytorch_camvid_tpu/utils/tb.py;
reference utils.py:10-48 + train.py TB calls).

Writes the same scalar tags as the JAX package (Train/LearningRate,
Train/Beta1, Test/mIOU, Test/Acc, Test/Loss,
LastLayerGradients/grad_norm2_* and parameter histograms). Falls back to a
JSONL event log, ``events.jsonl`` in the log dir, when the tensorboard
writer cannot be imported, so headless runs still record their scalars.
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterable, Tuple

import numpy as np
import torch

HIST_BUCKETS = 64


class SummaryLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._writer = None
        self._jsonl = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._jsonl = open(os.path.join(log_dir, "events.jsonl"), "a")
        else:
            self._writer = SummaryWriter(log_dir=log_dir)

    def scalar(self, tag: str, value, step: int):
        v = float(value)
        if self._writer is not None:
            self._writer.add_scalar(tag, v, step)
        else:
            self._jsonl.write(json.dumps(
                {"ts": time.time(), "tag": tag, "value": v,
                 "step": int(step)}) + "\n")
            self._jsonl.flush()

    def last_layer_grad_norms(self, norms: dict, n_iter: int):
        """utils.visulaize_lastlayer (utils.py:33-36) tag surface."""
        if "grad_norm_w" in norms:
            self.scalar("LastLayerGradients/grad_norm2_weights",
                        norms["grad_norm_w"], n_iter)
        if "grad_norm_b" in norms:
            self.scalar("LastLayerGradients/grad_norm2_bias",
                        norms["grad_norm_b"], n_iter)

    def param_histograms(self, named_params: Iterable[Tuple[str,
                                                            torch.Tensor]],
                         epoch: int):
        """utils.visualize_param_hist (utils.py:43-48): one histogram per
        parameter, from ``model.named_parameters()``. Each parameter is
        reduced on its device to ``HIST_BUCKETS`` bucket counts and its
        moments, and only those cross to the host (the JAX package's
        design: the raw parameters are ~138 MB at full width)."""
        if self._writer is None:
            return
        names, stats = [], []
        with torch.no_grad():
            for name, p in named_params:
                x = p.detach().reshape(-1).float()
                mn, mx = x.min(), x.max()
                span = torch.clamp(mx - mn, min=1e-12)
                b = torch.clamp((x - mn) / span * HIST_BUCKETS, 0.0,
                                HIST_BUCKETS - 1.0).long()
                counts = torch.bincount(b, minlength=HIST_BUCKETS).float()
                names.append((name, x.numel()))
                stats.append(torch.cat([counts, torch.stack(
                    [mn, mx, x.sum(), (x * x).sum()])]))
        if not stats:
            return
        host = torch.stack(stats).double().cpu().numpy()   # one copy
        for (name, size), row in zip(names, host):
            counts, (mn, mx, s, ss) = row[:HIST_BUCKETS], row[HIST_BUCKETS:]
            limits = np.linspace(mn, mx, HIST_BUCKETS + 1)[1:]
            self._writer.add_histogram_raw(
                name, min=float(mn), max=float(mx), num=int(size),
                sum=float(s), sum_squares=float(ss),
                bucket_limits=limits.tolist(),
                bucket_counts=counts.astype(np.int64).tolist(),
                global_step=epoch)

    def close(self):
        if self._writer is not None:
            self._writer.close()
        elif self._jsonl is not None:
            self._jsonl.close()
