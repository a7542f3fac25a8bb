"""NumPy-surface metrics mirroring utils.py:162-228 for API parity.

The on-device path (ops/metrics.py) is the production implementation; these
host-side functions keep the reference's exact call signature
``mean_iou(results, gt_seg_maps, num_classes, ignore_index, nan_to_num)``
returning (all_acc, per-class acc, per-class iou). The deprecated np.float
usage (utils.py:210-213) is fixed to float64.

A copy of pytorch_camvid_tpu/utils/metrics_np.py, which the port cannot import
(the JAX package's ``utils`` pulls in jax)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def intersect_and_union(pred_label: np.ndarray, label: np.ndarray,
                        num_classes: int, ignore_index: int):
    """Histogram intersection/union of one image pair (utils.py:162-190)."""
    mask = label != ignore_index
    pred_label = pred_label[mask]
    label = label[mask]

    intersect = pred_label[pred_label == label]
    area_intersect, _ = np.histogram(intersect,
                                     bins=np.arange(num_classes + 1))
    area_pred_label, _ = np.histogram(pred_label,
                                      bins=np.arange(num_classes + 1))
    area_label, _ = np.histogram(label, bins=np.arange(num_classes + 1))
    area_union = area_pred_label + area_label - area_intersect
    return area_intersect, area_union, area_pred_label, area_label


def mean_iou(results, gt_seg_maps, num_classes: int, ignore_index: int,
             nan_to_num: Optional[float] = None):
    """Accumulate over images; returns (all_acc, acc, iou)
    (utils.py:193-228)."""
    num_imgs = len(results)
    assert len(gt_seg_maps) == num_imgs
    total = [np.zeros((num_classes,), dtype=np.float64) for _ in range(4)]
    for i in range(num_imgs):
        areas = intersect_and_union(np.asarray(results[i]),
                                    np.asarray(gt_seg_maps[i]),
                                    num_classes, ignore_index)
        for t, a in zip(total, areas):
            t += a
    t_int, t_union, t_pred, t_label = total
    with np.errstate(divide="ignore", invalid="ignore"):
        all_acc = t_int.sum() / t_label.sum()
        acc = t_int / t_label
        iou = t_int / t_union
    if nan_to_num is not None:
        return all_acc, np.nan_to_num(acc, nan=nan_to_num), \
            np.nan_to_num(iou, nan=nan_to_num)
    return all_acc, acc, iou
