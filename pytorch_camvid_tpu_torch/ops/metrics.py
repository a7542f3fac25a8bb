"""Segmentation metrics from one confusion matrix (counterpart of
pytorch_camvid_tpu/ops/metrics.py).

The C x C confusion matrix (rows ground truth, columns prediction) is
reduced on the device; IoU, accuracy, precision and recall derive from it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def confusion_matrix(preds: torch.Tensor, labels: torch.Tensor,
                     num_classes: int,
                     ignore_index: Optional[int] = None) -> torch.Tensor:
    """C x C f32 matrix. Pixels whose label lies outside [0, C) (the 255
    pad sentinel) or equals ``ignore_index`` are dropped."""
    p = preds.reshape(-1).long()
    lb = labels.reshape(-1).long()
    valid = (lb >= 0) & (lb < num_classes)
    if ignore_index is not None:
        valid &= lb != ignore_index
    flat = torch.where(valid, lb * num_classes + p,
                       torch.full_like(lb, num_classes * num_classes))
    cm = torch.bincount(flat, minlength=num_classes * num_classes + 1)
    return cm[:-1].reshape(num_classes, num_classes).float()


def intersect_and_union_areas(cm: torch.Tensor):
    """(intersect, union, pred_area, label_area) per class."""
    intersect = torch.diagonal(cm)
    pred_area = cm.sum(dim=0)
    label_area = cm.sum(dim=1)
    return intersect, pred_area + label_area - intersect, pred_area, \
        label_area


def iou_from_confusion(cm: torch.Tensor) -> torch.Tensor:
    """Per-class IoU = diag / (row + col - diag)."""
    inter, union, _, _ = intersect_and_union_areas(cm)
    return inter / union


def accuracy_from_confusion(cm: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(overall accuracy, per-class accuracy)."""
    inter, _, _, label_area = intersect_and_union_areas(cm)
    return inter.sum() / label_area.sum(), inter / label_area


def precision_recall_from_confusion(cm: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class (precision, recall)."""
    inter, _, pred_area, label_area = intersect_and_union_areas(cm)
    return inter / pred_area, inter / label_area
