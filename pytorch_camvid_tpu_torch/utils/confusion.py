"""Running confusion-matrix metrics accumulator (counterpart of
pytorch_camvid_tpu/utils/confusion.py; reference legacy/metrics.py Metrics
class, consumed by eval.py:40-72).

Same API surface: add(preds, gts), precision(), recall(), iou(), clear().
The matrix update is the port's on-device bincount (ops/metrics.py); the
matrix is kept on the host in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_camvid_tpu_torch.ops.metrics import (
    confusion_matrix, iou_from_confusion, precision_recall_from_confusion)


class Metrics:
    def __init__(self, class_num: int, ignore_index: int | None = None):
        self.class_num = class_num
        self.ignore_index = ignore_index
        self._cm = np.zeros((class_num, class_num), np.float64)

    def add(self, preds, gts):
        """Accumulate a batch (legacy/metrics.py:20-30). Ignored labels are
        dropped at accumulation time; the reductions below then match the
        legacy ones, which mask the ignore class out when reducing."""
        cm = confusion_matrix(torch.as_tensor(preds), torch.as_tensor(gts),
                              self.class_num, self.ignore_index)
        self._cm += cm.double().cpu().numpy()

    def clear(self):
        """Reset the accumulated matrix (legacy/metrics.py:32)."""
        self._cm[:] = 0

    def _keep(self):
        return [i for i in range(self.class_num) if i != self.ignore_index]

    def _reduce(self, per_class: torch.Tensor, average: bool):
        v = per_class.numpy()[self._keep()]
        return float(np.nanmean(v)) if average else v

    def precision(self, average: bool = True):
        p, _ = precision_recall_from_confusion(torch.from_numpy(self._cm))
        return self._reduce(p, average)

    def recall(self, average: bool = True):
        _, r = precision_recall_from_confusion(torch.from_numpy(self._cm))
        return self._reduce(r, average)

    def iou(self, average: bool = True):
        return self._reduce(iou_from_confusion(torch.from_numpy(self._cm)),
                            average)

    @property
    def matrix(self) -> np.ndarray:
        return self._cm.copy()
