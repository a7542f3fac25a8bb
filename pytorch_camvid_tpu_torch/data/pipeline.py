"""Input pipeline: the dataset lives on the device as uint8 (counterpart of
pytorch_camvid_tpu/data/pipeline.py:27-140, one device).

CamVid at 360x480 is ~250 MB of uint8 images and masks. It is copied to the
device once; each step gathers its batch there by index, and the
augmentation makes the normalized tensors on the device. The host only
advances the epoch's index permutation, the same numpy permutation as the
JAX package's (``default_rng(seed + epoch)``), so both take the same
samples in the same batches.

Not ported: the data-parallel sharding, ``pad_to_batch`` (the
multi-process eval's; one device runs a ragged last batch as it is) and the
host-streamed ``HostLoader`` (ROADMAP.md).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch


class DeviceDataLoader:
    """Yields (images_u8 (B,H,W,3), labels_u8 (B,H,W)) tensors gathered on
    ``device`` from resident copies of the arrays. With drop_last=False the
    last batch may be smaller, like the reference DataLoader's."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, device="cuda"):
        self.images = torch.from_numpy(np.ascontiguousarray(images)).to(
            device)
        self.labels = torch.from_numpy(np.ascontiguousarray(labels)).to(
            device)
        self.n = images.shape[0]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def _permutation(self, epoch: Optional[int]) -> np.ndarray:
        e = self._epoch if epoch is None else epoch
        self._epoch = e + 1
        if self.shuffle:
            return np.random.default_rng(self.seed + e).permutation(self.n)
        return np.arange(self.n)

    def gather(self, idx) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batch at sample indices ``idx``, gathered on the device."""
        i = torch.as_tensor(np.asarray(idx), dtype=torch.long).to(
            self.images.device, non_blocking=True)
        return (self.images.index_select(0, i),
                self.labels.index_select(0, i))

    def epoch(self, epoch: Optional[int] = None) -> Iterator[Tuple]:
        perm = self._permutation(epoch)
        b = self.batch_size
        stop = self.n - self.n % b if self.drop_last else self.n
        for i in range(0, stop, b):
            yield self.gather(perm[i: i + b])

    def epoch_indices(self, epoch: Optional[int] = None) -> np.ndarray:
        """The epoch's batch-index plan as a (steps, batch) int array, the
        permutation ``epoch()`` would consume; full batches only."""
        perm = self._permutation(epoch)
        steps = self.n // self.batch_size
        return perm[: steps * self.batch_size].reshape(
            steps, self.batch_size)

    def __iter__(self):
        return self.epoch()
