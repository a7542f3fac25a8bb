"""Input pipeline (counterpart of pytorch_camvid_tpu/data/pipeline.py, one
device).

``DeviceDataLoader``: the dataset lives on the device as uint8. CamVid at
360x480 is ~250 MB of images and masks, VOC's trainaug split ~7.3 GB; it
is copied to the device once, each step gathers its batch there by index,
and the augmentation makes the normalized tensors on the device. The host
only advances the epoch's index permutation, the same numpy permutation as
the JAX package's (``default_rng(seed + epoch)``), so both take the same
samples in the same batches.

``HostLoader``: the arrays stay on the host, for data larger than the
device holds (``-loader host``). The native threaded gather
(``data/native.py``) fills one of two pinned staging buffers, a side copy
stream copies it to the device, and an event on that stream fences the
batch for the compute stream; the loop names the next batch one step
ahead (``prefetch``), so its gather and copy run while the device runs the
current step.

Both loaders have ``epoch_indices(e)`` and ``gather(idx)`` (the training
loop's), ``prefetch(idx)`` and ``epoch(e)`` (the eval pass's).

Data parallelism (``mesh=``, a ``parallel/mesh.py::Mesh`` of more than one
rank): every rank keeps the whole split (the JAX package's dataset
replication) and computes the same permutation from the seed; ``gather``
and ``prefetch`` take the global batch's indices and fetch only the rank's
rows (``mesh.rows``). ``pad_to_batch`` (the multi-rank eval's) pads the
split to a multiple of the batch with rows labelled ``pad_label`` (255),
which the eval loss and the confusion matrix drop, so every eval batch
splits evenly over the ranks.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from pytorch_camvid_tpu_torch.data import native


class _EpochPlan:
    """What both loaders share: the epoch's permutation (the JAX package's
    ``default_rng(seed + epoch)``), ``len`` and the ``drop_last`` rule, and
    the epoch's batches in the loop's order: ``gather(t)``, then
    ``prefetch(t + 1)`` (a no-op where the data is on the device)."""

    def __init__(self, n: int, batch_size: int, shuffle: bool, seed: int,
                 drop_last: bool, mesh=None):
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        self._epoch = 0

    def _local(self, idx) -> np.ndarray:
        """The rank's share of a global batch's indices."""
        idx = np.asarray(idx)
        return idx if self.mesh is None else idx[self.mesh.rows(len(idx))]

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

    def epoch_indices(self, epoch: Optional[int] = None) -> np.ndarray:
        """The epoch's batch-index plan as a (steps, batch) int array, the
        permutation ``epoch()`` would consume; full batches only."""
        perm = self._permutation(epoch)
        steps = self.n // self.batch_size
        return perm[: steps * self.batch_size].reshape(
            steps, self.batch_size)

    def prefetch(self, idx) -> None:
        """Start staging the batch at ``idx``; the loop calls it one step
        ahead. Nothing to stage here."""

    def gather(self, idx) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def epoch(self, epoch: Optional[int] = None) -> Iterator[Tuple]:
        perm = self._permutation(epoch)
        b = self.batch_size
        stop = self.n - self.n % b if self.drop_last else self.n
        for lo in range(0, stop, b):
            batch = self.gather(perm[lo: lo + b])
            if lo + b < stop:
                self.prefetch(perm[lo + b: lo + 2 * b])
            yield batch

    def __iter__(self):
        return self.epoch()


def padded_to_batch(images: np.ndarray, labels: np.ndarray,
                    batch_size: int, pad_label: int = 255
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The split padded to a multiple of ``batch_size`` with zero images
    labelled ``pad_label``."""
    pad = (-images.shape[0]) % batch_size
    if not pad:
        return images, labels
    return (np.concatenate([images, np.zeros((pad,) + images.shape[1:],
                                             images.dtype)]),
            np.concatenate([labels, np.full((pad,) + labels.shape[1:],
                                            pad_label, labels.dtype)]))


class DeviceDataLoader(_EpochPlan):
    """Yields (images_u8 (B,H,W,3), labels_u8 (B,H,W)) tensors gathered on
    ``device`` from resident copies of the arrays (the rank's rows of each
    batch under a ``mesh``). With drop_last=False the last batch may be
    smaller, like the reference DataLoader's, unless ``pad_to_batch``."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, device="cuda", mesh=None,
                 pad_to_batch: bool = False, pad_label: int = 255):
        if pad_to_batch:
            images, labels = padded_to_batch(images, labels, batch_size,
                                             pad_label)
        super().__init__(images.shape[0], batch_size, shuffle, seed,
                         drop_last, mesh)
        self.images = torch.from_numpy(np.ascontiguousarray(images)).to(
            device)
        self.labels = torch.from_numpy(np.ascontiguousarray(labels)).to(
            device)

    def gather(self, idx) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batch at sample indices ``idx`` (the rank's rows of it),
        gathered on the device."""
        i = torch.as_tensor(self._local(idx), dtype=torch.long).to(
            self.images.device, non_blocking=True)
        return (self.images.index_select(0, i),
                self.labels.index_select(0, i))


class _Staged:
    """A batch on its way to the device: its indices, its device tensors
    and the copy stream's event after their copies (None on the CPU)."""

    def __init__(self, idx: np.ndarray, images, labels, ready=None):
        self.idx, self.images, self.labels, self.ready = \
            idx, images, labels, ready


class HostLoader(_EpochPlan):
    """Host-resident arrays streamed to ``device`` a batch at a time
    (counterpart of the JAX package's ``HostLoader``): the same epoch
    plan, batches and bytes as ``DeviceDataLoader``.

    On CUDA: ``prefetch(idx)`` gathers the batch with the native gather
    into the next of two pinned staging buffers (first waiting for that
    buffer's previous copy to have landed), allocates the device batch on
    the copy stream, copies with ``non_blocking=True`` there and records
    an event; ``gather(idx)`` makes the compute stream wait on that event
    and marks the tensors as used by it (``record_stream``), so the caching
    allocator hands their memory back only after the compute stream is
    done with them. A ``gather`` of indices not staged stages them first.
    On the CPU the batch is gathered into new arrays.

    ``native`` says whether the native library runs (built here, at the
    loader's construction, so no batch waits for the compiler);
    ``gathers`` counts the gathers, ``native_gathers`` those that ran the
    native library, ``gather_s`` their host seconds. Under a ``mesh`` only
    the rank's rows of each batch are gathered and copied."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, device="cuda", mesh=None,
                 pad_to_batch: bool = False, pad_label: int = 255):
        if pad_to_batch:
            images, labels = padded_to_batch(images, labels, batch_size,
                                             pad_label)
        super().__init__(images.shape[0], batch_size, shuffle, seed,
                         drop_last, mesh)
        self.images = np.ascontiguousarray(images)
        self.labels = np.ascontiguousarray(labels)
        self.device = torch.device(device)
        self.native = native.native_available()
        self._staged = []
        self.gathers = self.native_gathers = 0
        self.gather_s = 0.0
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._slots = [tuple(torch.empty(
                (batch_size,) + a.shape[1:], dtype=torch.uint8,
                pin_memory=True) for a in (self.images, self.labels))
                for _ in range(2)]
            self._slot_free = [None, None]   # events: the slot's copy done
            self._next_slot = 0

    def _host_gather(self, idx: np.ndarray, out_images=None,
                     out_labels=None):
        t0 = time.perf_counter()
        im = native.gather_batch(self.images, idx, out_images)
        lb = native.gather_batch(self.labels, idx, out_labels)
        self.gather_s += time.perf_counter() - t0
        self.gathers += 1
        self.native_gathers += self.native
        return im, lb

    def prefetch(self, idx) -> None:
        """Start staging the batch at ``idx`` (the loop calls this one
        step ahead)."""
        self._stage(self._local(idx))

    def _stage(self, idx: np.ndarray) -> None:
        if self.device.type != "cuda":
            im, lb = self._host_gather(idx)
            self._staged.append(_Staged(idx, torch.from_numpy(im),
                                        torch.from_numpy(lb)))
            return
        k = self._next_slot
        self._next_slot ^= 1
        if self._slot_free[k] is not None:
            self._slot_free[k].synchronize()   # its last copy has landed
        pin_im, pin_lb = (t[: len(idx)] for t in self._slots[k])
        self._host_gather(idx, pin_im.numpy(), pin_lb.numpy())
        with torch.cuda.stream(self._stream):
            im = torch.empty(pin_im.shape, dtype=torch.uint8,
                             device=self.device)
            lb = torch.empty(pin_lb.shape, dtype=torch.uint8,
                             device=self.device)
            im.copy_(pin_im, non_blocking=True)
            lb.copy_(pin_lb, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        self._slot_free[k] = ready
        self._staged.append(_Staged(idx, im, lb, ready))

    def gather(self, idx) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batch at ``idx`` on the device, ready for the compute
        stream: the one ``prefetch`` staged, else staged now."""
        idx = self._local(idx)
        while self._staged and not np.array_equal(self._staged[0].idx, idx):
            self._staged.pop(0)   # staged for a plan that changed
        if not self._staged:
            self._stage(idx)
        b = self._staged.pop(0)
        if b.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(b.ready)
            b.images.record_stream(stream)
            b.labels.record_stream(stream)
        return b.images, b.labels
