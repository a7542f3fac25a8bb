"""Serving: a single-device batched predictor (counterpart of
pytorch_camvid_tpu/serving.py).

- Any number of images pads up to the fixed serving batch.
- Resize (cv2 bilinear convention) and normalization run on the device;
  compute is bf16 by default with f32 logits (``compute_dtype=
  torch.float32`` runs the f32 kernels, as the predict CLI does).
- The class map leaves the device as uint8, nibble-packed (two pixels per
  byte) when there are <= 16 classes and the width is even, and is unpacked
  on the host.
- Each chunk goes to the device from pinned memory without blocking the
  host, and its class map comes back asynchronously into pinned memory,
  finished on one drain thread, with a bounded in-flight window.
- Every conv block runs the fused Hopper kernel (ops/fused_conv.py); the BN
  fold and the kernel's weight layout are prepared once, at construction.
  SegNet's pools and unpools run K3 (ops/fused_pool.py).
- ``quantize_int8`` (post-training int8 quantization, ops/quant.py)
  calibrates on a few batches of representative images and turns the model
  into an int8 one in place: every block with 64 or more output channels
  then runs ``conv3x3_int8`` (ops/fused_conv_int8.py), the head stays on K4
  in the compute dtype, and SegNet's pools run K3 on int8 values.
- ``devices=[...]`` (the JAX Predictor's ``mesh``, ``serve -dp``): one
  replica of the model per listed device; each serving batch is split in
  order into equal parts, one a replica, and the class maps are joined in
  that order. A list may name a device twice (two replicas on one card).
  Per image the arithmetic is the one-device Predictor's, so the maps are
  the same.

- ``export_program(path)`` (JAX ``export_stablehlo``): the serving
  function as a ``torch.export`` program with the weights in it, uint8
  (B, h, w, 3) BGR in, uint8 (B, h, w) class map out, saved with
  ``torch.export.save``. Its kernel calls are the ``camvid::`` ops of
  ``ops/library.py``, so ``ops.library.load_program(path, device)`` runs it
  without this module or the model code: on the card through the
  hand-written kernels, on the CPU through their plain versions.

Not carried over from the JAX Predictor: the bucketed dynamic resize (it
bounds jit's compile cache; eager PyTorch has none, so any source size is
resized directly, with the same values).

Example:
    with Predictor.from_checkpoint("unet", "model.pth", batch_size=8) as p:
        masks = p.predict(images_uint8_bgr)   # (N, H, W) class indices
"""

from __future__ import annotations

import concurrent.futures
import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pytorch_camvid_tpu_torch.config import settings
from pytorch_camvid_tpu_torch.data.normalize import to_tensor_normalize
from pytorch_camvid_tpu_torch.models import get_model, spec_from_state_dict
from pytorch_camvid_tpu_torch.ops.quant import calibrate, quantize_model
from pytorch_camvid_tpu_torch.ops.resize import resize_bilinear_cv2
from pytorch_camvid_tpu_torch.train.checkpoint import load_weights


class ServingProgram(torch.nn.Module):
    """What ``Predictor.export_program`` traces: uint8 (B, h, w, 3) BGR ->
    ``to_tensor_normalize`` in ``dtype`` -> ``model`` (eval mode, prepared)
    -> argmax -> uint8 (B, h, w). The model is kept out of the module tree,
    so the program takes only the tensors its eval forward reads (the
    prepared or int8 tensors) and not the float parameters beside them."""

    def __init__(self, model: torch.nn.Module, mean: torch.Tensor,
                 std: torch.Tensor, dtype: torch.dtype):
        super().__init__()
        object.__setattr__(self, "model", model)   # not a submodule
        self.register_buffer("mean", mean)
        self.register_buffer("std", std)
        self.dtype = dtype

    def forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        x = to_tensor_normalize(images_u8, self.mean, self.std, self.dtype)
        return self.model(x).argmax(dim=-1).to(torch.uint8)


class Predictor:
    def __init__(self, net: str, state_dict: Dict[str, torch.Tensor],
                 batch_size: int = 8,
                 image_hw: Tuple[int, int] = (360, 480),
                 num_classes: int = settings.NUM_CLASSES,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: str = "cuda",
                 devices: Optional[Sequence[str]] = None):
        """net: "unet" or "segnet". state_dict: reference-named weights
        (``.pth`` layout); the model is built from its conv shapes, so any
        width loads. device: where the model runs; a CUDA device that is
        not there raises, nothing falls back to the CPU. devices: one
        replica per entry instead (``batch_size`` must divide over them);
        the first is ``device``."""
        self.devices = [torch.device(d) for d in (devices or [device])]
        self.device = self.devices[0]
        if any(d.type == "cuda" for d in self.devices) \
                and not torch.cuda.is_available():
            raise RuntimeError("Predictor: device 'cuda' requested but no "
                               "CUDA device is available")
        if batch_size % len(self.devices):
            raise ValueError(f"batch_size {batch_size} must divide over the "
                             f"{len(self.devices)} replicas")
        self._batch = batch_size
        self.image_hw = tuple(image_hw)  # the working size
        self._dtype = compute_dtype
        # on the device once: a per-call host copy would wait for the
        # previous forward and stall the host's run-ahead
        self._mean, self._std = (
            torch.tensor(v, dtype=torch.float32, device=self.device)
            for v in (settings.MEAN, settings.STD))
        spec = spec_from_state_dict(net, state_dict)
        if spec[-1][1][-1][1] != num_classes:
            raise ValueError(f"the checkpoint's head has "
                             f"{spec[-1][1][-1][1]} classes, not "
                             f"num_classes={num_classes}")
        model = get_model(net, spec=spec)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval().prepare(compute_dtype)
        self._replicate()
        # two class indices per byte: halves the device->host bytes
        self._pack = num_classes <= 16 and self.image_hw[1] % 2 == 0
        self._drain = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="pct-serving-drain")

    @classmethod
    def from_checkpoint(cls, net: str, weight_path: str, **kw):
        """Build from a reference ``.pth`` state_dict or a ``.ckpt.npz``
        of either package (``train/checkpoint.py::load_weights``)."""
        return cls(net, load_weights(weight_path, net), **kw)

    def _replicate(self) -> None:
        """The model on every listed device (the first is ``model``)."""
        self.replicas: List[torch.nn.Module] = [self.model] + [
            copy.deepcopy(self.model).to(d).eval().prepare(self._dtype)
            for d in self.devices[1:]]

    def close(self) -> None:
        """Join the drain thread. The Predictor cannot predict afterwards."""
        self._drain.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _normalized(self, images_u8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 BGR on the device, any H/W -> the model's
        input at the working size: resized, normalized, compute dtype."""
        x = images_u8
        if tuple(x.shape[1:3]) != self.image_hw:
            x = resize_bilinear_cv2(x.float(), self.image_hw)
            x = x.clamp(0, 255).round().to(torch.uint8)
        return to_tensor_normalize(x, self._mean, self._std, self._dtype)

    @torch.inference_mode()
    def quantize_int8(self, calib_images: np.ndarray,
                      max_batches: int = 4) -> None:
        """Post-training int8 quantization of the loaded model, in place
        (JAX ``serving.py::Predictor.quantize_int8``). calib_images: (N, H,
        W, 3) uint8 BGR representative inputs, any size (resized on the
        device as ``predict`` does). Runs at most ``max_batches``
        calibration forwards at the serving batch (a short last chunk tiled
        up to it) to record each block's input range, then replaces the
        blocks' weights by BN-folded per-channel int8 ones
        (``ops/quant.py``)."""
        if len(calib_images) == 0:
            raise ValueError("need at least one calibration image")
        batches = []
        for lo in range(0, min(len(calib_images),
                               max_batches * self._batch), self._batch):
            chunk = calib_images[lo: lo + self._batch]
            if len(chunk) < self._batch:   # tile up to the serving batch
                reps = -(-self._batch // len(chunk))
                chunk = np.concatenate([chunk] * reps)[: self._batch]
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(
                self.device)
            batches.append(self._normalized(x))
        quantize_model(self.model, calibrate(self.model, batches))
        self._replicate()

    @torch.inference_mode()
    def _forward(self, images_u8: torch.Tensor,
                 model: Optional[torch.nn.Module] = None) -> torch.Tensor:
        """One device batch: (B, H, W, 3) uint8 BGR on the device, any H/W ->
        (B, h, w) uint8 class map at the working size, nibble-packed to
        (B, h, w/2) when packing applies; on ``model`` (a replica, default
        the first)."""
        model = self.model if model is None else model
        m = model(self._normalized(images_u8)).argmax(dim=-1).to(
            torch.uint8)
        if self._pack:
            m = (m[:, :, 0::2] << 4) | m[:, :, 1::2]
        return m

    def export_program(self, path: str) -> torch.export.ExportedProgram:
        """The serving function as one program, saved to ``path`` (JAX
        ``Predictor.export_stablehlo``): uint8 (B, h, w, 3) BGR at the
        working size in, normalized in the compute dtype, the first
        replica's model, argmax, uint8 (B, h, w) class map out; no resize
        and no nibble pack. The blocks' prepared (w, A, B), or an int8
        model's int8 buffers and scales, are its constants. Exported under
        ``no_grad``; the Predictor's outputs and caches stay as they were.
        Returns the ``ExportedProgram``; ``ops.library.load_program`` loads
        the file."""
        h, w = self.image_hw
        program = ServingProgram(self.model, self._mean, self._std,
                                 self._dtype)
        example = torch.zeros((self._batch, h, w, 3), dtype=torch.uint8,
                              device=self.device)
        with torch.no_grad():
            exported = torch.export.export(program, (example,), strict=False)
        torch.export.save(exported, path)
        return exported

    def _to_host(self, parts: list, keep: int) -> np.ndarray:
        """Drain thread: wait for one chunk's copies (one a replica), join
        them, unpack the nibbles."""
        for _, done in parts:
            if done is not None:
                done.synchronize()
        a = np.concatenate([host.numpy() for host, _ in parts])[:keep]
        if self._pack:
            out = np.empty(a.shape[:2] + (a.shape[2] * 2,), np.uint8)
            out[:, :, 0::2] = a >> 4
            out[:, :, 1::2] = a & 0x0F
            a = out
        return a

    def _inflight_window(self, input_hw) -> int:
        """In-flight chunks so that chunk I/O held in flight stays near
        64 MB (input batch + packed mask batch), clamped to [2, 4]."""
        h, w = self.image_hw
        in_bytes = self._batch * int(np.prod(input_hw)) * 3
        out_bytes = self._batch * h * (w // 2 if self._pack else w)
        return max(2, min(4, int(64e6 // max(in_bytes + out_bytes, 1))))

    def predict(self, images: np.ndarray) -> np.ndarray:
        """images: (N, H, W, 3) uint8 BGR, any H/W (resized on the device).
        Returns (N, h, w) uint8 class maps at the working size."""
        if images.ndim != 4 or images.shape[3] != 3 \
                or images.dtype != np.uint8:
            raise ValueError(f"expected (N, H, W, 3) uint8 images, got "
                             f"{images.shape} {images.dtype}")
        n = images.shape[0]
        h, w = self.image_hw
        max_inflight = self._inflight_window(images.shape[1:3])
        cuda = any(d.type == "cuda" for d in self.devices)
        out, futures = [], []
        try:
            for lo in range(0, n, self._batch):
                chunk = images[lo: lo + self._batch]
                keep = len(chunk)
                if keep < self._batch:
                    chunk = np.concatenate([chunk, np.zeros(
                        (self._batch - keep,) + chunk.shape[1:], np.uint8)])
                if len(futures) >= max_inflight:
                    out.append(futures.pop(0).result())
                x = torch.from_numpy(chunk)
                if cuda:  # pinned + async: the host runs ahead of the card
                    x = x.pin_memory()
                parts = []
                for dev, model, part in zip(self.devices, self.replicas,
                                            x.chunk(len(self.replicas))):
                    m = self._forward(part.to(dev, non_blocking=True), model)
                    done = None
                    if dev.type == "cuda":
                        host = torch.empty(m.shape, dtype=torch.uint8,
                                           pin_memory=True)
                        host.copy_(m, non_blocking=True)
                        done = torch.cuda.Event()
                        done.record(torch.cuda.current_stream(dev))
                    else:
                        host = m
                    parts.append((host, done))
                futures.append(self._drain.submit(self._to_host, parts,
                                                  keep))
            out.extend(f.result() for f in futures)
        finally:
            concurrent.futures.wait(futures)  # no drain work outlives us
        return np.concatenate(out) if out else np.zeros((0, h, w), np.uint8)
