"""Tracing and profiling helpers (counterpart of
pytorch_camvid_tpu/utils/profiling.py; reference wall-clock spans,
train.py:117,167, and torch_xla's ``met.metrics_report()``).

- ``StepTimer``: wall-clock spans ended by a device fence
  (``torch.cuda.synchronize``);
- ``trace``: a ``torch.profiler`` trace written for TensorBoard;
- ``metrics_report``: the caching allocator's counters per CUDA device.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch


def sync(x=None):
    """Device fence: waits for the work queued on the current CUDA device.
    Without a tensor to fence on, or on the CPU, it does nothing."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class StepTimer:
    """Accumulates step wall times; .summary() gives mean/p50/p95 ms."""

    def __init__(self):
        self.times = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        sync(result)
        self.times.append(time.perf_counter() - self._t0)

    @contextlib.contextmanager
    def span(self, result_fn=None):
        self.start()
        yield
        self.stop(result_fn() if result_fn else None)

    def summary(self) -> dict:
        if not self.times:
            return {}
        t = np.asarray(self.times) * 1000.0
        return {"mean_ms": float(t.mean()), "p50_ms": float(np.median(t)),
                "p95_ms": float(np.percentile(t, 95)), "steps": len(t)}


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the block, CPU and (where there is one) the
    card, written to ``log_dir`` for TensorBoard's profile plugin."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


def metrics_report() -> str:
    """Allocator counters per CUDA device (torch.cuda.memory_stats), the
    counterpart of the JAX package's live-buffer report."""
    lines = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        lines.append(
            f"cuda:{i}: in_use "
            f"{stats.get('allocated_bytes.all.current', 0) / 1e6:.1f} MB, "
            f"peak {stats.get('allocated_bytes.all.peak', 0) / 1e6:.1f} MB, "
            f"reserved "
            f"{stats.get('reserved_bytes.all.current', 0) / 1e6:.1f} MB, "
            f"allocations {stats.get('allocation.all.allocated', 0)}")
    return "\n".join(lines)
