"""Starting the ranks of a run on one host: ``spawn(fn, world, ...)``.

Each rank is a process of its own, started with multiprocessing's
``spawn`` method (a fresh interpreter that imports only what ``fn``'s
module imports), one device each. It joins the run through
``multihost.init_distributed`` at a ``file://`` rendezvous in a fresh
temporary directory, calls ``fn(mesh, *args)`` with its flat ``Mesh`` and
sends the result back; the caller gets the results in rank order. A rank
that raises sends its traceback: the others are stopped and ``spawn``
raises with it (a rank still running then is killed). SIGTERM to the
caller is passed on to the ranks (a run's preemption save,
``train/loop.py``). Each rank takes its share of the host's CPU threads.

Before the ranks start on CUDA devices, ``build_kernels`` compiles the
sources a training run loads (``ops/cuda_build.py``), so the ranks load the
built libraries instead of running nvcc at once on a cold cache.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import signal
import tempfile
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import torch

from pytorch_camvid_tpu_torch.parallel.multihost import DEFAULT_TIMEOUT_S


def build_kernels() -> None:
    """Compile the kernel sources of the train, eval and serving paths in
    parallel (a no-op where they are built)."""
    from pytorch_camvid_tpu_torch.ops import (conv_train, cuda_build,
                                              fused_conv, fused_pool)
    sources = (fused_conv.SOURCE, conv_train.WGRAD_SOURCE,
               fused_pool.SOURCE, fused_conv.F32_SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(cuda_build.build, sources))


def rank_count(dp: int, device: str) -> int:
    """The ranks of ``-dp dp`` on ``device``: 0 means every visible card
    (one rank on the CPU); on CUDA more ranks than cards raise, as the
    serve CLI's ``-dp`` does. CPU ranks share the host."""
    if torch.device(device).type != "cuda":
        return max(dp, 1)
    visible = torch.cuda.device_count()
    if dp > visible:
        raise SystemExit(f"-dp {dp} but only {visible} devices visible")
    return dp or visible


def local_devices(world: int, device: str) -> List[str]:
    """One device per rank: cuda:0 .. cuda:world-1, or the CPU."""
    if torch.device(device).type == "cuda":
        return [f"cuda:{r}" for r in range(world)]
    return ["cpu"] * world


def _rank_main(fn, rank, world, init_method, device, timeout, threads,
               results, args):
    try:
        from pytorch_camvid_tpu_torch.parallel import mesh, multihost
        torch.set_num_threads(threads)
        multihost.init_distributed(init_method, world, rank, device,
                                   timeout)
        try:
            out = fn(mesh.make_mesh(device=device), *args)
        finally:
            multihost.shutdown()
        results.put((rank, True, out))
    except BaseException:   # reported to the caller, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world: int, *args,
          devices: Optional[Sequence[str]] = None,
          timeout: int = DEFAULT_TIMEOUT_S) -> list:
    """``fn(mesh, *args)`` on ``world`` ranks (``devices[r]`` each, default
    the CPU); returns the results in rank order. ``fn`` and its arguments
    must pickle (a module-level function); ``timeout`` (seconds) bounds
    the rendezvous and each collective."""
    devices = list(devices or ["cpu"] * world)
    if any(torch.device(d).type == "cuda" for d in devices):
        build_kernels()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    threads = max(1, (os.cpu_count() or 1) // world)
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, init, devices[r], timeout,
                                   threads, results, args))
                 for r in range(world)]

        def pass_on(signum, frame):
            for p in procs:
                if p.pid is not None and p.is_alive():
                    os.kill(p.pid, signal.SIGTERM)

        main = threading.current_thread() is threading.main_thread()
        prev = signal.signal(signal.SIGTERM, pass_on) if main else None
        try:
            for p in procs:
                p.start()
            return _collect(procs, results, world)
        finally:   # after a failure the others may wait in a collective
            for p in procs:
                if p.is_alive():
                    p.kill()
                if p.pid is not None:
                    p.join(timeout=30)
            if main:
                signal.signal(signal.SIGTERM, prev if prev is not None
                              else signal.SIG_DFL)


def _collect(procs, results, world: int) -> list:
    """Every rank's result, draining the queue before any join. A rank
    that dies without one ends the wait (a hung collective ends at the
    process group's timeout)."""
    out = {}
    while len(out) < world:
        try:
            rank, ok, value = results.get(timeout=1.0)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs)
                    if r not in out and p.exitcode not in (None, 0)]
            if dead:
                raise RuntimeError(f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} before "
                                   f"sending a result")
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{value}")
        out[rank] = value
    for p in procs:
        p.join(timeout=60)
    return [out[r] for r in range(world)]
