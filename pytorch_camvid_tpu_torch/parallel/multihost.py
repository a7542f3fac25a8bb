"""Setting up the ranks of a run and keeping their state equal (counterpart
of pytorch_camvid_tpu/parallel/multihost.py).

- ``init_distributed`` joins this process to the run: the ``PCT_*``
  contract (``PCT_COORDINATOR`` ``host:port`` or an ``init_method`` URL,
  ``PCT_NUM_PROCS``, ``PCT_PROC_ID``, ``PCT_INIT_TIMEOUT`` seconds) or
  explicit arguments (the tests pass ``file://`` URLs). Before the process
  group exists the ranks meet in its store and tell each other their host
  and device, so every rank applies one rule (``choose_backend``) to the
  same table: NCCL when every rank on a host has a card of its own, gloo
  when ranks share a card or run on the CPU. Rank 0 prints the result. The
  timeout bounds the meeting and every collective after it, so ranks that
  issue different collectives fail instead of hanging. Nothing switches to
  another backend or device when the chosen one fails.
- ``is_primary``: rank 0 owns the console, TB and checkpoint writes.
- ``put_global`` hands a rank its rows of an array every rank holds whole,
  on its device; ``put_global_tree`` broadcasts a ``TrainState``'s tensors
  from rank 0 and can check that the ranks agree (``check_agree``).
"""

from __future__ import annotations

import datetime
import hashlib
import os
import socket
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pytorch_camvid_tpu_torch.parallel.mesh import (BatchSharding, Mesh,
                                                    ReplicatedSharding)

DEFAULT_TIMEOUT_S = 600
_KEY = "pct_rank/"
_device: List[Optional[torch.device]] = [None]   # this rank's, once joined


def init_method_from(coordinator: str) -> str:
    """``host:port`` (the JAX contract) -> ``tcp://host:port``; a URL
    (``tcp://``, ``file://``) is kept."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def devices_from_table(table: List[Tuple[str, int, str]]
                       ) -> List[torch.device]:
    """Each rank's device from the table of (host, visible cards, wish):
    a wish ("cpu", "cuda:1") is kept; "cuda" takes card k % cards for the
    k-th rank on its host, in rank order."""
    seen, out = {}, []
    for host, cards, wish in table:
        k = seen.get(host, 0)
        seen[host] = k + 1
        if wish != "cuda":
            out.append(torch.device(wish))
        elif cards == 0:
            raise RuntimeError(f"a rank on {host} asks for a CUDA device "
                               f"but sees none")
        else:
            out.append(torch.device("cuda", k % cards))
    return out


def choose_backend(hosts: List[str], devices: List[torch.device]
                   ) -> Tuple[str, str]:
    """(backend, reason): NCCL when every rank runs on a CUDA device that
    no other rank of its host uses; gloo otherwise."""
    if any(d.type != "cuda" for d in devices):
        return "gloo", "ranks on the CPU"
    places = [(h, d.index or 0) for h, d in zip(hosts, devices)]
    if len(set(places)) < len(places):
        return "gloo", "ranks share a card"
    return "nccl", "one card per rank"


def init_distributed(init_method: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: str = "cuda",
                     initialization_timeout: Optional[int] = None
                     ) -> Tuple[int, int]:
    """Join the run as rank ``process_id`` of ``num_processes``; returns
    (rank, world). Unset arguments come from ``PCT_COORDINATOR``,
    ``PCT_NUM_PROCS``, ``PCT_PROC_ID`` and ``PCT_INIT_TIMEOUT`` (default
    600 s). ``device``: "cuda" (a card by the rank's place on its host),
    an explicit device, or "cpu"."""
    env = os.environ
    url = init_method or env.get("PCT_COORDINATOR")
    if not url:
        raise ValueError("init_distributed needs an init_method or "
                         "PCT_COORDINATOR (host:port)")
    world = num_processes if num_processes is not None else int(
        env.get("PCT_NUM_PROCS", "0"))
    rank = process_id if process_id is not None else int(
        env.get("PCT_PROC_ID", "-1"))
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} of {world}: set PCT_NUM_PROCS and "
                         f"PCT_PROC_ID (0 <= id < procs)")
    seconds = initialization_timeout or int(
        env.get("PCT_INIT_TIMEOUT", DEFAULT_TIMEOUT_S))
    timeout = datetime.timedelta(seconds=seconds)
    url = init_method_from(url)
    kw = {"timeout": timeout} if url.startswith("tcp://") else {}
    store, rank, world = next(dist.rendezvous(url, rank, world, **kw))
    store.set_timeout(timeout)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    host = socket.gethostname()
    store.set(f"{_KEY}{rank}", f"{host}\n{cards}\n{device}")
    table = []
    for r in range(world):
        h, c, wish = store.get(f"{_KEY}{r}").decode().split("\n")
        table.append((h, int(c), wish))
    devices = devices_from_table(table)
    backend, why = choose_backend([h for h, _, _ in table], devices)
    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=timeout)
    _device[0] = dev
    if rank == 0:
        print(f"distributed: {world} ranks, backend {backend} ({why}); "
              f"rank 0 on {dev}", flush=True)
    return rank, world


def rank_device() -> torch.device:
    """The device ``init_distributed`` gave this rank (the CPU when it
    was not called)."""
    return _device[0] or torch.device("cpu")


def shutdown() -> None:
    """Leave the run: destroy the process group."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _device[0] = None


def is_primary() -> bool:
    """True on the rank that owns host-side writes; a run without a process
    group is its own primary."""
    return not dist.is_initialized() or dist.get_rank() == 0


def put_global(x, sharding):
    """``x``, the whole array on every rank (a numpy array or a tensor), as
    this rank holds it on its device: its rows under a ``BatchSharding``,
    all of it under a ``ReplicatedSharding``."""
    t = torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray)
                        else x)
    if isinstance(sharding, BatchSharding):
        t = t[sharding.mesh.rows(t.shape[0])]
    elif not isinstance(sharding, ReplicatedSharding):
        raise TypeError(f"unknown sharding {sharding!r}")
    return t.to(sharding.mesh.device)


def state_tensors(state) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf of a ``TrainState``: the model's
    state_dict, the optimizer's state and the generator's state."""
    out = [("model/" + k, v) for k, v in state.model.state_dict().items()]
    for key in sorted(state.opt_state):
        out += [(f"opt/{key}/{n}", t)
                for n, t in state.opt_state[key].items()]
    return out


def put_global_tree(state, sharding: ReplicatedSharding,
                    check: bool = False):
    """Give every rank rank 0's ``TrainState`` (in place): each tensor, the
    step and the generator's state broadcast from rank 0. ``check``: then
    hold the ranks to bit-equal leaves (``check_agree``)."""
    mesh = sharding.mesh
    if not mesh.levels:
        return state
    with torch.no_grad():
        for _, t in state_tensors(state):
            dist.broadcast(t, 0)
        gen = state.generator.get_state().to(mesh.device)
        dist.broadcast(gen, 0)
        state.generator.set_state(gen.cpu())
        step = torch.tensor([state.step], dtype=torch.int64,
                            device=mesh.device)
        dist.broadcast(step, 0)
        state.step = int(step.item())
    if check:
        check_agree(state, mesh)
    return state


def _fingerprint(t: torch.Tensor) -> torch.Tensor:
    """An int64 digest of ``t``'s bits (position-weighted, wrapping)."""
    t = t.detach().contiguous().reshape(-1)
    if t.is_floating_point():
        t = t.view({2: torch.int16, 4: torch.int32,
                    8: torch.int64}[t.element_size()])
    t = t.long()
    w = torch.arange(t.numel(), device=t.device, dtype=torch.int64) \
        % 65521 + 1
    return (t * w).sum()


def leaf_digests(state, device) -> Tuple[List[str], torch.Tensor]:
    """(names, int64 digest of each leaf on ``device``) of a
    ``TrainState``, the generator's state and the step included."""
    named = state_tensors(state)
    named.append(("generator", state.generator.get_state()))
    named.append(("step", torch.tensor([state.step])))
    digests = torch.stack([_fingerprint(t.to(device)) for _, t in named])
    return [n for n, _ in named], digests


def check_agree(state, mesh: Mesh) -> int:
    """Raise unless every rank holds bit-equal leaves; returns their
    number."""
    names, d = leaf_digests(state, mesh.device)
    if not mesh.levels:
        return len(names)
    hi = mesh.all_reduce(d.clone(), dist.ReduceOp.MAX)
    lo = mesh.all_reduce(d.clone(), dist.ReduceOp.MIN)
    off = [n for n, a, b in zip(names, hi.tolist(), lo.tolist()) if a != b]
    if off:
        raise RuntimeError(f"the {mesh.world} ranks disagree on "
                           f"{len(off)} of {len(names)} leaves, e.g. "
                           f"{off[:4]}")
    return len(names)


def state_sha256(state) -> str:
    """SHA-256 of every leaf's bytes, in order, on the host: an exact
    fingerprint to compare states across processes."""
    h = hashlib.sha256()
    names = []
    for name, t in state_tensors(state) + [
            ("generator", state.generator.get_state())]:
        names.append(name)
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    h.update(str(state.step).encode())
    return h.hexdigest()
