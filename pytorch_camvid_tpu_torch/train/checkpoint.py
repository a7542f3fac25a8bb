"""Checkpoints (counterpart of pytorch_camvid_tpu/train/checkpoint.py;
reference torch.save(net.state_dict()) at train.py:232-240, discovery at
utils.py:95-145).

The JAX package's container, names and discovery rules:
``checkpoints/<ISO-timestamp>/<epoch>-{best|regular|preempt}.ckpt.npz``,
one ``.npz`` holding ``__payload__`` (JSON: ``treedef``, ``meta``,
``n_leaves``) and ``leaf_{i}`` arrays, written atomically with
``os.replace``.

- The port writes its own leaves: the model's state_dict, the optimizer's
  state by parameter name (``opt/<key>/<name>``, in ``named_parameters``
  order), the step and the generator's state. Its ``treedef`` is a
  structure fingerprint: ``torch:`` and the JSON list of the leaves'
  (name, shape).
- A ``treedef`` that starts with ``PyTreeDef(`` is the JAX package's
  flattened ``TrainState``; the port reads it without jax. ``jax.tree_util``
  flattens the registered dataclass by its fields (params, bn_state,
  opt_state, step, rng), a dict by sorted key and a list in order, so the
  leaf order follows from the model's spec. The JAX PRNG key has no torch
  counterpart: the generator is seeded as
  ``interop/weights.py::train_state_from_jax`` seeds it, so a run resumed
  from a JAX checkpoint draws other augmentations than JAX would.
- Loading into a ``TrainState`` checks the leaf count and the structure
  (the fingerprint, or each JAX leaf's shape) and raises ``ValueError`` on
  a mismatched model or optimizer.
- Data parallelism: in a run of several ranks every rank reads the file and
  rank 0 alone writes (``train/loop.py``); after loading the ranks take
  rank 0's state (``parallel/multihost.py::put_global_tree``, JAX's
  ``put_global`` on load). Nothing in a file depends on the number of
  ranks, so a checkpoint of N ranks resumes on M (JAX's elastic restore).
"""

from __future__ import annotations

import glob
import json
import os
import re
import types
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pytorch_camvid_tpu_torch.interop.weights import (
    load_torch_checkpoint, state_dict_from_jax_variables,
    train_state_from_jax)
from pytorch_camvid_tpu_torch.models import model_class
from pytorch_camvid_tpu_torch.train.state import TrainState

SUFFIX = ".ckpt.npz"
PORT_PREFIX = "torch:"
JAX_PREFIX = "PyTreeDef("
_BLOCK_KEYS = ("b", "bias", "scale", "w")   # a JAX block dict, sorted
_BN_KEYS = ("mean", "var")


def _numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def port_leaves(state: TrainState) -> List[Tuple[str, np.ndarray]]:
    """(name, host array) of every leaf the port saves, in file order."""
    leaves = [("model/" + k, _numpy(v))
              for k, v in state.model.state_dict().items()]
    names = [n for n, _ in state.model.named_parameters()]
    for key in sorted(state.opt_state):
        leaves += [(f"opt/{key}/{n}", _numpy(state.opt_state[key][n]))
                   for n in names]
    leaves.append(("step", np.asarray(state.step, np.int64)))
    leaves.append(("generator", _numpy(state.generator.get_state())))
    return leaves


def fingerprint(leaves) -> str:
    """The port's ``treedef``: its leaves' ordered names and shapes."""
    return PORT_PREFIX + json.dumps([[n, list(a.shape)] for n, a in leaves])


def save_checkpoint(path: str, state: TrainState,
                    meta: Optional[dict] = None) -> None:
    """Write ``state`` atomically. ``meta`` is free-form JSON (epoch, mIOU,
    net, the preemption point)."""
    leaves = port_leaves(state)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {f"leaf_{i}": a for i, (_, a) in enumerate(leaves)}
    payload = {"treedef": fingerprint(leaves), "meta": meta or {},
               "n_leaves": len(leaves)}
    tmp = path + ".tmp.npz"
    np.savez(tmp[:-4], __payload__=json.dumps(payload), **arrays)
    os.replace(tmp, path)


def _read(path: str):
    z = np.load(path, allow_pickle=False)
    if "__payload__" not in z.files:
        raise ValueError(f"{path}: not a checkpoint of either package (no "
                         f"__payload__)")
    return z, json.loads(str(z["__payload__"]))


def _leaves(z, payload, n_want: int, path: str) -> List[np.ndarray]:
    n = payload["n_leaves"]
    if n != n_want:
        raise ValueError(f"checkpoint has {n} leaves, template has "
                         f"{n_want}: model/optimizer mismatch ({path})")
    return [z[f"leaf_{i}"] for i in range(n)]


# ----------------------------------------------------- the JAX package's

def _jax_blocks(net: str) -> List[Tuple[str, int]]:
    """(stage, blocks) in the JAX tree's sorted-key order."""
    return sorted((stage, len(pairs))
                  for stage, pairs in model_class(net).base_spec(3, 12))


def _jax_params_tree(leaves, blocks, keys) -> Tuple[dict, int]:
    """A {stage: [{key: leaf}]} tree from the front of ``leaves``; returns
    it and the number of leaves it took."""
    tree, i = {}, 0
    for stage, nb in blocks:
        tree[stage] = []
        for _ in range(nb):
            tree[stage].append(dict(zip(keys, leaves[i: i + len(keys)])))
            i += len(keys)
    return tree, i


def _jax_layout(model, opt_keys) -> List[Tuple[str, Optional[tuple]]]:
    """(name, shape) of a JAX TrainState's leaves for ``model`` (the rng
    key's shape is left open)."""
    params = dict(model.named_parameters())
    stats = dict(model.named_buffers())
    blocks = _jax_blocks(model.net)
    out = []

    def param_leaves(prefix):
        for stage, nb in blocks:
            for i in range(nb):
                names = model.block_names(stage, i)
                for key in _BLOCK_KEYS:
                    shape = tuple(params[names[key]].shape)
                    if key == "w":   # OIHW -> JAX's HWIO
                        shape = (shape[2], shape[3], shape[1], shape[0])
                    out.append((f"{prefix}{stage}.{i}.{key}", shape))
    param_leaves("params/")
    for stage, nb in blocks:
        for i in range(nb):
            names = model.block_names(stage, i)
            out += [(f"bn_state/{stage}.{i}.{k}",
                     tuple(stats[names[k]].shape)) for k in _BN_KEYS]
    for key in sorted(opt_keys):
        param_leaves(f"opt_state/{key}/")
    return out + [("step", ()), ("rng", None)]


def _load_jax(z, payload, state: TrainState, path: str) -> None:
    layout = _jax_layout(state.model, state.opt_state)
    leaves = _leaves(z, payload, len(layout), path)
    for i, ((name, shape), a) in enumerate(zip(layout, leaves)):
        if shape is not None and tuple(a.shape) != shape:
            raise ValueError(f"leaf {i} ({name}): checkpoint shape "
                             f"{a.shape} != template shape {shape} "
                             f"({path})")
    blocks = _jax_blocks(state.model.net)
    params, i = _jax_params_tree(leaves, blocks, _BLOCK_KEYS)
    bn, k = _jax_params_tree(leaves[i:], blocks, _BN_KEYS)
    i += k
    opt = {}
    for key in sorted(state.opt_state):
        opt[key], k = _jax_params_tree(leaves[i:], blocks, _BLOCK_KEYS)
        i += k
    carried = train_state_from_jax(types.SimpleNamespace(
        params=params, bn_state=bn, opt_state=opt, step=leaves[i]),
        state.model)
    state.opt_state = carried.opt_state
    state.step = carried.step
    state.generator = carried.generator


def _jax_state_dict(z, payload, net: str) -> Dict[str, torch.Tensor]:
    """The model's weights and BN stats from a JAX checkpoint, at whatever
    width it was trained (the conv weights' shapes give the spec)."""
    blocks = _jax_blocks(net)
    nb = sum(n for _, n in blocks)
    if payload["n_leaves"] < 6 * nb:
        raise ValueError(f"checkpoint has {payload['n_leaves']} leaves, "
                         f"fewer than {net}'s {6 * nb} weights and stats")
    leaves = [z[f"leaf_{i}"] for i in range(6 * nb)]
    params, i = _jax_params_tree(leaves, blocks, _BLOCK_KEYS)
    bn, _ = _jax_params_tree(leaves[i:], blocks, _BN_KEYS)
    return state_dict_from_jax_variables({"params": params, "state": bn})


# ---------------------------------------------------------------- public

def load_checkpoint(path: str, state: TrainState) -> Tuple[TrainState,
                                                             dict]:
    """Restore a checkpoint (the port's or the JAX package's) into
    ``state`` in place, on its model's device. Returns (state, meta)."""
    z, payload = _read(path)
    treedef = payload.get("treedef") or ""
    if treedef.startswith(JAX_PREFIX):
        _load_jax(z, payload, state, path)
        return state, payload["meta"]
    template = port_leaves(state)
    leaves = _leaves(z, payload, len(template), path)
    if treedef != fingerprint(template):
        raise ValueError(
            f"checkpoint treedef does not match the template structure: "
            f"wrong model/optimizer for {path}:\n"
            f"  checkpoint: {treedef[:200]}...\n"
            f"  template:   {fingerprint(template)[:200]}...")
    named = dict(zip((n for n, _ in template), leaves))
    state.model.load_state_dict(
        {n[len("model/"):]: torch.from_numpy(a) for n, a in named.items()
         if n.startswith("model/")}, strict=True)
    with torch.no_grad():
        for key, tensors in state.opt_state.items():
            for n, t in tensors.items():
                t.copy_(torch.from_numpy(named[f"opt/{key}/{n}"]))
    state.step = int(named["step"])
    state.generator.set_state(torch.from_numpy(named["generator"]))
    return state, payload["meta"]


def load_weights(path: str, net: str) -> Dict[str, torch.Tensor]:
    """A reference-named state_dict (CPU tensors) from a ``.pth``, a port
    ``.ckpt.npz`` or a JAX ``.ckpt.npz``: what eval, predict and serving
    need, at any width."""
    if path.endswith(".pth"):
        return load_torch_checkpoint(path)
    z, payload = _read(path)
    treedef = payload.get("treedef") or ""
    if treedef.startswith(JAX_PREFIX):
        return _jax_state_dict(z, payload, net)
    if not treedef.startswith(PORT_PREFIX):
        raise ValueError(f"{path}: not a checkpoint of either package")
    names = [n for n, _ in json.loads(treedef[len(PORT_PREFIX):])]
    return {n[len("model/"):]: torch.from_numpy(z[f"leaf_{i}"])
            for i, n in enumerate(names) if n.startswith("model/")}


def read_meta(path: str) -> dict:
    """The free-form meta (epoch, mIOU, ...) a ``.ckpt.npz`` of either
    package holds; ``{}`` for a reference ``.pth``."""
    if path.endswith(".pth"):
        return {}
    return _read(path)[1].get("meta", {})


def checkpoint_name(folder: str, epoch: int, kind: str) -> str:
    """checkpoints/<run>/<epoch>-{best|regular|preempt}.ckpt.npz
    (train.py:42; 'preempt' is the mid-epoch SIGTERM save, under its own
    name so it never overwrites an end-of-epoch checkpoint)."""
    return os.path.join(folder, f"{epoch}-{kind}{SUFFIX}")


def get_weight_path(checkpoint_root: str) -> str:
    """Newest-mtime best/regular/preempt checkpoint across all run dirs
    (utils.get_weight_path, utils.py:95-145); '' when there is none.
    Reference-style ``.pth`` names count too."""
    checkpoint_root = os.path.abspath(checkpoint_root)
    files = glob.glob(os.path.join(checkpoint_root, "*", "*" + SUFFIX))
    files += glob.glob(os.path.join(checkpoint_root, "*", "*.pth"))
    candidates = [
        f for f in files
        if re.search(r"[0-9]+-(best|regular|preempt)\.", os.path.basename(f))]
    if not candidates:
        return ""
    return max(candidates, key=os.path.getmtime)


def parse_epoch(weight_path: str) -> int:
    """Epoch from a '<epoch>-{best|regular|preempt}' filename
    (train.py:112-113)."""
    m = re.search(r"([0-9]+)-(best|regular|preempt)\.",
                  os.path.basename(weight_path))
    if not m:
        raise ValueError(f"cannot parse epoch from {weight_path}")
    return int(m.group(1))
