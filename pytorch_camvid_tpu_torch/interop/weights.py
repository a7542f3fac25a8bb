"""Weight and train-state interchange with the JAX package and reference
checkpoints (counterpart of pytorch_camvid_tpu/interop/torch_weights.py).
Pure numpy and torch.

- ``state_dict_from_jax_variables``: JAX variables -> the port's state_dict
  (the way back for weights alone is the JAX package's own
  ``variables_from_state_dict``);
- ``named_from_jax_params`` / ``jax_params_from_named``: a params-shaped
  tree (parameters, or an optimizer's ``m``, ``v`` or ``buf``) <-> tensors
  keyed by the port's parameter names;
- ``train_state_from_jax``: a whole JAX ``TrainState`` (params, BN state,
  optimizer state, step) carried into the port's ``TrainState``;
- ``jax_variables_from_model``: the port's parameters and BN running stats
  back in JAX's layout as numpy, so tests compare after N steps;
- ``quantized_from_jax``: the int8 tree of the JAX package's
  ``ops/quant.py::quantize_variables`` carried into a model's blocks
  (``amax_to_jax`` / ``amax_from_jax`` carry a calibration's amax tree
  across), so both packages serve from the same quantized weights.

The JAX package keeps a model as ``{"params": {stage: [block, ...]},
"state": {stage: [bn_state, ...]}}`` with block = {w (HWIO), b, scale,
bias} and bn_state = {mean, var}. The port's state_dict uses the
reference's names with OIHW conv weights; each model class gives them
(``block_names``: UNet ``down{k}.{i}.conv.{0,1}.*``, SegNet
``encoder{k}.{i}.{conv,bn}.*``, ...). Which model a tree belongs to follows
from its stage names.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from pytorch_camvid_tpu_torch.models import MODELS
from pytorch_camvid_tpu_torch.train.state import TrainState

_PARAMS = ("w", "b", "scale", "bias")


def _model_of(stages: Iterable[str]):
    """The model class whose spec has exactly these stage names."""
    stages = set(stages)
    for cls in MODELS.values():
        if {name for name, _ in cls.base_spec(3, 12)} == stages:
            return cls
    raise KeyError(f"no model has the stages {sorted(stages)}")


def state_dict_from_jax_variables(variables_np) -> Dict[str, torch.Tensor]:
    """JAX variables (numpy leaves) -> the port's state_dict."""
    cls = _model_of(variables_np["params"])
    out: Dict[str, torch.Tensor] = {}
    for stage, blocks in variables_np["params"].items():
        for i, blk in enumerate(blocks):
            names = cls.block_names(stage, i)
            st = variables_np["state"][stage][i]
            leaves = dict(blk, mean=st["mean"], var=st["var"])
            for key in _PARAMS + ("mean", "var"):
                out[names[key]] = torch.from_numpy(_to_port(key, leaves[key]))
            out[names["count"]] = torch.tensor(0)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference ``.pth`` (``torch.save(net.state_dict())``,
    reference train.py:234) as a state_dict on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _to_port(key: str, v) -> np.ndarray:
    v = np.array(v, np.float32)
    return v.transpose(3, 2, 0, 1) if key == "w" else v  # HWIO -> OIHW


def named_from_jax_params(tree) -> Dict[str, torch.Tensor]:
    """{stage: [{w, b, scale, bias}]} (numpy leaves) -> {port parameter
    name: f32 tensor}, conv weights HWIO -> OIHW."""
    cls = _model_of(tree)
    out = {}
    for stage, blocks in tree.items():
        for i, blk in enumerate(blocks):
            names = cls.block_names(stage, i)
            for key in _PARAMS:
                out[names[key]] = torch.from_numpy(_to_port(key, blk[key]))
    return out


def jax_params_from_named(named: Dict[str, torch.Tensor], spec):
    """The inverse of ``named_from_jax_params`` as numpy, for a model
    ``spec`` (the model's ``.spec``)."""
    cls = _model_of(stage for stage, _ in spec)
    tree = {}
    for stage, pairs in spec:
        tree[stage] = []
        for i in range(len(pairs)):
            names = cls.block_names(stage, i)
            blk = {}
            for key in _PARAMS:
                v = named[names[key]].detach().float().cpu().numpy()
                blk[key] = v.transpose(2, 3, 1, 0) if key == "w" else v
            tree[stage].append(blk)
    return tree


def jax_variables_from_model(model) -> dict:
    """The port's model as JAX variables {"params", "state"} of numpy."""
    sd = model.state_dict()
    params = jax_params_from_named(sd, model.spec)

    def stat(stage, i, key):
        return sd[model.block_names(stage, i)[key]].float().cpu().numpy()
    state = {stage: [{"mean": stat(stage, i, "mean"),
                      "var": stat(stage, i, "var")}
                     for i in range(len(pairs))]
             for stage, pairs in model.spec}
    return {"params": params, "state": state}


def quantized_from_jax(params_q_np, model) -> None:
    """Put the int8 blocks of a JAX ``quantize_variables(...)["params"]``
    tree (numpy leaves: w_q HWIO int8, s_w, s_x, b_eff and, on fused
    edges, s_out) into ``model``'s blocks, in place; the blocks JAX left
    float (no w_q) stay float, with the model's own weights."""
    for stage, blocks in params_q_np.items():
        for blk, p in zip(model.stage_blocks(stage), blocks):
            if "w_q" not in p:
                continue
            t = {k: torch.from_numpy(np.array(p[k]))
                 for k in ("w_q", "s_w", "s_x", "b_eff", "s_out") if k in p}
            blk.set_quantized(t["w_q"], t["s_w"], t["s_x"], t["b_eff"],
                              t.get("s_out"))


def amax_to_jax(amax) -> dict:
    """{stage: [f32 scalar tensor]} (``ops/quant.py::calibrate``) ->
    {stage: [np.float32 0-d array]}, the JAX calibration's tree."""
    return {stage: [np.array(a.detach().cpu().numpy(), np.float32)
                    for a in blocks] for stage, blocks in amax.items()}


def amax_from_jax(tree, device="cpu") -> dict:
    """The inverse of ``amax_to_jax``: f32 scalar tensors on ``device``."""
    return {stage: [torch.tensor(np.asarray(a, np.float32), device=device)
                    for a in blocks] for stage, blocks in tree.items()}


def train_state_from_jax(jax_state, model, generator: Optional[
        torch.Generator] = None):
    """Carry a JAX ``TrainState`` (numpy leaves: params, bn_state,
    opt_state of params-shaped trees, step) into the port: loads the
    weights and BN stats into ``model`` (strict) and returns a port
    ``TrainState`` on the model's device. The JAX PRNG key has no torch
    counterpart; ``generator`` (default: seeded with 0) takes its place."""
    dev = next(model.parameters()).device
    model.load_state_dict(state_dict_from_jax_variables(
        {"params": jax_state.params, "state": jax_state.bn_state}),
        strict=True)
    opt_state = {k: {n: t.to(dev) for n, t in
                     named_from_jax_params(tree).items()}
                 for k, tree in jax_state.opt_state.items()}
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return TrainState(model=model, opt_state=opt_state,
                      step=int(np.asarray(jax_state.step)),
                      generator=generator)
