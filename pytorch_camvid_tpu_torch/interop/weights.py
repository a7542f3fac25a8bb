"""Weight and train-state interchange with the JAX package and reference
checkpoints (counterpart of pytorch_camvid_tpu/interop/torch_weights.py).
Pure numpy and torch.

- ``state_dict_from_jax_variables``: JAX UNet variables -> the port's
  state_dict (the way back for weights alone is the JAX package's own
  ``variables_from_state_dict``);
- ``named_from_jax_params`` / ``jax_params_from_named``: a params-shaped
  tree (parameters, or an optimizer's ``m``, ``v`` or ``buf``) <-> tensors
  keyed by the port's parameter names;
- ``train_state_from_jax``: a whole JAX ``TrainState`` (params, BN state,
  optimizer state, step) carried into the port's ``TrainState``;
- ``jax_variables_from_model``: the port's parameters and BN running stats
  back in JAX's layout as numpy, so tests compare after N steps.

The JAX package keeps a model as ``{"params": {stage: [block, ...]},
"state": {stage: [bn_state, ...]}}`` with block = {w (HWIO), b, scale,
bias} and bn_state = {mean, var}. The port's state_dict uses the
reference's names (UNet: ``down{k}.{i}.conv.{0,1}.*``,
``upsample{k}.conv.conv.*``, ``up{k}.{i}.conv.*``, ``output.conv.*``) with
OIHW conv weights.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from pytorch_camvid_tpu_torch.train.state import TrainState

# JAX block leaf -> (state_dict suffix of the port's block)
_PARAM_SUFFIX = {"w": "0.weight", "b": "0.bias", "scale": "1.weight",
                 "bias": "1.bias"}


def _block_prefix(stage: str, i: int) -> str:
    """state_dict prefix of conv block ``i`` of a UNet stage."""
    if stage.startswith("upsample"):
        return f"{stage}.conv.conv"
    if stage == "output":
        return "output.conv"
    return f"{stage}.{i}.conv"


def state_dict_from_jax_variables(variables_np) -> Dict[str, torch.Tensor]:
    """JAX UNet variables (numpy leaves) -> the port's state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for stage, blocks in variables_np["params"].items():
        for i, blk in enumerate(blocks):
            p = _block_prefix(stage, i)
            st = variables_np["state"][stage][i]
            w = np.asarray(blk["w"], np.float32).transpose(3, 2, 0, 1)
            for name, v in ((f"{p}.0.weight", w),
                            (f"{p}.0.bias", blk["b"]),
                            (f"{p}.1.weight", blk["scale"]),
                            (f"{p}.1.bias", blk["bias"]),
                            (f"{p}.1.running_mean", st["mean"]),
                            (f"{p}.1.running_var", st["var"])):
                out[name] = torch.from_numpy(np.array(v, np.float32))
            out[f"{p}.1.num_batches_tracked"] = torch.tensor(0)
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
    out = {}
    for stage, blocks in tree.items():
        for i, blk in enumerate(blocks):
            p = _block_prefix(stage, i)
            for key, suffix in _PARAM_SUFFIX.items():
                out[f"{p}.{suffix}"] = torch.from_numpy(_to_port(key,
                                                                 blk[key]))
    return out


def jax_params_from_named(named: Dict[str, torch.Tensor], spec):
    """The inverse of ``named_from_jax_params`` as numpy, for a model
    ``spec`` (``models/unet.py::scaled_spec``)."""
    tree = {}
    for stage, pairs in spec:
        tree[stage] = []
        for i in range(len(pairs)):
            p = _block_prefix(stage, i)
            blk = {}
            for key, suffix in _PARAM_SUFFIX.items():
                v = named[f"{p}.{suffix}"].detach().float().cpu().numpy()
                blk[key] = v.transpose(2, 3, 1, 0) if key == "w" else v
            tree[stage].append(blk)
    return tree


def jax_variables_from_model(model) -> dict:
    """The port's UNet as JAX variables {"params", "state"} of numpy."""
    sd = model.state_dict()
    params = jax_params_from_named(sd, model.spec)
    state = {stage: [{"mean": sd[f"{_block_prefix(stage, i)}.1.running_mean"]
                      .float().cpu().numpy(),
                      "var": sd[f"{_block_prefix(stage, i)}.1.running_var"]
                      .float().cpu().numpy()} for i in range(len(pairs))]
             for stage, pairs in model.spec}
    return {"params": params, "state": state}


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
