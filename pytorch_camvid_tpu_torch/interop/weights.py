"""Weight interchange with the JAX package and reference checkpoints
(counterpart of pytorch_camvid_tpu/interop/torch_weights.py). Pure numpy and
torch. The way back, a state_dict into JAX variables, is the JAX package's
own ``variables_from_state_dict``.

The JAX package keeps a model as ``{"params": {stage: [block, ...]},
"state": {stage: [bn_state, ...]}}`` with block = {w (HWIO), b, scale,
bias} and bn_state = {mean, var}. The port's state_dict uses the
reference's names (UNet: ``down{k}.{i}.conv.{0,1}.*``,
``upsample{k}.conv.conv.*``, ``up{k}.{i}.conv.*``, ``output.conv.*``) with
OIHW conv weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


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
