"""Post-training int8 quantization for serving (counterpart of
pytorch_camvid_tpu/ops/quant.py).

Standard PTQ, as the JAX package does it:
- BN folding: eval-mode BatchNorm is a per-channel affine, so it folds into
  the conv exactly: ``w_eff = w * g``, ``b_eff = (b - mean) * g + beta``
  with ``g = scale * rsqrt(var + eps)`` (``fold_bn``).
- Per-output-channel symmetric weights, ``s_w[c] = max|w_eff[.., c]| / 127``
  (``quantize_block``).
- Per-tensor symmetric activations, ``s_x = amax / 127``, where ``amax`` is
  the running max|block input| over calibration batches (``calibrate``: the
  ordinary eval forward, K4 on every block, with each block recording
  max|x| in f32 under ``ops/conv.py::calibrating()``).
- Fused int8 handoff: on a direct conv->conv edge (consecutive blocks of a
  stage) the producer's epilogue emits the consumer's int8 operand
  (``s_out`` = the consumer's ``s_x``, ``fuse_block_handoff``); in SegNet
  also across each max-pool / unpool edge (``fuse_pool_edges``), where the
  pools then run on int8 values (K3's int8 instance). UNet has no such
  edge: its encoder outputs double as skips.
- ``min_cout`` (64): narrower blocks, the 12- and 21-class heads, stay in
  the compute dtype on K4 (``quantize_variables``).

The tree functions (``fold_bn``, ``quantize_block``, ``fuse_block_handoff``,
``fuse_pool_edges``, ``quantize_variables``) take the JAX package's trees,
``{"params": {stage: [{w (HWIO), b, scale, bias}, ...]}, "state": {stage:
[{mean, var}, ...]}}``, with torch tensors as leaves, and keep JAX's
arithmetic in JAX's order (the divisors as tensors on the data's device: a
CUDA division by a Python number multiplies by its reciprocal). The module
functions apply them to a model in place: ``calibrate(model, batches)``
returns the amax tree ``{stage: [amax, ...]}``, ``quantize_model(model,
amax)`` turns the blocks it quantizes into int8 blocks
(``ops/conv.py::ConvBNReLU.set_quantized``).

The int8 block itself is ``quantized_block_apply``: the input quantized at
``s_x`` (``ops/fused_conv_int8.py::quantize``) unless it arrives as int8
from its producer, then ``ops/fused_conv_int8.py::conv3x3_int8_block`` (the
Hopper kernels on CUDA, their plain versions on the CPU or with
``plain``). ``conv2d_int8`` is the
int32 conv alone, the plain version's (the kernel fuses the epilogue).
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch

from pytorch_camvid_tpu_torch.ops import fused_conv_int8
from pytorch_camvid_tpu_torch.ops.conv import ConvBNReLU, calibrating
from pytorch_camvid_tpu_torch.ops.fused_conv import BN_EPS
from pytorch_camvid_tpu_torch.ops.fused_conv_int8 import (QMAX, conv2d_int8,
                                                         quantize,
                                                         quantize_plain)

__all__ = ["QMAX", "calibrate", "conv2d_int8", "fold_bn",
           "fuse_block_handoff", "fuse_pool_edges", "model_variables",
           "quantize", "quantize_block", "quantize_model",
           "quantize_plain", "quantize_variables", "quantized_block_apply"]


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def fold_bn(params, state):
    """Fold eval-mode BN into the conv: (w_eff HWIO, b_eff), float32."""
    g = params["scale"] * torch.rsqrt(state["var"] + BN_EPS)
    w_eff = params["w"].float() * g   # broadcast over cout
    b_eff = (params["b"].float() - state["mean"]) * g + params["bias"]
    return w_eff, b_eff


def quantize_block(params, state, amax):
    """One conv+BN+ReLU block -> int8 serving params {w_q, s_w, s_x, b_eff};
    ``amax``: the calibrated max|x| of the block's input (f32 scalar)."""
    w_eff, b_eff = fold_bn(params, state)
    qmax = _const(QMAX, w_eff)
    s_w = w_eff.abs().amax(dim=(0, 1, 2)) / qmax
    s_w = torch.clamp_min(s_w, 1e-12)   # all-zero channels stay harmless
    w_q = torch.clamp(torch.round(w_eff / s_w), -QMAX, QMAX).to(torch.int8)
    amax = torch.as_tensor(amax, dtype=torch.float32, device=w_eff.device)
    s_x = torch.clamp_min(amax, 1e-12) / qmax
    return {"w_q": w_q, "s_w": s_w, "s_x": s_x, "b_eff": b_eff}


def _zip3_blocks(params, state, amax, fn):
    """Recurse three structurally parallel trees down to block level."""
    if isinstance(params, dict) and "w" in params:
        return fn(params, state, amax)
    if isinstance(params, dict):
        return {k: _zip3_blocks(params[k], state[k], amax[k], fn)
                for k in params}
    if isinstance(params, (list, tuple)):
        return type(params)(_zip3_blocks(p, s, a, fn)
                            for p, s, a in zip(params, state, amax))
    return params


def fuse_block_handoff(params_q):
    """Mark direct conv->conv edges for the fused int8 handoff: in each
    stage's block list, every quantized block followed by a quantized block
    gets ``s_out`` = the successor's ``s_x``. The last block of each list
    keeps the compute-dtype output. Returns a new tree."""
    if isinstance(params_q, dict):
        return {k: fuse_block_handoff(v) for k, v in params_q.items()}
    if isinstance(params_q, (list, tuple)):
        out = [fuse_block_handoff(v) for v in params_q]
        for i in range(len(out) - 1):
            if (isinstance(out[i], dict) and "w_q" in out[i]
                    and isinstance(out[i + 1], dict)
                    and "w_q" in out[i + 1]):
                out[i] = dict(out[i], s_out=out[i + 1]["s_x"])
        return type(params_q)(out)
    return params_q


# Stage edges that cross only a max-pool or max-unpool between a
# stage-final and a stage-initial block, the producer's output consumed by
# nothing else: max-pool commutes with the monotone quantization map, and
# the unpool's fill 0 is quantize(0), so the producer can emit the
# consumer's int8 operand across the pool. SegNet qualifies on every
# boundary (its skips are indices); UNet on none (its encoder outputs are
# also decoder skips, and its decoder edges cross a bilinear upsample).
_POOL_EDGES = {
    "encoder1": [("encoder1", "encoder2"), ("encoder2", "encoder3"),
                 ("encoder3", "encoder4"), ("encoder4", "encoder5"),
                 ("encoder5", "decoder5"), ("decoder5", "decoder4"),
                 ("decoder4", "decoder3"), ("decoder3", "decoder2"),
                 ("decoder2", "decoder1")],
}


def fuse_pool_edges(params_q):
    """Fuse the int8 handoff across the pool / unpool edges of
    ``_POOL_EDGES`` (the model family read off the stage names; other trees
    pass through). Returns a new tree."""
    if not isinstance(params_q, dict):
        return params_q
    edges = next((v for k, v in _POOL_EDGES.items() if k in params_q),
                 None)
    if edges is None:
        return params_q
    out = dict(params_q)
    for a, c in edges:
        ba, bc = out.get(a), out.get(c)
        if (ba and bc and isinstance(ba[-1], dict) and "w_q" in ba[-1]
                and isinstance(bc[0], dict) and "w_q" in bc[0]
                and "s_out" not in ba[-1]):
            ba = list(ba)
            ba[-1] = dict(ba[-1], s_out=bc[0]["s_x"])
            out[a] = type(params_q[a])(ba)
    return out


def quantize_variables(variables, amax_tree, fuse_handoff: bool = True,
                       min_cout: int = 64, fuse_pool: bool = True):
    """Variables + the calibrated amax tree -> the same tree with each
    block of ``min_cout`` or more output channels quantized ({w_q, s_w,
    s_x, b_eff}, and ``s_out`` on the fused edges); the narrower blocks
    (the heads) keep their float params. ``fuse_handoff=False`` gives the
    per-block-requantize tree."""
    def q_or_keep(params, state, amax):
        if params["w"].shape[-1] < min_cout:
            return params
        return quantize_block(params, state, amax)

    params_q = _zip3_blocks(variables["params"], variables["state"],
                            amax_tree, q_or_keep)
    if fuse_handoff:
        params_q = fuse_block_handoff(params_q)
        if fuse_pool:
            params_q = fuse_pool_edges(params_q)
    return {"params": params_q, "state": variables["state"]}


def quantized_block_apply(params_q, x: torch.Tensor,
                          compute_dtype: torch.dtype = torch.bfloat16,
                          plain: bool = False) -> torch.Tensor:
    """relu(conv_int8(q(x), w_q) * (s_x * s_w) + b_eff) in
    ``compute_dtype``, or with ``s_out`` the next block's int8 operand. An
    int8 ``x`` is already quantized at this block's ``s_x`` (its producer's
    epilogue) and is the conv operand as it is. ``params_q`` may hold
    ``w_k``, the kernel's packed weights."""
    s_x = params_q["s_x"]
    if x.dtype == torch.int8:
        x_q = x
    else:
        x_q = (quantize_plain if plain else quantize)(x.contiguous(), s_x)
    s_out = params_q.get("s_out")
    out_dtype = torch.int8 if s_out is not None else compute_dtype
    args = (x_q, params_q["w_q"], params_q["s_w"], s_x,
            params_q["b_eff"], s_out, out_dtype)
    if plain:
        return fused_conv_int8.conv3x3_int8_block_plain(*args)
    return fused_conv_int8.conv3x3_int8_block(*args,
                                              packed=params_q.get("w_k"))


# ------------------------------------------------------------ on a model

def _stages(model) -> List[str]:
    return [stage for stage, _ in model.spec]


def model_variables(model) -> dict:
    """The model's float blocks as the JAX tree, torch leaves on the
    model's device: params {w (HWIO), b, scale, bias}, state {mean, var}."""
    params, state = {}, {}
    for stage in _stages(model):
        params[stage], state[stage] = [], []
        for blk in model.stage_blocks(stage):
            conv, bn = blk.conv_bn()
            params[stage].append({
                "w": conv.weight.detach().permute(2, 3, 1, 0),
                "b": conv.bias.detach(), "scale": bn.weight.detach(),
                "bias": bn.bias.detach()})
            state[stage].append({"mean": bn.running_mean,
                                 "var": bn.running_var})
    return {"params": params, "state": state}


@torch.no_grad()
def calibrate(model, batches: Iterable[torch.Tensor]
              ) -> Dict[str, List[torch.Tensor]]:
    """Eval forwards over ``batches`` (NHWC, preprocessed exactly as serving
    feeds the model, in the compute dtype), each block recording the
    running max|input| in f32. Returns {stage: [amax per block]}."""
    if model.training:
        raise RuntimeError("calibrate runs the model in eval mode")
    blocks = model.blocks()
    if any(blk.quantized for blk in blocks):
        raise ValueError("calibrate takes a float model: this one is "
                         "quantized already")
    dev = blocks[0].conv_bn()[0].weight.device
    for blk in blocks:
        blk.calib_amax = torch.zeros((), dtype=torch.float32, device=dev)
    try:
        with calibrating():
            for x in batches:
                model(x)
        return {stage: [blk.calib_amax.clone()
                        for blk in model.stage_blocks(stage)]
                for stage in _stages(model)}
    finally:
        for blk in blocks:
            blk.calib_amax = None


@torch.no_grad()
def quantize_model(model, amax, fuse_handoff: bool = True,
                   min_cout: int = 64, fuse_pool: bool = True):
    """Quantize ``model`` in place from its weights and the ``amax`` tree
    (``calibrate``): each block that ``quantize_variables`` quantizes
    becomes an int8 block (``ConvBNReLU.set_quantized``); the rest stay
    float. Returns the model."""
    params_q = quantize_variables(model_variables(model), amax, fuse_handoff,
                                  min_cout, fuse_pool)["params"]
    for stage in _stages(model):
        for blk, p in zip(model.stage_blocks(stage), params_q[stage]):
            if "w_q" in p:
                blk.set_quantized(p["w_q"], p["s_w"], p["s_x"], p["b_eff"],
                                  p.get("s_out"))
    return model


def quantized_blocks(model) -> List[ConvBNReLU]:
    """The model's int8 blocks, in spec order."""
    return [blk for blk in model.blocks() if blk.quantized]
