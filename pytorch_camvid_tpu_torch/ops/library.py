"""The port's hand-written kernels as ``torch.library`` ops (namespace
``camvid::``), so that a traced program (``torch.export``) records each
kernel call as one node, and loading the program back needs only this
module: no model class, no checkpoint code.

Each op has three registrations:
- a CUDA kernel, which is the kernel's launcher and nothing else
  (``fused_conv.launch``, ``fused_pool.launch_*``,
  ``fused_conv_int8.launch``, ``launch_quantize``): it builds the kernel at
  its first call (``ops/cuda_build.py``), checks and aligns its inputs,
  launches and counts the launch, or raises; nothing falls back;
- a CPU kernel, the plain PyTorch version (made contiguous);
- a fake, which gives the output's shape, dtype and device and computes no
  data.

The ops: ``conv3x3_bn_relu`` (K4, and K1's forward and input gradient;
bf16 and f32 by dtype), ``max_pool_2x2_argmax`` and ``max_unpool_2x2``
(K3, also on int8), ``max_pool_2x2_phase`` and ``max_unpool_2x2_phase``
(K2's forward pieces), ``conv3x3_int8_block`` (the int8 block, on its
packed weights) and ``quantize_int8`` (its input quantize). K1's dW and
K2's phase gather run only in backward passes, which no program holds.

Eager calls keep the direct route: each wrapper (``fused_conv.
conv3x3_bn_relu`` and the rest) calls its op only while tracing
(``torch.compiler.is_compiling()``), and launches the same launcher
directly otherwise. One program therefore runs the kernels on the card and
the plain versions on the CPU, where the JAX package's exported artifact
leaves its TPU kernels out and bakes in the XLA forms.

Registration happens when this module is imported (``ops/conv.py``,
``ops/conv_train.py`` and ``ops/resize.py`` import it); building and
loading the kernels stays lazy.

``eager_cache`` is the tensor cache for modules whose cached tensors a
traced forward reaches: while tracing it builds afresh and keeps nothing,
so no traced (fake) tensor is ever handed to a later eager call.

``load_program(path, device)`` loads a program that ``torch.export.save``
wrote and returns it as a module on ``device``.
"""

import collections
import functools
from typing import Optional

import torch
import torch.export.passes

from pytorch_camvid_tpu_torch.ops import (fused_conv, fused_conv_int8,
                                          fused_pool, pooling)

NAMESPACE = "camvid"
Tensor = torch.Tensor


def eager_cache(fn):
    """``functools.lru_cache(maxsize=64)`` for eager calls. While tracing,
    ``fn`` runs afresh (its tensors are built in the traced graph) and the
    cache is neither read nor filled."""
    cached = functools.lru_cache(maxsize=64)(fn)

    @functools.wraps(fn)
    def call(*args):
        if torch.compiler.is_compiling():
            return fn(*args)
        return cached(*args)

    return call


def _nhwc(x: Tensor, c: int, h: Optional[int] = None,
          w: Optional[int] = None, dtype: Optional[torch.dtype] = None):
    """An empty (N, h, w, c) tensor on x's device (x's H and W by
    default), for the fakes."""
    return x.new_empty((x.shape[0], x.shape[1] if h is None else h,
                        x.shape[2] if w is None else w, c),
                       dtype=dtype or x.dtype)


# --------------------------------------------------------- K4 / K1 fwd, dx

@torch.library.custom_op(f"{NAMESPACE}::conv3x3_bn_relu", mutates_args=(),
                         device_types="cuda")
def conv3x3_bn_relu(x: Tensor, w: Tensor, a: Tensor, b: Tensor, relu: bool,
                    flip: bool) -> Tensor:
    return fused_conv.launch(x, w, a, b, relu, flip)


@conv3x3_bn_relu.register_kernel("cpu")
def _(x, w, a, b, relu, flip):
    return fused_conv.conv3x3_bn_relu_plain(x, w, a, b, relu,
                                            flip).contiguous()


@conv3x3_bn_relu.register_fake
def _(x, w, a, b, relu, flip):
    return _nhwc(x, w.shape[2] if flip else w.shape[3])


# ------------------------------------------------------------- K3 (eval)

@torch.library.custom_op(f"{NAMESPACE}::max_pool_2x2_argmax",
                         mutates_args=(), device_types="cuda")
def max_pool_2x2_argmax(x: Tensor) -> tuple[Tensor, Tensor]:
    return fused_pool.launch_pool_argmax(x)


@max_pool_2x2_argmax.register_kernel("cpu")
def _(x):
    y, idx = pooling.max_pool_2x2_with_argmax(x)
    return y.contiguous(), idx.contiguous()


@max_pool_2x2_argmax.register_fake
def _(x):
    h, w = x.shape[1] // 2, x.shape[2] // 2
    return (_nhwc(x, x.shape[3], h, w),
            _nhwc(x, x.shape[3], h, w, torch.int32))


@torch.library.custom_op(f"{NAMESPACE}::max_unpool_2x2", mutates_args=(),
                         device_types="cuda")
def max_unpool_2x2(x: Tensor, idx: Tensor, out_hw: list[int]) -> Tensor:
    return fused_pool.launch_unpool(x, idx, tuple(out_hw))


@max_unpool_2x2.register_kernel("cpu")
def _(x, idx, out_hw):
    return pooling.max_unpool_2x2(x, idx, tuple(out_hw)).contiguous()


@max_unpool_2x2.register_fake
def _(x, idx, out_hw):
    return _nhwc(x, x.shape[3], out_hw[0], out_hw[1])


# ------------------------------------------------ K2 (the train forward)

@torch.library.custom_op(f"{NAMESPACE}::max_pool_2x2_phase",
                         mutates_args=(), device_types="cuda")
def max_pool_2x2_phase(x: Tensor) -> tuple[Tensor, Tensor]:
    return fused_pool.launch_pool_phase(x)


@max_pool_2x2_phase.register_kernel("cpu")
def _(x):
    y, k = pooling.max_pool_2x2_argmax_phase(x)
    return y.contiguous(), k.contiguous()


@max_pool_2x2_phase.register_fake
def _(x):
    h, w = x.shape[1] // 2, x.shape[2] // 2
    return (_nhwc(x, x.shape[3], h, w),
            _nhwc(x, x.shape[3], h, w, torch.int8))


@torch.library.custom_op(f"{NAMESPACE}::max_unpool_2x2_phase",
                         mutates_args=(), device_types="cuda")
def max_unpool_2x2_phase(x: Tensor, k: Tensor, out_hw: list[int]) -> Tensor:
    return fused_pool.launch_unpool_phase(x, k, tuple(out_hw))


@max_unpool_2x2_phase.register_kernel("cpu")
def _(x, k, out_hw):
    return pooling.max_unpool_2x2_from_phase(x, k,
                                             tuple(out_hw)).contiguous()


@max_unpool_2x2_phase.register_fake
def _(x, k, out_hw):
    return _nhwc(x, x.shape[3], out_hw[0], out_hw[1])


# ------------------------------------------------------------------ int8

@torch.library.custom_op(f"{NAMESPACE}::conv3x3_int8_block",
                         mutates_args=(), device_types="cuda")
def conv3x3_int8_block(x: Tensor, w_q: Tensor, packed: Tensor, s_w: Tensor,
                       s_x: Tensor, b_eff: Tensor, s_out: Optional[Tensor],
                       out_dtype: torch.dtype) -> Tensor:
    return fused_conv_int8.launch(x, w_q, packed, s_w, s_x, b_eff, s_out,
                                  out_dtype)


@conv3x3_int8_block.register_kernel("cpu")
def _(x, w_q, packed, s_w, s_x, b_eff, s_out, out_dtype):
    return fused_conv_int8.conv3x3_int8_block_plain(
        x, w_q, s_w, s_x, b_eff, s_out, out_dtype).contiguous()


@conv3x3_int8_block.register_fake
def _(x, w_q, packed, s_w, s_x, b_eff, s_out, out_dtype):
    return _nhwc(x, w_q.shape[3], dtype=out_dtype)


@torch.library.custom_op(f"{NAMESPACE}::quantize_int8", mutates_args=(),
                         device_types="cuda")
def quantize_int8(x: Tensor, s: Tensor) -> Tensor:
    return fused_conv_int8.launch_quantize(x, s)


@quantize_int8.register_kernel("cpu")
def _(x, s):
    return fused_conv_int8.quantize_plain(x, s)


@quantize_int8.register_fake
def _(x, s):
    return torch.empty_like(x, dtype=torch.int8)


OPS = {f"{NAMESPACE}::{name}": op for name, op in (
    ("conv3x3_bn_relu", conv3x3_bn_relu),
    ("max_pool_2x2_argmax", max_pool_2x2_argmax),
    ("max_unpool_2x2", max_unpool_2x2),
    ("max_pool_2x2_phase", max_pool_2x2_phase),
    ("max_unpool_2x2_phase", max_unpool_2x2_phase),
    ("conv3x3_int8_block", conv3x3_int8_block),
    ("quantize_int8", quantize_int8))}


# --------------------------------------------------------------- programs

def op_counts(graph: torch.fx.Graph) -> collections.Counter:
    """{"camvid::conv3x3_bn_relu": n, "aten::convolution": m, ...}: the
    call nodes of ``graph`` (an ``ExportedProgram``'s ``.graph``) by op."""
    return collections.Counter(
        node.target.name() for node in graph.nodes
        if node.op == "call_function"
        and isinstance(node.target, torch._ops.OpOverload))


def load_program(path: str, device="cuda") -> torch.nn.Module:
    """The program that ``torch.export.save`` wrote to ``path``
    (``serving.Predictor.export_program``) as a module on ``device``: its
    state, its constants and the devices named in its graph all moved
    there. A CUDA device that is not there raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"load_program: device {device} requested but no "
                           f"CUDA device is available")
    program = torch.export.load(path)
    return torch.export.passes.move_to_device_pass(program, device).module()
