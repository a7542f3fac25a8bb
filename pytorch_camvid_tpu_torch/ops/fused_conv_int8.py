"""One int8 post-training-quantized conv3x3 block on a hand-written Hopper
kernel (``csrc/conv3x3_int8.cu``): the port of the JAX package's
``ops/quant.py::conv2d_int8`` (XLA's int8 conv with an int32 result,
quant.py:246) fused with ``quantized_block_apply``'s epilogue (quant.py:261):

    acc = conv3x3_pad1(x_q, w_q)                      int8 x int8 -> int32
    y   = relu(float(acc) * (s_x * s_w) + b_eff)      f32, each op rounded
    out = clip(round_half_even(y / s_out), -127, 127) int8, with ``s_out``
        = y in ``out_dtype`` (bf16 or f32)            otherwise

- ``conv3x3_int8_block`` is the wrapper: on a CPU tensor it runs
  ``conv3x3_int8_block_plain``; on a CUDA tensor ``launch`` launches the
  kernel (built with nvcc at first use, bound with ctypes) or raises;
  while tracing it is the op ``camvid::conv3x3_int8_block``
  (``ops/library.py``), whose CUDA kernel is ``launch``. Nothing falls
  back: a shape the kernel does not take, a failed build or a failed launch
  raises.
- ``conv3x3_int8_block_plain`` is the same function from stock PyTorch ops.
  Its int32 accumulator is ``F.conv2d`` in float64, exact since every
  partial sum is an integer below 2**53 (float32 is not: the sums reach
  ~1.5e8, past 2**24); its epilogue is the same f32 ops in the same order,
  the divisors as tensors on the data's device (a CUDA division by a CPU
  scalar multiplies by its reciprocal). The kernel equals it bit for bit.
- The kernel's paths (``int8_path``, the .cu's ``conv3x3_int8_path``):
  "wgmma" for Cin >= 32, "packed" for Cin < 32 (the Cin = 3 stem, narrow
  widths). Any Cout: the weights are zero-padded to the tile and the
  padded columns are not stored.
- The wgmma path reads x through TMA, whose strides are multiples of 16
  bytes: x comes with a pixel stride of ``pixel_stride(Cin)`` = 16 *
  ceil(Cin / 16) bytes, as the view ``[..., :Cin]`` of an (N,H,W,Cs)
  buffer (``empty_block_input``); ``block_input`` copies any other x into
  that layout in one pass, and ``quantize`` writes it itself. At Cin % 16
  == 0 it is the contiguous layout. The .cu derives the same stride from
  Cin (``conv3x3_int8_pixel_stride``) for its tensor maps.
- ``pack_weights`` repacks HWIO ``w_q`` once, K-major as the kernel reads
  it; the quantized block caches the result (``ops/conv.py``).
- ``quantize`` is the blocks' input quantize (clip(round(x / s)) to int8,
  JAX quant.py:275), where the input does not come as int8 from the
  producer: on CUDA the same source's one-pass kernel
  (``launch_quantize``; traced, the op ``camvid::quantize_int8``), on the
  CPU ``quantize_plain`` (stock ops: five passes over an f32 copy on the
  card).
- ``conv3x3_int8_block.launches`` counts kernel launches and
  ``.path_launches`` counts them per path; ``quantize.launches`` the
  quantize kernel's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from pytorch_camvid_tpu_torch.ops import cuda_build
from pytorch_camvid_tpu_torch.ops.fused_conv import aligned16

SOURCE = cuda_build.CSRC / "conv3x3_int8.cu"
QMAX = 127.0
PATHS = ("none", "wgmma", "packed")   # by the .cu's path code
OUT_MODES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
PACKED_MAX_CIN = 31


def int8_path(cin: int) -> str:
    """The kernel path that takes an input of ``cin`` channels: "packed"
    (Cin < 32: 9 taps x Cin packed into K), "wgmma" (Cin >= 32: TMA rows at
    ``pixel_stride(cin)``; the last k32 step takes TMA's zeros past Cin),
    "none" (Cin <= 0: the wrapper refuses it)."""
    if cin <= 0:
        return "none"
    return "packed" if cin <= PACKED_MAX_CIN else "wgmma"


def pixel_stride(cin: int) -> int:
    """The bytes from one pixel of x to the next that the kernel reads,
    Cs: 16 * ceil(Cin / 16) on the wgmma path (TMA's strides are multiples
    of 16 bytes; its packed weights' rows are as long), Cin on the packed
    path, 0 for none."""
    path = int8_path(cin)
    if path == "wgmma":
        return -(-cin // 16) * 16
    return cin if path == "packed" else 0


def packed_cin(cin: int) -> int:
    """The packed path's channels a pixel and a tap: Cin rounded up to a
    multiple of 4, so that one 32-bit A word is one pixel's 4 channels."""
    return -(-cin // 4) * 4


def packed_k(cin: int) -> int:
    """The packed path's K: 9 taps x ``packed_cin`` in whole k32 steps."""
    return -(-9 * packed_cin(cin) // 32) * 32


def quantize_plain(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 at scale ``s`` (a tensor on x's device):
    clip(round_half_even(x / s), -127, 127), from stock ops (JAX
    quant.py:275's order)."""
    return torch.clamp(torch.round(x.float() / s), -QMAX, QMAX).to(
        torch.int8)


def pack_weights(w_q: torch.Tensor) -> torch.Tensor:
    """HWIO int8 (3,3,Cin,Cout) -> the kernel's K-major layout: (9, Cout,
    Cs) on the wgmma path, Cs = ``pixel_stride(Cin)``, zero columns past
    Cin; (Cout, Kp) with k = tap * Cin4 + ci (Cin4 = ``packed_cin(Cin)``,
    each tap's channels zero-padded to it), zero-padded to
    ``packed_k(Cin)``, on the packed path."""
    cin, cout = w_q.shape[2], w_q.shape[3]
    path = int8_path(cin)
    if path == "wgmma":
        k = w_q.reshape(9, cin, cout).transpose(1, 2)
        return F.pad(k, (0, pixel_stride(cin) - cin)).contiguous()
    if path == "packed":
        c4 = packed_cin(cin)
        k = F.pad(w_q.reshape(9, cin, cout), (0, 0, 0, c4 - cin))
        k = k.reshape(9 * c4, cout).t()
        return F.pad(k, (0, packed_k(cin) - 9 * c4)).contiguous()
    raise ValueError(f"conv3x3_int8 takes Cin > 0, got Cin {cin}")


def block_strides(n: int, h: int, w: int, cin: int) -> tuple:
    """The strides of an (N,H,W,Cin) int8 block input in the kernel's
    layout: pixel stride ``pixel_stride(Cin)``."""
    cs = pixel_stride(cin)
    return (h * w * cs, w * cs, cs, 1)


def empty_block_input(shape, device) -> torch.Tensor:
    """An empty int8 tensor of ``shape`` (N,H,W,Cin) in the kernel's
    layout: the view ``[..., :Cin]`` of a new (N,H,W,Cs) buffer (the
    channels past Cin are never read), or contiguous where Cs = Cin."""
    n, h, w, cin = shape
    buf = torch.empty((n, h, w, pixel_stride(cin)), dtype=torch.int8,
                      device=device)
    return buf[..., :cin]


def block_input(x_q: torch.Tensor) -> torch.Tensor:
    """``x_q`` (N,H,W,Cin) int8 as the kernel reads it: as it is where it
    has ``block_strides`` and 16-byte aligned data (TMA, the packed path's
    16-byte loads), else copied once into ``empty_block_input``."""
    if (x_q.stride() == block_strides(*x_q.shape)
            and x_q.data_ptr() % 16 == 0):
        return x_q
    out = empty_block_input(x_q.shape, x_q.device)
    out.copy_(x_q)
    return out


def conv2d_int8(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 NHWC (N,H,W,Cin) x HWIO (3,3,Cin,Cout) -> int32 (N,H,W,Cout),
    SAME zero padding: F.conv2d in float64 (exact), rounded to integers."""
    y = F.conv2d(x_q.permute(0, 3, 1, 2).double(),
                 w_q.permute(3, 2, 0, 1).double(), padding=1)
    return y.round().permute(0, 2, 3, 1).to(torch.int32)


def conv3x3_int8_block_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                             s_w: torch.Tensor, s_x: torch.Tensor,
                             b_eff: torch.Tensor,
                             s_out: Optional[torch.Tensor] = None,
                             out_dtype: torch.dtype = torch.bfloat16
                             ) -> torch.Tensor:
    """The block from stock ops: x_q (N,H,W,Cin) int8, w_q (3,3,Cin,Cout)
    int8, s_w and b_eff (Cout,) f32, s_x and s_out f32 scalars (tensors).
    With ``s_out`` the output is int8, else ``out_dtype``."""
    return int8_epilogue(conv2d_int8(x_q, w_q), s_w, s_x, b_eff, s_out,
                         out_dtype)


def int8_epilogue(acc: torch.Tensor, s_w: torch.Tensor, s_x: torch.Tensor,
                  b_eff: torch.Tensor, s_out: Optional[torch.Tensor] = None,
                  out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The plain version's epilogue on the int32 accumulator ``acc``:
    dequantize, add the folded bias, ReLU, then requantize at ``s_out`` or
    cast to ``out_dtype``."""
    y = torch.relu(acc.float() * (s_x * s_w) + b_eff)
    if s_out is not None:
        return quantize_plain(y, s_out)
    return y.to(out_dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(cuda_build.load(SOURCE))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C entry points of a library built from ``conv3x3_int8.cu`` (or
    an edit of it, chip_faults.py), typed. The rule entries
    (``conv3x3_int8_path``, ``_packed_k``, ``_pixel_stride``: int -> int)
    keep ctypes' default types, so a library from before the padded layout
    (``int8_variants --parent``), which has no ``_pixel_stride``, binds
    too."""
    lib.conv3x3_int8.argtypes = [ctypes.c_void_p] * 7 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.conv3x3_int8.restype = ctypes.c_int
    lib.quantize_int8.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.quantize_int8.restype = ctypes.c_int
    return lib


def kernel_path(cin: int) -> str:
    """The path the built library takes for ``cin`` (``int8_path``'s rule
    as the .cu holds it; chip_smoke checks that the two agree)."""
    return PATHS[_library().conv3x3_int8_path(cin)]


def kernel_packed_k(cin: int) -> int:
    return _library().conv3x3_int8_packed_k(cin)


def kernel_pixel_stride(cin: int) -> int:
    """``pixel_stride``'s rule as the .cu holds it (its tensor maps' x
    stride; chip_smoke checks that the two agree)."""
    return _library().conv3x3_int8_pixel_stride(cin)


def _check(x_q, w_q, s_w, s_x, b_eff, s_out, out_dtype, packed):
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"conv3x3_int8 takes int8 x and w, got {x_q.dtype} "
                        f"and {w_q.dtype}")
    if x_q.dim() != 4:
        raise ValueError(f"x must be (N,H,W,Cin), got {tuple(x_q.shape)}")
    cin = x_q.shape[3]
    if w_q.dim() != 4 or tuple(w_q.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be (3,3,{cin},Cout) HWIO, got "
                         f"{tuple(w_q.shape)}")
    cout = w_q.shape[3]
    for name, t, shape in (("s_w", s_w, (cout,)), ("b_eff", b_eff, (cout,)),
                           ("s_x", s_x, ()),
                           ("s_out", s_out, ())):
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be f32 of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if out_dtype not in OUT_MODES:
        raise TypeError(f"conv3x3_int8 emits int8, bf16 or f32, not "
                        f"{out_dtype}")
    if (out_dtype == torch.int8) != (s_out is not None):
        raise ValueError("conv3x3_int8 emits int8 exactly when s_out is "
                         "given")
    path = int8_path(cin)
    if path == "none":
        raise ValueError(f"conv3x3_int8 takes Cin > 0, got Cin {cin}")
    want = ((9, cout, pixel_stride(cin)) if path == "wgmma"
            else (cout, packed_k(cin)))
    if packed.dtype != torch.int8 or tuple(packed.shape) != want:
        raise ValueError(f"packed weights must be int8 {want} "
                         f"(pack_weights), got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    for name, t in (("x", x_q), ("packed", packed), ("s_w", s_w),
                    ("b_eff", b_eff), ("s_x", s_x), ("s_out", s_out)):
        if t is None:
            continue
        if t.device != x_q.device:
            raise ValueError(f"{name} is on {t.device}, x on {x_q.device}")
        if t is not x_q and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if min(x_q.shape) == 0 or max(*x_q.shape, 9 * pixel_stride(cin) * cout
                                  ) >= 2 ** 31:
        raise ValueError(f"unsupported shape x {tuple(x_q.shape)}, Cout "
                         f"{cout}")
    if packed.data_ptr() % 16:
        raise ValueError("the packed weights must be 16-byte aligned (TMA)")


def conv3x3_int8_block(x_q: torch.Tensor, w_q: torch.Tensor,
                       s_w: torch.Tensor, s_x: torch.Tensor,
                       b_eff: torch.Tensor,
                       s_out: Optional[torch.Tensor] = None,
                       out_dtype: torch.dtype = torch.bfloat16,
                       packed: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The quantized block: ``conv3x3_int8_block_plain``'s function. On a
    CPU tensor it is the plain version; on a CUDA tensor ``launch`` on
    ``packed`` (``pack_weights(w_q)``, made when not given). While tracing
    it is the op ``camvid::conv3x3_int8_block`` (``ops/library.py``),
    whose kernels are those two."""
    if torch.compiler.is_compiling():
        if packed is None:
            packed = pack_weights(w_q)
        return torch.ops.camvid.conv3x3_int8_block(
            x_q, w_q, packed, s_w, s_x, b_eff, s_out, out_dtype)
    if x_q.device.type == "cpu":
        return conv3x3_int8_block_plain(x_q, w_q, s_w, s_x, b_eff, s_out,
                                        out_dtype)
    return launch(x_q, w_q, packed, s_w, s_x, b_eff, s_out, out_dtype)


def launch(x_q: torch.Tensor, w_q: torch.Tensor,
           packed: Optional[torch.Tensor], s_w: torch.Tensor,
           s_x: torch.Tensor, b_eff: torch.Tensor,
           s_out: Optional[torch.Tensor],
           out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel on CUDA tensors, or raises. An x that is not in the
    kernel's layout (``block_input``: at Cin % 16 != 0 from 32 a contiguous
    x, or a batch view whose data is not 16-byte aligned) is copied into it
    first. Counts the launch."""
    if x_q.device.type != "cuda":
        raise ValueError(f"conv3x3_int8: no kernel for {x_q.device}")
    if packed is None:
        packed = pack_weights(w_q)
    packed = aligned16(packed)
    _check(x_q, w_q, s_w, s_x, b_eff, s_out, out_dtype, packed)
    x_q = block_input(x_q)
    n, h, w, cin = x_q.shape
    cout = w_q.shape[3]
    lib = _library()
    with torch.cuda.device(x_q.device):
        out = torch.empty((n, h, w, cout), dtype=out_dtype,
                          device=x_q.device)
        err = lib.conv3x3_int8(
            x_q.data_ptr(), packed.data_ptr(), s_w.data_ptr(),
            b_eff.data_ptr(), s_x.data_ptr(),
            s_out.data_ptr() if s_out is not None else None,
            out.data_ptr(), OUT_MODES[out_dtype], n, h, w, cin, cout,
            torch.cuda.current_stream(x_q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_int8 kernel launch failed: CUDA error "
                           f"{err} at x {tuple(x_q.shape)}, Cout {cout}")
    conv3x3_int8_block.launches += 1
    conv3x3_int8_block.path_launches[int8_path(cin)] += 1
    return out


_QUANTIZE_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def quantized_layout(shape, device) -> torch.Tensor:
    """An empty int8 tensor of ``shape`` in the layout ``quantize``
    returns: a 4-D (N,H,W,C) one as a block input
    (``empty_block_input``), any other contiguous."""
    if len(shape) == 4:
        return empty_block_input(shape, device)
    return torch.empty(shape, dtype=torch.int8, device=device)


def quantize_cpu(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``quantize_plain`` in ``quantized_layout`` (a 4-D result copied
    into it where its pixel stride differs)."""
    q = quantize_plain(x, s)
    return block_input(q) if q.dim() == 4 else q


def quantize(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``quantize_plain``'s function in ``quantized_layout``, so that an
    (N,H,W,Cin) result is the int8 block's input as the kernel reads it: on
    a CPU tensor the plain version (``quantize_cpu``); on a CUDA tensor
    ``launch_quantize``. While tracing it is the op
    ``camvid::quantize_int8`` (``ops/library.py``)."""
    if torch.compiler.is_compiling():
        return torch.ops.camvid.quantize_int8(x, s)
    if x.device.type == "cpu":
        return quantize_cpu(x, s)
    return launch_quantize(x, s)


def launch_quantize(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The quantize kernel of the int8 source on a CUDA x (bf16 or f32, any
    shape), one pass, or raises: the result in ``quantized_layout`` (a 4-D
    x's pixels written at ``pixel_stride(C)``). An x whose data is not
    16-byte aligned is copied first (``aligned16``). Counts the launch."""
    if x.device.type != "cuda":
        raise ValueError(f"quantize: no kernel for {x.device}")
    if x.dtype not in _QUANTIZE_DTYPES:
        raise TypeError(f"the quantize kernel takes bf16 or f32, got "
                        f"{x.dtype}")
    if s.dtype != torch.float32 or s.dim() != 0 or s.device != x.device:
        raise ValueError(f"s must be an f32 scalar on {x.device}, got "
                         f"{s.dtype} {tuple(s.shape)} on {s.device}")
    if not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"quantize takes a contiguous, non-empty x, got "
                         f"{tuple(x.shape)}")
    x = aligned16(x)
    c = x.shape[-1] if x.dim() else 1
    with torch.cuda.device(x.device):
        out = quantized_layout(x.shape, x.device)
        err = _library().quantize_int8(
            x.data_ptr(), s.data_ptr(), out.data_ptr(), x.numel(), c,
            out.stride(-2) if x.dim() == 4 else c,
            _QUANTIZE_DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize kernel launch failed: CUDA error "
                           f"{err} at x {tuple(x.shape)} {x.dtype}")
    quantize.launches += 1
    return out


def reset_launches() -> None:
    conv3x3_int8_block.launches = 0
    conv3x3_int8_block.path_launches = dict.fromkeys(PATHS[1:], 0)
    quantize.launches = 0


reset_launches()
