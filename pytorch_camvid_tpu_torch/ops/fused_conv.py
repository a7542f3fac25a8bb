"""Fused conv3x3(pad 1) + folded BatchNorm + ReLU: the serving block.

Counterpart of ``pytorch_camvid_tpu/ops/pallas_conv.py`` (the TPU kernel
``_conv3x3_impl`` / ``_conv_kernel``). In eval mode BatchNorm is a
per-channel affine of the conv output, so the block is one pass:

    out = relu( conv3x3(x, W) * A + B ),   A = gamma / sqrt(var + eps)
                                           B = (b - mean) * A + beta

- ``conv3x3_bn_relu`` is the dispatching wrapper. A CUDA tensor goes to the
  hand-written Hopper kernel (``csrc/conv3x3_bn_relu.cu``) through
  ``launch``, built with nvcc at first use and bound with ctypes; a CPU
  tensor goes to the plain version; a traced call becomes the op
  ``camvid::conv3x3_bn_relu`` (``ops/library.py``), whose CUDA kernel is
  ``launch``. Nothing falls back: a failed build or launch raises.
  ``flip=True`` computes the input gradient of a conv with weights ``w``
  (the taps reversed and the channel axes swapped, read in place by the
  kernel): the training conv's dx (``ops/conv_train.py``).
- The source has three paths, chosen by ``conv_path(Cin, Cout)`` (the
  .cu's ``conv3x3_bn_relu_path`` holds the same rule): "wgmma" (wgmma fed
  by TMA, for Cin % 8 == 0 with Cout % 8 == 0 above 16, or with Cout <=
  ``HEAD_MAX_COUT`` = 24 and Cin <= ``RES_MAX_CIN`` = 128 on the head
  tile: the 12- and 21-class heads), "packed" (Cin % 8 != 0 with 9 * Cin
  <= ``K_MAX`` = 192 and Cout % 8 == 0: the Cin = 3 stem and the heads'
  dx with Cin = 12 and 21, on the 9 taps x Cin packed into K with weights
  resident per block) and "narrow" (the first mma.sync design, for what
  neither takes, e.g. 64->28; no model runs it).
- float32 x and w go to a second source, ``csrc/conv3x3_f32.cu``: an
  implicit GEMM on split-TF32 tensor-core products (each operand split
  into a TF32 high part and residual, three products summed), f32 in and
  out, with the same contract (``flip``, a, b, ``relu``). It is the f32
  instance of K4 (``pallas_conv.py`` emits x's dtype), on three routes
  (``f32_route``, the .cu's ``conv3x3_f32_route``): "f32", wgmma fed by
  TMA where TMA can describe x (Cin % 4 == 0), its weights split once per
  call into K-major hi and lo copies (``split_weights_plain`` is that
  step's plain version) in a workspace the wrapper allocates;
  "f32_packed", wgmma with 9 taps x Cin packed into K <= ``K_MAX`` = 192
  (Cin % 4 != 0: the Cin = 3 stem, VOC's Cin = 21 dx; the same split
  weights, resident per block; plan ``f32_packed_fwd_plan``); and
  "f32_narrow", the first split-TF32 ``mma.sync`` design, for the rest
  (Cin % 4 != 0 past 21, e.g. 23; no model runs it).
- ``conv3x3_bn_relu_plain`` is the same function from stock PyTorch ops.
  The CPU tests run it, and the card check compares the kernel with it.
- ``conv3x3_bn_relu.launches`` counts kernel launches, and
  ``conv3x3_bn_relu.path_launches`` counts them per route (the bf16
  source's three paths and the three f32 routes), so a run can show that
  its main path went through the kernel.

Tolerance against the JAX package's unfused eval path: JAX computes
``(conv + b - mean) * inv + bias`` (pytorch_camvid_tpu/ops/conv.py:195-198)
while this block computes ``conv * A + B`` with A and B folded once. The two
are algebraically equal and differ only in f32 rounding, a few ulps of the
largest intermediate per block, which sets the CPU tolerance between the JAX
``use_pallas=False`` model and the port (tests/test_torch_unet_serving.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from pytorch_camvid_tpu_torch.ops import cuda_build

BN_EPS = 1e-5  # torch.nn.BatchNorm2d default

SOURCE = cuda_build.CSRC / "conv3x3_bn_relu.cu"
F32_SOURCE = cuda_build.CSRC / "conv3x3_f32.cu"
PATHS = ("narrow", "wgmma", "packed")   # by the .cu's path code
F32_ROUTES = ("f32_narrow", "f32", "f32_packed")   # by the .cu's route code
ROUTES = PATHS + ("f32", "f32_narrow", "f32_packed")   # the counters' keys
RES_MAX_CIN = 128   # the wgmma head tile keeps 9 x Cin x N weights
HEAD_MAX_COUT = 24  # the head tile's widest N
K_MAX = 192         # the packed path's K: 9 taps x Cin


def conv_path(cin: int, cout: int) -> str:
    """The kernel path that takes a (Cin, Cout) call: "wgmma" where TMA can
    describe the input (Cin % 8 == 0) and either the weights (Cout % 8 ==
    0, above 16) or Cout <= HEAD_MAX_COUT with Cin <= RES_MAX_CIN (the head
    tile, its weights resident: the 64->12 and 64->21 heads); "packed"
    where Cin % 8 != 0, 9 * Cin <= K_MAX and Cout % 8 == 0 (the stem, the
    heads' dx); "narrow" otherwise."""
    if cin % 8 == 0:
        if cout <= HEAD_MAX_COUT and cin <= RES_MAX_CIN:
            return "wgmma"
        return "wgmma" if cout > 16 and cout % 8 == 0 else "narrow"
    return "packed" if 9 * cin <= K_MAX and cout % 8 == 0 else "narrow"


def head_tile_plan(cout: int) -> dict:
    """The wgmma path's head tile at Cout <= HEAD_MAX_COUT (the .cu's
    ``Tile<N>`` with N = ``n``, 16 up to 16 channels and 24 above): MT = 4
    m64 tiles a consumer warpgroup, so TH = 32 output rows a tile and
    ``accumulators`` = 4 x N / 2 a consumer thread; shared memory: two
    patch stages of (32 + 2) x 18 pixels x 128 B (78,336 B of TMA box,
    rounded up to 1,024), the resident weights 9 x RES_MAX_CIN x N bf16,
    two mbarriers a patch stage and 1,024 B of alignment slack: the figures
    the source's ``static_assert``s hold."""
    if cout > HEAD_MAX_COUT:
        raise ValueError(f"Cout {cout} is past the head tile's "
                         f"{HEAD_MAX_COUT}")
    n = 16 if cout <= 16 else 24
    patch = -(-34 * 18 * 128 // 1024) * 1024
    weights = 9 * RES_MAX_CIN * n * 2
    return {"n": n, "mt": 4, "th": 32, "accumulators": 4 * n // 2,
            "patch_bytes": patch, "weight_bytes": weights,
            "bytes": 2 * patch + weights + 2 * 2 * 8 + 1024}


def packed_fwd_plan(cin: int) -> dict:
    """The packed path's plan at ``cin`` (the .cu's ``Geo<CIN>``): K = 9 x
    Cin packed tap-major, ``kp`` padded to whole k16 steps (``ksteps``);
    the patch row of (32 + 2) x Cin elements at a stride of ``row_stride``
    (rounded up to 8); shared memory: eight warps' output staging rows (32
    pixels x 128 B), the resident K x 64 weights at a row stride of 72,
    two patch buffers of (8 + 2) rows and 8 zero rows (what the padded k
    read), the affine's 2 x 64 floats, past Cin 12 the A offsets' table
    (``table``: 8 B a k16 step and lane column, where up to Cin 12 they
    stay in registers) and 1,024 B of alignment slack: the figures the
    source's ``static_assert``s hold. Two blocks an SM."""
    if cin % 8 == 0 or 9 * cin > K_MAX:
        raise ValueError(f"Cin {cin} is not on the packed path")
    kp = -(-9 * cin // 16) * 16
    stride = -(-34 * cin // 8) * 8
    buf = (10 + 8) * stride
    table = kp // 16 * 4 * 8 if cin > 12 else 0
    nbytes = (8 * 32 * 128 + kp * 72 * 2 + 2 * buf * 2 + 2 * 64 * 4 + table
              + 1024)
    return {"k": 9 * cin, "kp": kp, "ksteps": kp // 16,
            "row_stride": stride, "table_bytes": table, "blocks_per_sm": 2,
            "bytes": nbytes}


def f32_route(cin: int, cout: int) -> str:
    """The f32 forward's route at (Cin, Cout): "f32" (wgmma + TMA) where TMA
    can describe x, Cin % 4 == 0; "f32_packed" (wgmma, 9 x Cin packed into
    K) where 9 * Cin <= K_MAX; "f32_narrow" (mma.sync) otherwise."""
    if cin % 4 == 0:
        return "f32"
    return "f32_packed" if 9 * cin <= K_MAX else "f32_narrow"


def route(dtype: torch.dtype, cin: int, cout: int) -> str:
    """The kernel that takes a (Cin, Cout) call at ``dtype``: the f32
    source's ``f32_route`` for float32, else the bf16 source's
    ``conv_path``."""
    return (f32_route(cin, cout) if dtype == torch.float32
            else conv_path(cin, cout))


def f32_tile_n(cout: int) -> int:
    """The f32 wgmma forward's N tile for Cout (the .cu's ``tile_n``): 16
    for the 12-class head, 24 for VOC's 21, 64, else 128 (three 64 x N
    accumulators a thread, the running one and two scratch, leave no room
    for 256)."""
    return 16 if cout <= 16 else 24 if cout <= 24 else 64 if cout <= 64 \
        else 128


def f32_fwd_plan(bn: int) -> dict:
    """The f32 wgmma forward's shared memory at tile N ``bn``: two patch
    stages of (8 + 2) x 18 pixels x 32 channels (23,040 B of TMA box,
    rounded up to 1,024), weight stages of one (tap, 32-channel chunk) hi
    box and lo box of bn x 128 B (4 stages at N = 128, else 6), two
    mbarriers a stage and 1,024 B of alignment slack: the figures the
    source's ``Plan`` computes and its ``static_assert``s hold."""
    patch = -(-10 * 18 * 128 // 1024) * 1024
    w_tx = 2 * bn * 128
    stages = 4 if bn == 128 else 6
    return {"patch_bytes": patch, "w_stage_bytes": w_tx, "w_stages": stages,
            "bytes": 2 * patch + stages * w_tx + 16 * (2 + stages) + 1024}


def f32_packed_fwd_plan(cin: int) -> dict:
    """The f32 packed forward's plan at ``cin`` (the .cu's ``pk::fwd_smem``
    and the kernel's template): K = 9 x Cin packed tap-major, k = (3 dy +
    dx) Cin + c, zero-padded to ``groups`` step sums of four k8 steps
    (``kp`` = 32 x groups: 32 at the stem, 192 at Cin 21); N = 64 output
    channels a block; tiles of 8 rows x 16 columns. Shared memory: 1,024 B
    of alignment slack; the eight consumer warps' output rows staged for
    their TMA stores (16 pixels x 64 channels, 4,096 B each); the resident
    B, hi and lo, kp x 64 f32 each (16 KiB at the stem, 96 at Cin 21);
    ``stages`` (4) raw stages of the tile's 10 patch rows as they lie in x
    (``raw_bytes``: each row the 16-byte chunks that 18 x Cin elements
    span at any alignment); the zeros a padded k reads (32 x Cin + 16 B);
    the affine's 2 x 64 floats; the A offsets' table, 8 bytes a k8 step
    and lane column; two mbarriers a stage: the figures the source's
    ``static_assert``s hold. One block an SM."""
    if f32_route(cin, 64) != "f32_packed":
        raise ValueError(f"Cin {cin} is not on the f32 packed route")
    groups = -(-9 * cin // 32)
    raw = 10 * ((18 * cin + 2) // 4 + 1) * 16
    b = 2 * 4 * groups * 64 * 32
    table = 4 * groups * 4 * 8
    return {"k": 9 * cin, "kp": 32 * groups, "groups": groups, "n": 64,
            "b_bytes": b, "stages": 4, "raw_bytes": raw,
            "table_bytes": table,
            "bytes": 1024 + 8 * 4096 + b + 4 * raw + 32 * cin + 16 + 2 * 64 * 4
            + table + 2 * 4 * 8}


def tf32_rna_bits(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on f32 ``v``, by integer operations on its
    bits: the magnitude rounded to 10 mantissa bits, ties away from zero
    (add half of the 13 dropped bits' range, then clear them)."""
    u = v.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def split_weights_plain(w: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """The f32 forward's weights as its wgmma route reads them: (2, Cout, 9,
    Cin), [0] the TF32 hi parts, [1] the lo parts (``tf32_rna_bits`` of v
    and of v - hi), K-major: [h][n][t][c] from w (3,3,Cin,Cout), or with
    ``flip`` from the tap-reversed transpose of w (3,3,Cout,Cin), w[8 -
    t][n][c] (K1's dx). The plain version of the source's
    ``split_weights_kernel``."""
    w = w.float()
    if flip:
        kmaj = w.flip((0, 1)).reshape(9, w.shape[2], w.shape[3])
    else:
        kmaj = w.reshape(9, w.shape[2], w.shape[3]).transpose(1, 2)
    kmaj = kmaj.transpose(0, 1).contiguous()   # (Cout, 9, Cin)
    hi = tf32_rna_bits(kmaj)
    return torch.stack([hi, tf32_rna_bits(kmaj - hi)])


def flipped(w: torch.Tensor) -> torch.Tensor:
    """(3,3,Cout,Cin) -> the (3,3,Cin,Cout) weight of the conv that
    ``flip=True`` computes: taps reversed, channel axes swapped (a copy;
    the plain version's, the kernel reads ``w`` in place)."""
    return w.flip((0, 1)).transpose(2, 3)


def fold_bn_affine(b: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor,
                   eps: float = BN_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold conv bias ``b`` and BN (``scale``=gamma, ``bias``=beta, running
    ``mean``/``var``) into the per-channel (A, B), in f32."""
    b, scale, bias, mean, var = (t.float() for t in (b, scale, bias, mean,
                                                     var))
    a = scale * torch.rsqrt(var + eps)
    return a, (b - mean) * a + bias


def conv3x3_bn_relu_plain(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                          b: torch.Tensor, relu: bool = True,
                          flip: bool = False) -> torch.Tensor:
    """relu(conv3x3_pad1(x, w) * a + b) from stock ops. x: (N,H,W,Cin);
    w: (3,3,Cin,Cout) HWIO, or with ``flip`` (3,3,Cout,Cin) taken as
    ``flipped(w)``; a, b: (Cout,) f32. Returns (N,H,W,Cout) in x's dtype;
    the conv runs in x's dtype, the epilogue in f32."""
    if flip:
        w = flipped(w)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 padding=1)
    y = y.permute(0, 2, 3, 1).float() * a + b
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    fn = lib.conv3x3_bn_relu_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.conv3x3_bn_relu_path.argtypes = [ctypes.c_int] * 2
    lib.conv3x3_bn_relu_path.restype = ctypes.c_int
    return lib


@functools.cache
def f32_library() -> ctypes.CDLL:
    """``csrc/conv3x3_f32.cu`` built and bound: the f32 forward (K4, K1 fwd
    and dx) and the f32 dW (K1's, ``conv_train``) with its tile counts."""
    return bind_f32(cuda_build.load(F32_SOURCE))


def bind_f32(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C entry points of a library built from ``conv3x3_f32.cu`` (or
    an edit of it, ``f32_variants``), typed."""
    lib.conv3x3_bn_relu_f32.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.conv3x3_bn_relu_f32.restype = ctypes.c_int
    lib.conv3x3_wgrad_f32.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.conv3x3_wgrad_f32.restype = ctypes.c_int
    lib.conv3x3_bn_relu_f32_narrow.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.conv3x3_bn_relu_f32_narrow.restype = ctypes.c_int
    lib.conv3x3_wgrad_f32_narrow.argtypes = \
        lib.conv3x3_wgrad_f32.argtypes
    lib.conv3x3_wgrad_f32_narrow.restype = ctypes.c_int
    for name, n, res in (("conv3x3_f32_route", 3, ctypes.c_int),
                         ("conv3x3_f32_tile_n", 1, ctypes.c_int),
                         ("conv3x3_bn_relu_f32_ws_floats", 2,
                          ctypes.c_longlong),
                         ("conv3x3_wgrad_f32_pixel_tiles", 5,
                          ctypes.c_longlong),
                         ("conv3x3_wgrad_f32_out_tiles", 2,
                          ctypes.c_longlong)):
        getattr(lib, name).argtypes = [ctypes.c_int] * n
        getattr(lib, name).restype = res
    return lib


def f32_kernel_route(cin: int, cout: int, wgrad: bool = False) -> str:
    """The f32 route the built library takes for (Cin, Cout), of the
    forward or (``wgrad``) the dW (``f32_route``'s and
    ``conv_train.wgrad_f32_route``'s rules as the .cu holds them;
    chip_smoke checks that they agree)."""
    return F32_ROUTES[f32_library().conv3x3_f32_route(cin, cout,
                                                       int(wgrad))]


def kernel_path(cin: int, cout: int) -> str:
    """The path the built library takes for (Cin, Cout) (``conv_path``'s
    rule as the .cu holds it; chip_smoke checks that the two agree)."""
    return PATHS[_library().conv3x3_bn_relu_path(cin, cout)]


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` as it is when its data starts on a 16-byte boundary, else a
    copy that does. A batch slice such as ``x[1:]`` keeps its storage
    offset through ``.contiguous()``, and the wgmma paths' TMA and the
    packed paths' 16-byte loads need aligned bases; the copy is a fresh
    allocation, which the caching allocator aligns."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(x, w, a, b, flip=False):
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x.dtype:
        raise TypeError(f"conv3x3_bn_relu kernel takes bf16 or f32 x and w "
                        f"of one dtype, got {x.dtype} and {w.dtype}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("conv3x3_bn_relu kernel takes f32 a and b")
    if x.dim() != 4:
        raise ValueError(f"x must be (N,H,W,Cin), got {tuple(x.shape)}")
    cin = x.shape[3]
    cdim = 3 if flip else 2   # the axis of w that holds Cin
    if w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or w.shape[cdim] != cin:
        raise ValueError(
            f"w must be " + (f"(3,3,Cout,{cin}) with flip" if flip
                             else f"(3,3,{cin},Cout) HWIO")
            + f", got {tuple(w.shape)}")
    cout = w.shape[5 - cdim]
    if a.shape != (cout,) or b.shape != (cout,):
        raise ValueError(f"a and b must be ({cout},)")
    for name, t in (("x", x), ("w", w), ("a", a), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (x in NHWC)")
    if min(x.shape) == 0 or max(*x.shape, 9 * cin * cout) >= 2 ** 31:
        raise ValueError(f"unsupported shape x {tuple(x.shape)}, "
                         f"Cout {cout}")
    if x.dtype == torch.float32:
        if x.shape[0] * x.shape[1] * x.shape[2] >= 2 ** 31 - 128:
            raise ValueError(f"the f32 kernel takes fewer than 2**31 - 128 "
                             f"pixels, got x {tuple(x.shape)}")
        return   # aligned16 gave TMA and the packed route's 16-byte
                 # loads their bases (narrow: any)
    path = conv_path(cin, cout)
    if path == "wgmma" and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("x and w must be 16-byte aligned (TMA)")
    if path == "packed" and x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the packed path reads "
                         "its rows in 16-byte vectors)")


def conv3x3_bn_relu(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, relu: bool = True,
                    flip: bool = False) -> torch.Tensor:
    """Fused relu(conv3x3_pad1(x, w) * a + b). x: (N,H,W,Cin) NHWC
    contiguous; w: (3,3,Cin,Cout) HWIO contiguous, or with ``flip``
    (3,3,Cout,Cin), the weights of the conv whose input gradient this is;
    a, b: (Cout,) f32.

    On a CPU tensor this is ``conv3x3_bn_relu_plain``. On a CUDA tensor it
    is ``launch``. While tracing (``torch.export``) it is the op
    ``camvid::conv3x3_bn_relu`` (``ops/library.py``), whose kernels are
    those two, so the program holds one node for the call."""
    if torch.compiler.is_compiling():
        return torch.ops.camvid.conv3x3_bn_relu(x, w, a, b, relu, flip)
    if x.device.type == "cpu":
        return conv3x3_bn_relu_plain(x, w, a, b, relu, flip)
    return launch(x, w, a, b, relu, flip)


def launch(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
           b: torch.Tensor, relu: bool, flip: bool) -> torch.Tensor:
    """The kernel on CUDA tensors, or raises: bf16 x and w (f32
    accumulation, bf16 out) on ``conv_path(Cin, Cout)``; f32 x and w
    (split-TF32 products, f32 out) on the f32 kernel. An x or w whose data
    is not 16-byte aligned is copied first (``aligned16``). Counts the
    launch."""
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_bn_relu: no kernel for {x.device}")
    x, w = aligned16(x), aligned16(w)
    _check(x, w, a, b, flip)
    n, h, wd, cin = x.shape
    cout = a.shape[0]
    if x.dtype == torch.float32:
        out = _f32_launch(x, w, a, b, relu, flip)
        conv3x3_bn_relu.launches += 1
        conv3x3_bn_relu.path_launches[f32_route(cin, cout)] += 1
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        out = torch.empty((n, h, wd, cout), dtype=torch.bfloat16,
                          device=x.device)
        err = lib.conv3x3_bn_relu_bf16(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, h, wd, cin, cout, int(relu), int(flip),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_bn_relu kernel launch failed: CUDA "
                           f"error {err} at x {tuple(x.shape)}, Cout {cout}")
    conv3x3_bn_relu.launches += 1
    conv3x3_bn_relu.path_launches[conv_path(cin, cout)] += 1
    return out


def _f32_launch(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, relu: bool, flip: bool) -> torch.Tensor:
    """One call of the f32 forward on checked CUDA inputs (on the wgmma
    and packed routes the weights' split, then the conv); raises on a CUDA
    error."""
    n, h, wd, cin = x.shape
    cout = a.shape[0]
    lib = f32_library()
    with torch.cuda.device(x.device):
        out = torch.empty((n, h, wd, cout), dtype=torch.float32,
                          device=x.device)
        floats = lib.conv3x3_bn_relu_f32_ws_floats(cin, cout)
        ws = (torch.empty(floats, dtype=torch.float32, device=x.device)
              if floats else None)
        err = lib.conv3x3_bn_relu_f32(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), ws.data_ptr() if ws is not None else None, n, h,
            wd, cin, cout, int(relu), int(flip),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_bn_relu f32 kernel launch failed: CUDA "
                           f"error {err} at x {tuple(x.shape)}, Cout {cout}")
    return out


def reset_launches() -> None:
    conv3x3_bn_relu.launches = 0
    conv3x3_bn_relu.path_launches = dict.fromkeys(ROUTES, 0)


reset_launches()
