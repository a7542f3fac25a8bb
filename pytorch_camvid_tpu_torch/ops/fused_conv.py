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
  resident per block) and "narrow" for what neither takes: UNet at width
  9/16's seven blocks of 36 channels (and six of their dx), a head past 24
  classes off a multiple of 8 (64->150 and its dx), 64->28. It is wgmma
  with A gathered into registers from raw 16-byte chunks of x's rows at
  a table's offsets of K = 9 x Cin packed, N = Cout rounded up to 8,
  weights resident per block, output rows written in 16-byte chunks (plan
  ``narrow_fwd_plan``); where its plan holds no tile (Cin past ~330) the
  first, mma.sync design takes the call (``conv3x3_bn_relu.
  mma_sync_launches`` counts the calls the C entry reports it took).
- float32 x and w go to a second source, ``csrc/conv3x3_f32.cu``: an
  implicit GEMM on split-TF32 tensor-core products (each operand split
  into a TF32 high part and residual, three products summed), f32 in and
  out, with the same contract (``flip``, a, b, ``relu``). It is the f32
  instance of K4 (``pallas_conv.py`` emits x's dtype), on two routes
  (``f32_route``, the .cu's ``conv3x3_f32_route``): "f32_packed", wgmma
  with 9 taps x Cin packed into K <= ``K_MAX`` = 192 (Cin % 4 != 0: the
  Cin = 3 stem, VOC's Cin = 21 dx; the split weights resident per block;
  plan ``f32_packed_fwd_plan``); and "f32" for the rest, wgmma fed by TMA
  over x at a pixel stride of 4 ceil(Cin / 4): where Cin % 4 != 0 (the
  23- and 150-class heads' dx) x goes as its padded copy
  (``pad_channels``, the .cu's ``pad_channels_kernel``; zeros past Cin;
  ``f32_pads_input``), made here or handed in (``xp``: conv_train shares
  one copy of a cotangent between dx and dW). Both routes split the
  weights once per call into K-major hi and lo copies at x's pixel stride
  (``split_weights_plain`` is that step's plain version) in a workspace
  the wrapper allocates.
- ``conv3x3_bn_relu_plain`` is the same function from stock PyTorch ops.
  The CPU tests run it, and the card check compares the kernel with it.
- ``conv3x3_bn_relu.launches`` counts kernel launches, and
  ``conv3x3_bn_relu.path_launches`` counts them per route (the bf16
  source's three paths and the two f32 routes), so a run can show that
  its main path went through the kernel; ``pad_channels.launches`` counts
  the padded copies.

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
F32_ROUTES = {1: "f32", 2: "f32_packed"}   # by the .cu's route code
ROUTES = PATHS + ("f32", "f32_packed")   # the counters' keys
RES_MAX_CIN = 128   # the wgmma head tile keeps 9 x Cin x N weights
HEAD_MAX_COUT = 24  # the head tile's widest N
K_MAX = 192         # the packed path's K: 9 taps x Cin
NARROW_BNS = (16, 24, 32, 40, 48, 64, 80, 96, 128)   # the narrow N tiles
NARROW_MAX_N = 128
NARROW_MAX_N_MT2 = 40   # the widest N at two m64s a warpgroup
NARROW_MAX_STAGES = 2   # patch stages: one tile in flight
SMEM_MAX = 232448   # a block's shared memory on the H100
SMEM_SM = 233472    # an SM's, 1,024 of it reserved a block
F32_MAX_PIXELS = 2 ** 31 - 128   # N*H*W below it (the .cu's kMaxPixels)


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


@functools.cache
def narrow_fwd_plan(cin: int, cout: int) -> dict:
    """The narrow path's plan at (Cin, Cout) (the .cu's ``narrow::plan``):
    tiles of 8 x ``mt`` rows x 16 columns (``mt`` m64s a warpgroup: 2
    where N <= ``NARROW_MAX_N_MT2`` and two patch stages fit, else 1), K =
    9 x Cin packed tap-major to ``kp`` (whole pairs of 2-step wgmma groups,
    ``ksteps``); N tile ``bn``, the least of ``NARROW_BNS`` that holds
    ceil(Cout / ``tiles_n``) channels, starting from tiles_n = ceil(Cout /
    ``NARROW_MAX_N``) and splitting further until a block's shared memory
    (232,448 B) holds: ``stages`` patch stages (as many as fit, up to
    ``NARROW_MAX_STAGES``, at ``blocks_per_sm`` two where bn <= 80 and
    each holds two, else one) of 8 mt + 2 rows x (18 x Cin + 21)
    elements (``stage_bytes``), the resident kp x bn weights, the A
    offsets' table (8 B a k16 step and lane column, 16 at odd Cin), the
    affine's 2 x bn floats and a zero word, eight warps' output rows of 16
    pixels at a pixel stride ``ops`` (Cout in one tile, else bn up to the
    next of Cout mod 8), each region rounded to 128 B: the figures the
    source's ``static_assert``s hold. None where no tile fits (Cin past
    ~330: the first, mma.sync design takes those calls)."""
    up = lambda v, m: -(-v // m) * m   # noqa: E731
    kp = up(9 * cin, 64)
    row = 18 * cin

    def geometry(bn, mt):
        tiles_n = -(-cout // bn)
        stage = up(2 * ((8 * mt + 2) * (row + 21) + 16), 128)
        ops = cout if tiles_n == 1 else bn + (cout - bn) % 8
        out_warp = up(2 * (16 * ops + 8), 128)
        fixed = (up(kp * bn * 2, 128) + up(kp // 16 * 4 * (16 if cin % 2
                                                           else 8), 128)
                 + up(8 * bn + 16, 128) + 8 * out_warp)
        for blocks in ((2, 1) if bn <= 80 else (1,)):
            stages = min(NARROW_MAX_STAGES,
                         (SMEM_SM // blocks - 1024 - fixed) // stage)
            if stages >= 2:
                break
        stages = max(stages, 1)
        return {"bn": bn, "mt": mt, "tiles_n": tiles_n, "kp": kp,
                "ksteps": kp // 16, "row": row, "ops": ops,
                "stages": stages, "blocks_per_sm": blocks,
                "stage_bytes": stage, "out_warp_bytes": out_warp,
                "bytes": stages * stage + fixed}

    tn = -(-cout // NARROW_MAX_N)
    while True:
        bn = min(b for b in NARROW_BNS if b >= -(-cout // tn))
        if bn <= NARROW_MAX_N_MT2:
            p = geometry(bn, 2)
            if p["bytes"] <= SMEM_MAX and p["stages"] >= 2:
                return p
        p = geometry(bn, 1)
        if p["bytes"] <= SMEM_MAX:
            return p
        if bn == NARROW_BNS[0]:
            return None
        tn += 1


def f32_route(cin: int, cout: int) -> str:
    """The f32 forward's route at (Cin, Cout): "f32_packed" (wgmma, 9 x Cin
    packed into K) where Cin % 4 != 0 and 9 * Cin <= K_MAX; "f32" (wgmma +
    TMA over x, a padded copy where Cin % 4 != 0) otherwise."""
    return "f32_packed" if cin % 4 and 9 * cin <= K_MAX else "f32"


def f32_stride(c: int) -> int:
    """The pixel stride route "f32" reads a side of ``c`` channels at: c
    rounded up to a multiple of 4 (TMA's 16-byte strides)."""
    return -(-c // 4) * 4


def f32_pads_input(cin: int, cout: int) -> bool:
    """Whether the f32 forward at (Cin, Cout) reads x as its padded copy:
    route "f32" at Cin % 4 != 0 (9 x Cin > K_MAX, e.g. the 150-class
    head's dx at Cin 150)."""
    return cin % 4 != 0 and f32_route(cin, cout) == "f32"


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


def split_weights_plain(w: torch.Tensor, flip: bool = False,
                        stride: int = None) -> torch.Tensor:
    """The f32 forward's weights as its wgmma route reads them: (2, Cout, 9,
    ``stride``), [0] the TF32 hi parts, [1] the lo parts (``tf32_rna_bits``
    of v and of v - hi), K-major: [h][n][t][c] from w (3,3,Cin,Cout), or
    with ``flip`` from the tap-reversed transpose of w (3,3,Cout,Cin), w[8
    - t][n][c] (K1's dx); rows of x's pixel stride (default Cin), zeros
    past Cin. The plain version of the source's ``split_weights_kernel``."""
    w = w.float()
    if flip:
        kmaj = w.flip((0, 1)).reshape(9, w.shape[2], w.shape[3])
    else:
        kmaj = w.reshape(9, w.shape[2], w.shape[3]).transpose(1, 2)
    kmaj = kmaj.transpose(0, 1).contiguous()   # (Cout, 9, Cin)
    if stride is not None:
        kmaj = F.pad(kmaj, (0, stride - kmaj.shape[2]))
    hi = tf32_rna_bits(kmaj)
    return torch.stack([hi, tf32_rna_bits(kmaj - hi)])


def pad_channels_plain(x: torch.Tensor) -> torch.Tensor:
    """x (..., C) f32 as route "f32" reads it: (..., ``f32_stride(C)``),
    zeros past C. The plain version of the source's
    ``pad_channels_kernel``."""
    return F.pad(x, (0, f32_stride(x.shape[-1]) - x.shape[-1]))


def pad_channels(x: torch.Tensor) -> torch.Tensor:
    """The padded copy of an f32 NHWC tensor x (N,H,W,C), contiguous (its
    data at any 4-byte alignment): (N,H,W,``f32_stride(C)``), zeros past
    C. On a CPU tensor ``pad_channels_plain``; on a CUDA tensor the .cu's
    ``pad_channels_kernel`` (into a fresh, 16-byte aligned allocation), or
    raises. Counts its launches in ``pad_channels.launches``."""
    if x.device.type == "cpu":
        return pad_channels_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"pad_channels: no kernel for {x.device}")
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"pad_channels takes a contiguous f32 (N,H,W,C) "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    n, h, wd, c = x.shape
    with torch.cuda.device(x.device):
        out = torch.empty((n, h, wd, f32_stride(c)), dtype=torch.float32,
                          device=x.device)
        if out.numel():
            err = f32_library().conv3x3_f32_pad_channels(
                x.data_ptr(), out.data_ptr(), n * h * wd, c,
                torch.cuda.current_stream(x.device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"pad_channels kernel launch failed: "
                                   f"CUDA error {err} at x "
                                   f"{tuple(x.shape)}")
            pad_channels.launches += 1
    return out


def padded_input(x: torch.Tensor, xp: torch.Tensor = None) -> torch.Tensor:
    """x's padded copy: ``xp`` where one is handed in (checked: the shape
    ``pad_channels`` gives, f32, contiguous, on x's device, 16-byte
    aligned), else ``pad_channels(x)``."""
    if xp is None:
        return pad_channels(x)
    want = tuple(x.shape[:-1]) + (f32_stride(x.shape[-1]),)
    if (tuple(xp.shape) != want or xp.dtype != torch.float32
            or not xp.is_contiguous() or xp.device != x.device
            or xp.data_ptr() % 16):
        raise ValueError(f"a padded copy of x {tuple(x.shape)} must be a "
                         f"contiguous, 16-byte aligned f32 {want} on "
                         f"{x.device}, got {xp.dtype} {tuple(xp.shape)}")
    return xp


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
    if x.numel() == 0:   # an empty map (SegNet under 16 rows or columns)
        return x.new_empty(x.shape[:3] + (w.shape[3],))
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 padding=1)
    y = y.permute(0, 2, 3, 1).float() * a + b
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(cuda_build.load(SOURCE))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C entry points of a library built from ``conv3x3_bn_relu.cu``
    (or an edit of it, chip_faults.py), typed."""
    fn = lib.conv3x3_bn_relu_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    lib.conv3x3_bn_relu_path.argtypes = [ctypes.c_int] * 2
    lib.conv3x3_bn_relu_path.restype = ctypes.c_int
    lib.conv3x3_bn_relu_narrow_plan.argtypes = [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    lib.conv3x3_bn_relu_narrow_plan.restype = None
    return lib


@functools.cache
def f32_library() -> ctypes.CDLL:
    """``csrc/conv3x3_f32.cu`` built and bound: the f32 forward (K4, K1 fwd
    and dx), the f32 dW (K1's, ``conv_train``) with its tile counts, the
    padded copy and the f32 K5 (``fused_conv_pair``)."""
    return bind_f32(cuda_build.load(F32_SOURCE))


def bind_f32(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C entry points of a library built from ``conv3x3_f32.cu`` (or
    an edit of it, ``f32_variants``), typed."""
    lib.conv3x3_bn_relu_f32.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.conv3x3_bn_relu_f32.restype = ctypes.c_int
    lib.conv3x3_wgrad_f32.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.conv3x3_wgrad_f32.restype = ctypes.c_int
    lib.conv3x3_f32_pad_channels.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    lib.conv3x3_f32_pad_channels.restype = ctypes.c_int
    lib.conv3x3_pair_bn_relu_f32.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.conv3x3_pair_bn_relu_f32.restype = ctypes.c_int
    for name, n, res in (("conv3x3_f32_route", 3, ctypes.c_int),
                         ("conv3x3_wgrad_f32_packed_side", 2, ctypes.c_int),
                         ("conv3x3_f32_tile_n", 1, ctypes.c_int),
                         ("conv3x3_bn_relu_f32_ws_floats", 2,
                          ctypes.c_longlong),
                         ("conv3x3_wgrad_f32_pixel_tiles", 3,
                          ctypes.c_longlong),
                         ("conv3x3_wgrad_f32_out_tiles", 2,
                          ctypes.c_longlong),
                         ("conv3x3_pair_f32_smem", 1, ctypes.c_int)):
        getattr(lib, name).argtypes = [ctypes.c_int] * n
        getattr(lib, name).restype = res
    return lib


def f32_kernel_route(cin: int, cout: int, wgrad: bool = False) -> str:
    """The f32 route the built library's rule gives (Cin, Cout), of the
    forward or (``wgrad``) the dW (``f32_route``'s and
    ``conv_train.wgrad_f32_route``'s rules as the .cu holds them;
    chip_smoke checks that they agree)."""
    return F32_ROUTES[f32_library().conv3x3_f32_route(cin, cout,
                                                       int(wgrad))]


def kernel_path(cin: int, cout: int) -> str:
    """The path the built library takes for (Cin, Cout) (``conv_path``'s
    rule as the .cu holds it; chip_smoke checks that the two agree)."""
    return PATHS[_library().conv3x3_bn_relu_path(cin, cout)]


def kernel_narrow_plan(cin: int, cout: int) -> tuple:
    """(N tile, channel tiles, patch stages, shared memory bytes) of the
    built library's narrow path at (Cin, Cout) (``narrow_fwd_plan``'s rule
    as the .cu holds it; chip_smoke checks that the two agree)."""
    out = (ctypes.c_int * 4)()
    _library().conv3x3_bn_relu_narrow_plan(cin, cout, out)
    return tuple(out)


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` as it is when its data starts on a 16-byte boundary, else a
    copy that does. A batch slice such as ``x[1:]`` keeps its storage
    offset through ``.contiguous()``, and the wgmma paths' TMA, the packed
    paths' 16-byte loads and the narrow path's 16-byte chunks need aligned
    bases; the copy is a fresh allocation, which the caching allocator
    aligns."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _holds_last_chunk(t: torch.Tensor) -> bool:
    """Whether ``t``'s storage runs on to the end of the 16-byte chunk
    (from ``t``'s aligned start) that holds its last element."""
    nbytes = t.numel() * t.element_size()
    room = (t.untyped_storage().nbytes()
            - t.storage_offset() * t.element_size())
    return room >= -(-nbytes // 16) * 16


def whole_chunks(t: torch.Tensor) -> torch.Tensor:
    """``t`` as it is when its storage holds the whole 16-byte chunk its
    last element lies in, else a copy into a buffer rounded up to 16
    bytes. The narrow path copies x's rows as whole 16-byte chunks; where
    N x H x W x Cin is no multiple of 8 the last one ends past x (no model
    shape at 360x480 has such an x)."""
    if _holds_last_chunk(t):
        return t
    n = -(-t.numel() * t.element_size() // 16) * 16 // t.element_size()
    buf = t.new_empty(n)
    buf[:t.numel()].copy_(t.reshape(-1))
    return buf[:t.numel()].view(t.shape)


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
    if min(cin, cout) == 0 or max(*x.shape, 9 * cin * cout) >= 2 ** 31:
        raise ValueError(f"unsupported shape x {tuple(x.shape)}, "
                         f"Cout {cout}")
    if x.dtype == torch.float32:
        if x.shape[0] * x.shape[1] * x.shape[2] >= F32_MAX_PIXELS:
            raise ValueError(f"the f32 kernel takes fewer than 2**31 - 128 "
                             f"pixels, got x {tuple(x.shape)}")
        return   # aligned16 gave TMA and the packed route's 16-byte
                 # loads their bases; the padded copy reads any
    path = conv_path(cin, cout)
    if path == "wgmma" and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("x and w must be 16-byte aligned (TMA)")
    if path in ("packed", "narrow") and x.data_ptr() % 16:
        raise ValueError(f"x must be 16-byte aligned (the {path} path reads "
                         f"its rows in 16-byte chunks)")
    if path == "narrow" and not _holds_last_chunk(x):
        raise ValueError("x's storage must hold its last 16-byte chunk (the "
                         "narrow path copies whole chunks)")


def conv3x3_bn_relu(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, relu: bool = True, flip: bool = False,
                    xp: torch.Tensor = None) -> torch.Tensor:
    """Fused relu(conv3x3_pad1(x, w) * a + b). x: (N,H,W,Cin) NHWC
    contiguous; w: (3,3,Cin,Cout) HWIO contiguous, or with ``flip``
    (3,3,Cout,Cin), the weights of the conv whose input gradient this is;
    a, b: (Cout,) f32; ``xp``: x's padded copy (``pad_channels``) where the
    caller has one, read in x's place where route "f32" pads x (else
    unused).

    On a CPU tensor this is ``conv3x3_bn_relu_plain``. On a CUDA tensor it
    is ``launch``; an empty map (no pixel) is no work, and gives the empty
    output without a launch. While tracing (``torch.export``) it is the op
    ``camvid::conv3x3_bn_relu`` (``ops/library.py``), whose kernels are
    those two, so the program holds one node for the call."""
    if torch.compiler.is_compiling():
        return torch.ops.camvid.conv3x3_bn_relu(x, w, a, b, relu, flip)
    if x.device.type == "cpu":
        return conv3x3_bn_relu_plain(x, w, a, b, relu, flip)
    return launch(x, w, a, b, relu, flip, xp)


def launch(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
           b: torch.Tensor, relu: bool, flip: bool,
           xp: torch.Tensor = None) -> torch.Tensor:
    """The kernel on CUDA tensors, or raises: bf16 x and w (f32
    accumulation, bf16 out) on ``conv_path(Cin, Cout)``; f32 x and w
    (split-TF32 products, f32 out) on the f32 kernel's ``f32_route``, x
    as its padded copy where that route pads it (``xp``, or one made
    here). An x or w whose data is not 16-byte aligned is copied first
    (``aligned16``; not an x the padded copy reads, at any alignment).
    Counts the launch."""
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_bn_relu: no kernel for {x.device}")
    pads = (x.dtype == torch.float32 and x.dim() == 4 and a.dim() == 1
            and f32_pads_input(x.shape[3], a.shape[0]))
    x, w = (x if pads else aligned16(x)), aligned16(w)
    if (x.dtype == torch.bfloat16 and x.dim() == 4 and x.is_contiguous()
            and conv_path(x.shape[3], a.shape[0]) == "narrow"):
        x = whole_chunks(x)
    _check(x, w, a, b, flip)
    n, h, wd, cin = x.shape
    cout = a.shape[0]
    if x.numel() == 0:   # an empty map: no work, nothing launched
        return x.new_empty((n, h, wd, cout))
    if x.dtype == torch.float32:
        out = _f32_launch(x, w, a, b, relu, flip,
                          padded_input(x, xp) if pads else None)
        conv3x3_bn_relu.launches += 1
        conv3x3_bn_relu.path_launches[f32_route(cin, cout)] += 1
        return out
    lib = _library()
    route = ctypes.c_int(-1)
    with torch.cuda.device(x.device):
        out = torch.empty((n, h, wd, cout), dtype=torch.bfloat16,
                          device=x.device)
        err = lib.conv3x3_bn_relu_bf16(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, h, wd, cin, cout, int(relu), int(flip),
            torch.cuda.current_stream(x.device).cuda_stream,
            ctypes.byref(route))
    if err != 0:
        raise RuntimeError(f"conv3x3_bn_relu kernel launch failed: CUDA "
                           f"error {err} at x {tuple(x.shape)}, Cout {cout}")
    # the kernel the C entry launched: a path's code, or 3 where the narrow
    # path's plan holds no tile and mma_sync took the call
    conv3x3_bn_relu.launches += 1
    conv3x3_bn_relu.path_launches[PATHS[route.value % 3]] += 1
    conv3x3_bn_relu.mma_sync_launches += int(route.value == 3)
    return out


def _f32_launch(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, relu: bool, flip: bool,
                xp: torch.Tensor = None) -> torch.Tensor:
    """One call of the f32 forward on checked CUDA inputs (the weights'
    split, then the conv), reading x's padded copy ``xp`` in its place
    where one is given (the layout names the route); raises on a CUDA
    error."""
    n, h, wd, cin = x.shape
    cout = a.shape[0]
    src = x if xp is None else xp
    xc = src.shape[3]
    lib = f32_library()
    with torch.cuda.device(x.device):
        out = torch.empty((n, h, wd, cout), dtype=torch.float32,
                          device=x.device)
        ws = torch.empty(lib.conv3x3_bn_relu_f32_ws_floats(xc, cout),
                         dtype=torch.float32, device=x.device)
        err = lib.conv3x3_bn_relu_f32(
            src.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), ws.data_ptr(), n, h, wd, cin, cout, xc,
            int(relu), int(flip),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_bn_relu f32 kernel launch failed: CUDA "
                           f"error {err} at x {tuple(x.shape)}, Cout {cout}")
    return out


def reset_launches() -> None:
    conv3x3_bn_relu.launches = 0
    conv3x3_bn_relu.mma_sync_launches = 0   # narrow's rest: mma_sync
    conv3x3_bn_relu.path_launches = dict.fromkeys(ROUTES, 0)
    pad_channels.launches = 0


reset_launches()
