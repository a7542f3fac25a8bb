"""The training conv3x3 (pad 1, NHWC x, HWIO w) with hand-written forward
and backward kernels: counterpart of
``pytorch_camvid_tpu/ops/pallas_conv_train.py::conv3x3_pallas`` (K1).

``conv3x3_train(x, w)`` is a ``torch.autograd.Function``:

- forward: ``y = conv3x3(x, w)``, K4's kernel (``fused_conv``) with a unit
  affine and no ReLU, as JAX's ``_conv3x3_fwd``;
- dx: the same kernel on the cotangent with ``flip=True``: it reads ``w``
  with its taps reversed and its channel axes swapped (the transpose of a
  pad-1 3x3 conv is a pad-1 3x3 conv), in place, with no weight copy.
  Skipped when x needs no gradient: the stem's input is the image, and its
  dx would be a Cout=3 launch for nothing;
- dW: ``conv3x3_wgrad(x, g)``, the kernel ``csrc/conv3x3_wgrad.cu``, in f32,
  cast to ``w``'s dtype on return as JAX's ``_vjp_bwd`` does.

At float32 (the JAX CLIs' default) all three pieces run
``csrc/conv3x3_f32.cu``: the forward and dx on its split-TF32 forward
(``fused_conv``'s f32 routes), dW on its split-TF32 dW, route "f32"
(wgmma + TMA: 4 x 16 pixel tiles, each g tile transposed once into hi and
lo planes) where TMA can describe x and g (Cin % 4 == 0, Cout % 4 == 0),
"f32_packed" (wgmma: the wide side by TMA as A, the narrow side's 9 taps
x channels as K-major hi and lo planes, the same pixel tiles) where one
side is narrow (channels % 4 != 0, 9 x channels <= 192: the stem, VOC's
64 -> 21 head) and the other not, "f32_narrow" (mma.sync over 32-pixel
chunks) otherwise (``wgrad_f32_route``); all split-K
(``wgrad_f32_splits``) with a second pass that sums the splits in a
fixed order, so two launches give the same bits.

Each piece has a wrapper (``conv3x3_fwd``, ``conv3x3_dgrad``,
``conv3x3_wgrad``) that runs its plain version on a CPU tensor and its
kernel on a CUDA tensor, or raises; each counts its kernel launches in
``.launches`` and per kernel path in ``.path_launches``: the forward and
dx by ``fused_conv.route`` ("wgmma", "packed" or "narrow" in bf16, "f32",
"f32_packed" or "f32_narrow"), dW by ``wgrad_route`` (likewise). The plain
versions are ``conv3x3_train_plain`` (``F.conv2d``,
differentiated by autograd), ``conv3x3_dgrad_plain``
(``torch.nn.grad.conv2d_input``) and ``conv3x3_wgrad_plain``
(``torch.nn.grad.conv2d_weight`` in f32 on the upcast inputs).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from pytorch_camvid_tpu_torch.ops import cuda_build
from pytorch_camvid_tpu_torch.ops.fused_conv import (ROUTES, aligned16,
                                                     conv3x3_bn_relu,
                                                     f32_library, route)
from pytorch_camvid_tpu_torch.ops.library import eager_cache

WGRAD_PATHS = ("narrow", "wgmma", "packed")   # by the .cu's path code
WGRAD_ROUTES = WGRAD_PATHS + ("f32", "f32_narrow",
                              "f32_packed")   # the counters' keys

WGRAD_SOURCE = cuda_build.CSRC / "conv3x3_wgrad.cu"
# split-K target in blocks per SM: the narrow kernel's; the wgmma
# kernel's (one resident per SM: two whole waves) and the packed kernel's
# (two resident per SM: one whole wave)
_BLOCKS_PER_SM = 8
_WGMMA_BLOCKS_PER_SM = 2
# the packed dW path (csrc/conv3x3_wgrad.cu, namespace pk): its narrow side
# packs 9 taps x channels into M <= PACKED_M_MAX (the .cu's pk::M_MAX):
# three m64 tiles, Cn <= 21
PACKED_M_MAX = 192
SM_SMEM, BLOCK_SMEM = 233472, 232448   # shared bytes of an SM, of a block
# the f32 dW (csrc/conv3x3_f32.cu). Route "f32" (namespace wgf): pixel
# tiles of F32_TH x F32_TW, blocks of one kernel row x F32_BM input
# channels x an N tile of Cout (``wgrad_f32_tile_n``), one resident per
# SM. Route "f32_packed" (namespace pk): the same pixel tiles, blocks of
# F32_BM channels of the wide side, one resident per SM. Route
# "f32_narrow" (namespace nar): 32-pixel chunks, 64 x 64 output tiles of
# (tap, Cin) rows x Cout, four blocks resident per SM.
F32_TH, F32_TW, F32_BM = 4, 16, 64
F32_CHUNK, F32_TILE, F32_BLOCKS_PER_SM = 32, 64, 4


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


@eager_cache
def _unit_affine(cout: int, device: torch.device):
    """K1's unit affine (ones, zeros) of Cout f32, cached by eager calls."""
    return (torch.ones(cout, dtype=torch.float32, device=device),
            torch.zeros(cout, dtype=torch.float32, device=device))


# ------------------------------------------------------------ plain versions

def conv3x3_train_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """conv3x3 pad-1, NHWC x, HWIO w, in x's dtype, from ``F.conv2d``;
    autograd differentiates it."""
    return F.conv2d(_nchw(x), _oihw(w.to(x.dtype)),
                    padding=1).permute(0, 2, 3, 1)


def conv3x3_dgrad_plain(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of conv3x3 pad-1 for cotangent g (N,H,W,Cout), in g's dtype."""
    n, h, wd, _ = g.shape
    dx = torch.nn.grad.conv2d_input((n, w.shape[2], h, wd),
                                    _oihw(w.to(g.dtype)), _nchw(g),
                                    padding=1)
    return dx.permute(0, 2, 3, 1)


def conv3x3_dgrad_library(g: torch.Tensor, w: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """dx as autograd computes it behind ``conv3x3_train_plain``: one
    ``aten.convolution_backward`` call with the real input x (N,H,W,Cin)
    in its channels-last layout and ``output_mask`` [True, False, False].
    K1's dx library yardstick on the card (chip_smoke, ``perf_probe --mode
    dgrad``); ``conv3x3_dgrad_plain`` stays the tests' reference.
    ``torch.nn.grad.conv2d_input`` hands ``convolution_backward`` a
    zero-stride stand-in for x, which is not what autograd runs."""
    dx = torch.ops.aten.convolution_backward(
        _nchw(g), _nchw(x), _oihw(w.to(g.dtype)), None, [1, 1], [1, 1],
        [1, 1], False, [0, 0], 1, [True, False, False])[0]
    return dx.permute(0, 2, 3, 1)


def conv3x3_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW (3,3,Cin,Cout) f32 of conv3x3 pad-1, from the f32 upcasts of x
    (N,H,W,Cin) and g (N,H,W,Cout)."""
    cin, cout = x.shape[3], g.shape[3]
    dw = torch.nn.grad.conv2d_weight(_nchw(x.float()), (cout, cin, 3, 3),
                                     _nchw(g.float()), padding=1)
    return dw.permute(2, 3, 1, 0).contiguous()


# ----------------------------------------------------------------- wrappers

def wgrad_path(cin: int, cout: int) -> str:
    """The dW kernel's path for (Cin, Cout) (the .cu's
    ``conv3x3_wgrad_path`` holds the same rule): "wgmma" where TMA can
    describe x and g (Cin % 8 == 0 and Cout % 8 == 0); "packed" where one
    side is narrow (its channels not a multiple of 8, 9 x channels <=
    ``PACKED_M_MAX`` = 192) and the other a multiple of 8: the Cin = 3 stem
    and the Cout = 12 and 21 heads; "narrow" otherwise (e.g. 64->28,
    3->12)."""
    if cin % 8 == 0 and cout % 8 == 0:
        return "wgmma"
    if ((cin % 8 and 9 * cin <= PACKED_M_MAX and cout % 8 == 0)
            or (cout % 8 and 9 * cout <= PACKED_M_MAX and cin % 8 == 0)):
        return "packed"
    return "narrow"


def wgrad_f32_route(cin: int, cout: int) -> str:
    """The f32 dW's route at (Cin, Cout): "f32" (wgmma + TMA) where TMA can
    describe x and g, Cin % 4 == 0 and Cout % 4 == 0; "f32_packed" where
    one side is narrow (channels % 4 != 0, 9 x channels <= PACKED_M_MAX)
    and the other's channels % 4 == 0: the Cin = 3 stem, VOC's 64 -> 21
    head; "f32_narrow" (mma.sync) otherwise, e.g. 23 -> 64 or 3 -> 21."""
    if cin % 4 == 0 and cout % 4 == 0:
        return "f32"
    if ((cin % 4 and 9 * cin <= PACKED_M_MAX and cout % 4 == 0)
            or (cout % 4 and 9 * cout <= PACKED_M_MAX and cin % 4 == 0)):
        return "f32_packed"
    return "f32_narrow"


def wgrad_route(dtype: torch.dtype, cin: int, cout: int) -> str:
    """The dW kernel that takes a (Cin, Cout) call at ``dtype``: the f32
    source's ``wgrad_f32_route`` for float32, else the bf16 source's
    ``wgrad_path``."""
    return (wgrad_f32_route(cin, cout) if dtype == torch.float32
            else wgrad_path(cin, cout))


def wgrad_f32_tile_n(cout: int) -> int:
    """The f32 wgmma dW's N tile: 16 for Cout <= 16 (the 12-class head),
    else 64 (the .cu's ``wgf::tile_n``)."""
    return 16 if cout <= 16 else 64


def wgrad_f32_plan(cout: int) -> dict:
    """The f32 wgmma dW's shared memory at Cout's N tile: four x stages
    (two 32-channel boxes of 4 x 18 pixels, 9,216 B each), three g stages
    (N / 32 rounded up boxes of 4 x 16 pixels x 32 channels, 8,192 B
    each), two plane buffers (hi and lo, each 8 k8 steps of N / 8 channel
    groups 272 B apart: two 128-byte core matrices and 16 B of pad), two
    mbarriers a stage and a buffer, and 1,024 B of alignment slack: the
    figures the source's ``Plan`` computes and its ``static_assert``s
    hold."""
    bn = wgrad_f32_tile_n(cout)
    x_stage, g_stage = 2 * 9216, -(-bn // 32) * 8192
    planes = 2 * 2 * 8 * (bn // 8) * 272
    return {"n": bn, "x_stage_bytes": x_stage, "g_stage_bytes": g_stage,
            "plane_bytes": planes,
            "bytes": 4 * x_stage + 3 * g_stage + planes + 16 * (4 + 3 + 2)
            + 1024}


def wgrad_f32_pixel_tiles(n: int, h: int, w: int, cin: int, cout: int,
                          route: str = None) -> int:
    """The f32 dW's split-K range on ``route`` (by default
    ``wgrad_f32_route``'s; the .cu's ``conv3x3_wgrad_f32_pixel_tiles``):
    F32_TH x F32_TW pixel tiles on "f32" and "f32_packed", 32-pixel chunks
    of the flattened N*H*W on "f32_narrow"."""
    if (route or wgrad_f32_route(cin, cout)) != "f32_narrow":
        return n * -(-h // F32_TH) * -(-w // F32_TW)
    return -(-n * h * w // F32_CHUNK)


def wgrad_f32_out_tiles(cin: int, cout: int, route: str = None) -> int:
    """The f32 dW's blocks per split on ``route`` (by default
    ``wgrad_f32_route``'s; the .cu's ``conv3x3_wgrad_f32_out_tiles``): on
    "f32" 3 kernel rows x F32_BM-channel tiles of Cin x N tiles of Cout;
    on "f32_packed" F32_BM-channel tiles of the wide side; on
    "f32_narrow" 64-row tiles of the 9 x Cin (tap, channel) rows x
    64-channel tiles of Cout."""
    route = route or wgrad_f32_route(cin, cout)
    if route == "f32":
        return 3 * -(-cin // F32_BM) * -(-cout // wgrad_f32_tile_n(cout))
    if route == "f32_packed":
        return -(-(cin if cout % 4 else cout) // F32_BM)
    return -(-9 * cin // F32_TILE) * -(-cout // F32_TILE)


def wgrad_f32_splits(n: int, h: int, w: int, cin: int, cout: int,
                     sms: int, route: str = None) -> int:
    """The f32 dW's split-K factor on ``route`` (by default
    ``wgrad_f32_route``'s), at most one split per pixel tile. On
    "f32_narrow": enough splits for ``F32_BLOCKS_PER_SM`` blocks on each of
    ``sms`` SMs. On "f32" and "f32_packed" (one block resident per SM):
    from two waves' worth of blocks ("f32_packed": one; its blocks are
    alike, so one wave keeps every SM busy with half the workspace),
    rounded down, the fewest splits up to eight times as many whose last
    wave is at least 90% full, so the splits fill whole waves (at 192
    blocks a split, one split would leave the second wave 45% full; two
    fill 91% of the third)."""
    route = route or wgrad_f32_route(cin, cout)
    blocks = wgrad_f32_out_tiles(cin, cout, route)
    cap = min(wgrad_f32_pixel_tiles(n, h, w, cin, cout, route), 65535)
    if route == "f32_narrow":
        return max(1, min(-(-F32_BLOCKS_PER_SM * sms // blocks), cap))
    waves = 1 if route == "f32_packed" else 2
    want = max(1, waves * sms // blocks)
    for s in range(want, min(cap, 8 * want) + 1):
        if s * blocks % sms == 0 or s * blocks % sms >= 0.9 * sms:
            return s
    return max(1, min(want, cap))


def wgrad_f32_packed_plan(cin: int, cout: int) -> dict:
    """The f32 packed dW's plan at (Cin, Cout) on that route (the .cu's
    ``pk::w_tile_n`` and ``pk::wgrad_smem``): the narrow side's channels
    ``narrow`` (x's for the stem, g's for the head); consumer warpgroup dy
    takes kernel row dy's 3 x narrow (dx, channel) rows as N, padded to
    ``n`` (16 up to 16 rows, 24 up to 24, else 64: 16 at the stem, 64 at
    VOC's 21); M = 64 channels of the wide side a block, one block an SM.
    Shared memory: 1,024 B of alignment slack; ``x_stages`` (4) of the
    wide tile, two 32-channel boxes of 4 x 16 pixels (16,384 B); two plane
    buffers, each hi and lo of ``plane_bytes`` (6 patch rows x 2 column
    blocks of 8 pixels x n rows x 32 B); four raw buffers of the patch's 6
    rows as they lie in memory (``raw_bytes`` each: the 16-byte chunks
    that 18 x narrow elements span at any alignment); two mbarriers a
    stage and a buffer: the figures the source's
    ``static_assert``s hold (at Cn 3 and 21). Off the route it raises."""
    if wgrad_f32_route(cin, cout) != "f32_packed":
        raise ValueError(f"{cin}->{cout} is not on the f32 packed dW route")
    narrow = cin if cin % 4 else cout
    rows = 3 * narrow
    n = 16 if rows <= 16 else 24 if rows <= 24 else 64
    plane = 6 * 2 * n * 32
    raw = 6 * ((18 * narrow + 2) // 4 + 1) * 16
    x_stage, x_stages = 2 * 4 * 16 * 128, 4
    return {"narrow": narrow, "n": n, "x_stages": x_stages,
            "x_stage_bytes": x_stage, "plane_bytes": plane,
            "raw_bytes": raw, "blocks_per_sm": 1,
            "bytes": 1024 + x_stages * x_stage + 4 * plane + 4 * raw
            + 2 * (x_stages + 2) * 8}


def wgrad_packed_plan(cin: int, cout: int) -> dict:
    """The packed dW kernel's plan at (Cin, Cout) on that path: the narrow
    side's channels ``narrow`` (x's for the stem, g's for the head), M =
    9 taps x channels padded to 64-row tiles (``m``: 64 for the stem, 128
    for the 12-class head, 192 for Cn 15-21 such as the 21-class head), N =
    64 channels of the wide side per block, ``blocks_per_sm`` (two; one at
    three M tiles, for their 96 accumulators a thread), and shared memory:
    ``stage_bytes`` (one 8 x 16
    pixel x 64 channel wide box, 16,384 B, and the narrow patch's three
    shifted channel-major copies plus a zero plane, each (8 + 2) rows x 32 B
    + 16 B, rounded up to 128), ``stages`` (4 where ``blocks_per_sm``
    blocks still fit an SM, else 3), ``raw_bytes`` (four buffers of the
    patch's (8 + 2) rows as they lie in memory, each the 16-byte chunks
    that 18 x narrow elements span at any alignment) and ``bytes`` (1,024
    of alignment slack, the stages, the raw buffers and two mbarriers a
    stage): the figures the source's ``smem_bytes`` computes and its
    ``static_assert``s hold (at Cn 3, 12, 15 and 21). Off the packed path
    (e.g. 64->28) it raises."""
    if wgrad_path(cin, cout) != "packed":
        raise ValueError(f"{cin}->{cout} is not on the packed dW path")
    narrow = cin if cin % 8 else cout
    m_tiles = -(-9 * narrow // 64)
    per_sm = 1 if m_tiles == 3 else 2
    plane = 10 * 32 + 16
    nstage = -(-(3 * narrow + 1) * plane // 128) * 128
    raw = 4 * 10 * ((18 * narrow + 6) // 8 + 1) * 16

    def total(stages):
        return 1024 + stages * (16384 + nstage) + raw + 16 * stages

    stages = 4 if per_sm * (total(4) + 1024) <= SM_SMEM else 3
    return {"narrow": narrow, "m": 64 * m_tiles, "n": 64,
            "blocks_per_sm": per_sm, "stage_bytes": 16384 + nstage,
            "stages": stages, "raw_bytes": raw, "bytes": total(stages)}


def _count(fn, path: str) -> None:
    fn.launches += 1
    fn.path_launches[path] += 1


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """conv3x3 pad-1: K4's kernel with a unit affine and no ReLU (on a CPU
    tensor, its plain version; while tracing, K4's op). Counts launches,
    not traces."""
    ones, zeros = _unit_affine(w.shape[3], x.device)
    out = conv3x3_bn_relu(x, w, ones, zeros, relu=False)
    if x.device.type == "cuda" and not torch.compiler.is_compiling():
        _count(conv3x3_fwd, route(x.dtype, w.shape[2], w.shape[3]))
    return out


def conv3x3_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx (N,H,W,Cin) for the cotangent g (N,H,W,Cout) of a conv with HWIO
    weights w (3,3,Cin,Cout): K4's kernel on g, reading w tap-reversed and
    transposed in place (``flip=True``). On a CPU tensor,
    ``conv3x3_dgrad_plain``."""
    if g.device.type == "cpu":
        return conv3x3_dgrad_plain(g, w)
    ones, zeros = _unit_affine(w.shape[2], g.device)
    out = conv3x3_bn_relu(g, w, ones, zeros, relu=False, flip=True)
    _count(conv3x3_dgrad, route(g.dtype, w.shape[3], w.shape[2]))
    return out


@functools.cache
def _wgrad_library() -> ctypes.CDLL:
    lib = cuda_build.load(WGRAD_SOURCE)
    lib.conv3x3_wgrad_bf16.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.conv3x3_wgrad_bf16.restype = ctypes.c_int
    lib.conv3x3_wgrad_pixel_tiles.argtypes = [ctypes.c_int] * 3
    lib.conv3x3_wgrad_pixel_tiles.restype = ctypes.c_longlong
    lib.conv3x3_wgrad_out_tiles.argtypes = [ctypes.c_int] * 2
    lib.conv3x3_wgrad_out_tiles.restype = ctypes.c_longlong
    lib.conv3x3_wgrad_path.argtypes = [ctypes.c_int] * 2
    lib.conv3x3_wgrad_path.restype = ctypes.c_int
    return lib


def wgrad_kernel_path(cin: int, cout: int) -> str:
    """The path the built library takes for (Cin, Cout) (``wgrad_path``'s
    rule as the .cu holds it; chip_smoke checks that the two agree)."""
    return WGRAD_PATHS[_wgrad_library().conv3x3_wgrad_path(cin, cout)]


def wgrad_splits(pixel_tiles: int, out_tiles: int, sms: int,
                 path: str = "narrow") -> int:
    """Split-K factor over the kernel's output tiles, at most one split per
    pixel tile (both counts come from the kernel's library). Narrow path:
    at least ``_BLOCKS_PER_SM`` blocks per SM. wgmma path (one block
    resident per SM) and packed path (two): at most
    ``_WGMMA_BLOCKS_PER_SM`` per SM, rounded down, so power-of-two tile
    counts fill whole waves (at 16 output tiles 17 splits would leave a
    third wave nearly empty)."""
    if path in ("wgmma", "packed"):
        want = _WGMMA_BLOCKS_PER_SM * sms // out_tiles
    else:
        want = -(-_BLOCKS_PER_SM * sms // out_tiles)
    return max(1, min(want, pixel_tiles, 65535))


def _check_wgrad(x: torch.Tensor, g: torch.Tensor) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32) or g.dtype != x.dtype:
        raise TypeError(f"conv3x3_wgrad kernel takes bf16 or f32 x and g of "
                        f"one dtype, got {x.dtype} and {g.dtype}")
    if x.dim() != 4 or g.dim() != 4 or x.shape[:3] != g.shape[:3]:
        raise ValueError(f"x (N,H,W,Cin) and g (N,H,W,Cout) must share "
                         f"N,H,W: {tuple(x.shape)} vs {tuple(g.shape)}")
    if g.device != x.device:
        raise ValueError(f"g is on {g.device}, x on {x.device}")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("x and g must be contiguous NHWC")
    if min(x.shape) == 0 or max(*x.shape, g.shape[3]) >= 2 ** 31:
        raise ValueError(f"unsupported shape x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}")
    if x.dtype == torch.float32:
        if (x.shape[0] * x.shape[1] * x.shape[2] >= 2 ** 31 - 4 * F32_CHUNK
                or 9 * x.shape[3] * g.shape[3] >= 2 ** 31):
            raise ValueError(f"unsupported shape for the f32 dW: x "
                             f"{tuple(x.shape)}, g {tuple(g.shape)}")
        return   # aligned16 gave TMA its 16-byte bases (narrow: any)
    if (wgrad_path(x.shape[3], g.shape[3]) != "narrow"
            and (x.data_ptr() % 16 or g.data_ptr() % 16)):
        raise ValueError("x and g must be 16-byte aligned (TMA; the packed "
                         "path's 16-byte loads of the narrow tensor)")


def _wgrad_launch(x: torch.Tensor, g: torch.Tensor,
                  path: str) -> torch.Tensor:
    """One call of the dW kernel on checked CUDA inputs (its split-K pass
    and, past one split, the sum over the splits): returns dW (3,3,Cin,Cout)
    f32; raises on a CUDA error."""
    n, h, wd, cin = x.shape
    cout = g.shape[3]
    lib = _wgrad_library()
    with torch.cuda.device(x.device):
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        splits = wgrad_splits(lib.conv3x3_wgrad_pixel_tiles(n, h, wd),
                              lib.conv3x3_wgrad_out_tiles(cin, cout), sms,
                              path)
        out = torch.empty((3, 3, cin, cout), dtype=torch.float32,
                          device=x.device)
        ws = (torch.empty((splits, 3, 3, cin, cout), dtype=torch.float32,
                          device=x.device) if splits > 1 else None)
        err = lib.conv3x3_wgrad_bf16(
            x.data_ptr(), g.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, n, h, wd, cin, cout,
            splits, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_wgrad kernel launch failed: CUDA error "
                           f"{err} at x {tuple(x.shape)}, Cout {cout}")
    return out


def _wgrad_f32_launch(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """One call of the f32 dW on checked CUDA inputs, on its route (the
    split-K pass and, past one split, the sum over the splits in split
    order): returns dW (3,3,Cin,Cout) f32; raises on a CUDA error."""
    n, h, wd, cin = x.shape
    cout = g.shape[3]
    with torch.cuda.device(x.device):
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        splits = wgrad_f32_splits(n, h, wd, cin, cout, sms)
        out = torch.empty((3, 3, cin, cout), dtype=torch.float32,
                          device=x.device)
        ws = (torch.empty((splits, 3, 3, cin, cout), dtype=torch.float32,
                          device=x.device) if splits > 1 else None)
        err = f32_library().conv3x3_wgrad_f32(
            x.data_ptr(), g.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, n, h, wd, cin, cout,
            splits, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_wgrad f32 kernel launch failed: CUDA "
                           f"error {err} at x {tuple(x.shape)}, Cout {cout}")
    return out


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW (3,3,Cin,Cout) f32 of conv3x3 pad-1 from x (N,H,W,Cin) and the
    cotangent g (N,H,W,Cout), NHWC contiguous.

    On a CPU tensor this is ``conv3x3_wgrad_plain``. On a CUDA tensor it
    launches a Hopper kernel or raises: bf16 x and g on
    ``csrc/conv3x3_wgrad.cu`` (f32 accumulation), f32 x and g on the
    split-TF32 dW of ``csrc/conv3x3_f32.cu`` (``wgrad_f32_route``), both
    split-K with a deterministic second pass; an x or g whose data is not
    16-byte aligned is copied first (``fused_conv.aligned16``)."""
    if x.device.type == "cpu":
        return conv3x3_wgrad_plain(x, g)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_wgrad: no kernel for {x.device}")
    x, g = aligned16(x), aligned16(g)
    _check_wgrad(x, g)
    path = wgrad_route(x.dtype, x.shape[3], g.shape[3])
    out = (_wgrad_f32_launch(x, g) if x.dtype == torch.float32
           else _wgrad_launch(x, g, path))
    _count(conv3x3_wgrad, path)
    return out


def reset_launches() -> None:
    for fn, paths in ((conv3x3_fwd, ROUTES), (conv3x3_dgrad, ROUTES),
                      (conv3x3_wgrad, WGRAD_ROUTES)):
        fn.launches = 0
        fn.path_launches = dict.fromkeys(paths, 0)


reset_launches()


def launches() -> dict:
    return {"fwd": conv3x3_fwd.launches, "dgrad": conv3x3_dgrad.launches,
            "wgrad": conv3x3_wgrad.launches}


def path_launches() -> dict:
    """{piece: {path: launches}} since ``reset_launches``."""
    return {"fwd": dict(conv3x3_fwd.path_launches),
            "dgrad": dict(conv3x3_dgrad.path_launches),
            "wgrad": dict(conv3x3_wgrad.path_launches)}


def step_path_launches(shapes, dtype: torch.dtype = torch.bfloat16) -> dict:
    """{piece: {path: launches}} of one training step at ``dtype`` over conv
    blocks ``shapes`` ((H, W, Cin, Cout) each, forward order): the first
    block is the stem, whose input needs no gradient, so it has no dx.
    Serving's forward launches are the "fwd" entry's."""
    out = {"fwd": dict.fromkeys(ROUTES, 0), "dgrad": dict.fromkeys(ROUTES, 0),
           "wgrad": dict.fromkeys(WGRAD_ROUTES, 0)}
    for i, (_, _, cin, cout) in enumerate(shapes):
        out["fwd"][route(dtype, cin, cout)] += 1
        if i:
            out["dgrad"][route(dtype, cout, cin)] += 1
        out["wgrad"][wgrad_route(dtype, cin, cout)] += 1
    return out


# ----------------------------------------------------------------- autograd

class _Conv3x3Train(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3_fwd(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = conv3x3_dgrad(g, w) if ctx.needs_input_grad[0] else None
        dw = (conv3x3_wgrad(x, g).to(w.dtype) if ctx.needs_input_grad[1]
              else None)
        return dx, dw


def conv3x3_train(x: torch.Tensor, w: torch.Tensor,
                  plain: bool = False) -> torch.Tensor:
    """Differentiable conv3x3 pad-1: x (N,H,W,Cin) contiguous, w
    (3,3,Cin,Cout) HWIO contiguous in x's dtype. ``plain=True`` runs
    ``conv3x3_train_plain`` on any device, the reference for the kernels."""
    if plain:
        return conv3x3_train_plain(x, w)
    return _Conv3x3Train.apply(x, w)
