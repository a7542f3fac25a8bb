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
(``fused_conv``'s f32 routes), dW on its split-TF32 dW
(``wgrad_f32_route``): "f32_packed" (wgmma: the wide side by TMA as A,
the narrow side's 9 taps x channels as K-major hi and lo planes, 4 x 16
pixel tiles) where a side is narrow (channels % 4 != 0, 9 x channels <=
192: the stem, VOC's 64 -> 21 head) and the other's channels are a
multiple of 4 or narrow too (UNet 5/64's 5 -> 5: the side with fewer
channels read as it lies, the other as its padded copy), "f32" (wgmma +
TMA over x and g, each g tile transposed once into hi and lo planes, the
same pixel tiles) otherwise, a side whose channels are no multiple of 4
as its padded copy (``fused_conv.pad_channels``; ``wgrad_f32_pads``):
the 150-class head's 64 -> 150; all split-K (``wgrad_f32_splits``) with
a second pass that sums the splits in a fixed order, so two launches
give the same bits. A backward pads its cotangent once and hands the
copy to both dx and dW; a forward that padded x keeps the copy for its
dW.

Each piece has a wrapper (``conv3x3_fwd``, ``conv3x3_dgrad``,
``conv3x3_wgrad``) that runs its plain version on a CPU tensor and its
kernel on a CUDA tensor, or raises (an empty map, SegNet's deepest stage
under 16 rows or columns, is no work: an empty result, or dW's zeros,
without a launch); each counts its kernel launches in
``.launches`` and per kernel path in ``.path_launches``: the forward and
dx by ``fused_conv.route`` ("wgmma", "packed" or "narrow" in bf16, "f32"
or "f32_packed"), dW by ``wgrad_route`` (likewise). The plain
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
from pytorch_camvid_tpu_torch.ops.fused_conv import (F32_MAX_PIXELS,
                                                     ROUTES,
                                                     _holds_last_chunk,
                                                     aligned16,
                                                     conv3x3_bn_relu,
                                                     f32_library,
                                                     f32_pads_input,
                                                     pad_channels,
                                                     padded_input, route,
                                                     whole_chunks)
from pytorch_camvid_tpu_torch.ops.library import eager_cache

WGRAD_PATHS = ("narrow", "wgmma", "packed")   # by the .cu's path code
WGRAD_ROUTES = WGRAD_PATHS + ("f32", "f32_packed")   # the counters' keys

WGRAD_SOURCE = cuda_build.CSRC / "conv3x3_wgrad.cu"
# split-K target in blocks per SM: the wgmma kernel's (one resident per
# SM: two whole waves) and the packed kernel's (two resident per SM: one
# whole wave); the narrow kernel keeps one block resident per SM and fills
# one whole wave of them
_WGMMA_BLOCKS_PER_SM = 2
# the packed dW path (csrc/conv3x3_wgrad.cu, namespace pk): its narrow side
# packs 9 taps x channels into M <= PACKED_M_MAX (the .cu's pk::M_MAX):
# three m64 tiles, Cn <= 21
PACKED_M_MAX = 192
SM_SMEM, BLOCK_SMEM = 233472, 232448   # shared bytes of an SM, of a block
# the narrow dW path (namespace narrow): M packs 9 taps x the channels of
# the side with fewer (in tiles of at most NARROW_MAX_CM: nine m64 tiles),
# split over two consumer warpgroups of NARROW_MTWS m64 tiles each; N is
# the other side's channels in tiles of NARROW_INSTANCES' sizes for that
# count (the .cu's instances; 40 = 32 + 8 wgmma sizes); pixel tiles of
# NARROW_THS rows x 16 columns, NARROW_RAW raw buffers, up to
# NARROW_MAX_STAGES ring stages, at most NARROW_ACC_MAX accumulators a
# consumer thread
NARROW_MAX_CM = 64
NARROW_MTWS = (1, 2, 3, 5)
NARROW_INSTANCES = ((1, 16), (1, 40), (1, 64), (1, 72), (1, 128), (2, 16),
                    (2, 40), (2, 64), (3, 40), (3, 72), (5, 40))
NARROW_THS = (8, 4, 2)
NARROW_RAW = 3
NARROW_MAX_STAGES = 3
NARROW_ACC_MAX = 128
# the f32 dW (csrc/conv3x3_f32.cu). Route "f32" (namespace wgf): pixel
# tiles of F32_TH x F32_TW, blocks of one kernel row x F32_BM input
# channels x an N tile of Cout (``wgrad_f32_tile_n``), one resident per
# SM. Route "f32_packed" (namespace pk): the same pixel tiles, blocks of
# F32_BM channels of the wide side, one resident per SM.
F32_TH, F32_TW, F32_BM = 4, 16, 64


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
    autograd differentiates it. An empty map (no pixel: ``F.conv2d``
    refuses one) gives its empty output through the centre tap's matmul,
    whose gradient is zero for w and empty for x."""
    if x.numel() == 0:
        return x @ w.to(x.dtype)[1, 1]
    return F.conv2d(_nchw(x), _oihw(w.to(x.dtype)),
                    padding=1).permute(0, 2, 3, 1)


def conv3x3_dgrad_plain(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of conv3x3 pad-1 for cotangent g (N,H,W,Cout), in g's dtype."""
    n, h, wd, _ = g.shape
    if g.numel() == 0:   # an empty map
        return g.new_empty((n, h, wd, w.shape[2]))
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
    if x.numel() == 0:   # an empty map: the sum over no pixel
        return torch.zeros((3, 3, cin, cout), device=x.device)
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


def packed_narrow_side(cin: int, cout: int):
    """The side route "f32_packed" would read as it lies at (Cin, Cout):
    "x" (the stem's case) or "g" (the head's), a side whose channels are
    no multiple of 4 with 9 x them <= PACKED_M_MAX, the other's channels a
    multiple of 4 or narrow too; with both sides so, the one with fewer
    channels ("x" on a tie). None where neither side can be."""
    xp = cin % 4 != 0 and 9 * cin <= PACKED_M_MAX
    gp = cout % 4 != 0 and 9 * cout <= PACKED_M_MAX
    if xp and gp:
        return "g" if cout < cin else "x"
    if xp and cout % 4 == 0:
        return "x"
    if gp and cin % 4 == 0:
        return "g"
    return None


def wgrad_f32_route(cin: int, cout: int) -> str:
    """The f32 dW's route at (Cin, Cout): "f32_packed" where a side can be
    read as it lies (``packed_narrow_side``): the Cin = 3 stem, VOC's 64 ->
    21 head, UNet 5/64's 5 -> 5 and 10 -> 5, 3 -> 21; "f32" (wgmma + TMA)
    otherwise, a side whose channels are no multiple of 4 as its padded
    copy (the 23- and 150-class heads, 23 -> 64, 6 -> 150)."""
    return "f32_packed" if packed_narrow_side(cin, cout) else "f32"


def wgrad_f32_pads(cin: int, cout: int, route: str = None) -> tuple:
    """(pad x, pad g): whether the f32 dW at (Cin, Cout) on ``route`` (by
    default ``wgrad_f32_route``'s) reads x and g as their padded copies
    (``fused_conv.pad_channels``): on "f32" each side whose channels are
    no multiple of 4; on "f32_packed" the side not read as it lies, where
    its channels are no multiple of 4."""
    route = route or wgrad_f32_route(cin, cout)
    side = packed_narrow_side(cin, cout) if route == "f32_packed" else None
    return (cin % 4 != 0 and side != "x", cout % 4 != 0 and side != "g")


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


def wgrad_f32_pixel_tiles(n: int, h: int, w: int) -> int:
    """The f32 dW's split-K range, F32_TH x F32_TW pixel tiles on both
    routes (the .cu's ``conv3x3_wgrad_f32_pixel_tiles``)."""
    return n * -(-h // F32_TH) * -(-w // F32_TW)


def wgrad_f32_out_tiles(cin: int, cout: int, route: str = None) -> int:
    """The f32 dW's blocks per split on ``route`` (by default
    ``wgrad_f32_route``'s; the .cu's ``conv3x3_wgrad_f32_out_tiles``): on
    "f32" 3 kernel rows x F32_BM-channel tiles of Cin x N tiles of Cout;
    on "f32_packed" F32_BM-channel tiles of the wide side (the one
    ``packed_narrow_side`` does not name)."""
    route = route or wgrad_f32_route(cin, cout)
    if route == "f32":
        return 3 * -(-cin // F32_BM) * -(-cout // wgrad_f32_tile_n(cout))
    wide = cin if packed_narrow_side(cin, cout) == "g" else cout
    return -(-wide // F32_BM)


def wgrad_f32_splits(n: int, h: int, w: int, cin: int, cout: int,
                     sms: int, route: str = None) -> int:
    """The f32 dW's split-K factor on ``route`` (by default
    ``wgrad_f32_route``'s), at most one split per pixel tile. One block is
    resident per SM: from two waves' worth of blocks ("f32_packed": one;
    its blocks are alike, so one wave keeps every SM busy with half the
    workspace), rounded down, the fewest splits up to eight times as many
    whose last wave is at least 90% full, so the splits fill whole waves
    (at 192 blocks a split, one split would leave the second wave 45%
    full; two fill 91% of the third)."""
    route = route or wgrad_f32_route(cin, cout)
    blocks = wgrad_f32_out_tiles(cin, cout, route)
    cap = min(wgrad_f32_pixel_tiles(n, h, w), 65535)
    waves = 1 if route == "f32_packed" else 2
    want = max(1, waves * sms // blocks)
    for s in range(want, min(cap, 8 * want) + 1):
        if s * blocks % sms == 0 or s * blocks % sms >= 0.9 * sms:
            return s
    return max(1, min(want, cap))


def wgrad_f32_packed_plan(cin: int, cout: int) -> dict:
    """The f32 packed dW's plan at (Cin, Cout) on that route (the .cu's
    ``pk::w_tile_n`` and ``pk::wgrad_smem``): the narrow side's channels
    ``narrow`` (x's for the stem, g's for the head: the side
    ``packed_narrow_side`` names); consumer warpgroup dy
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
    narrow = cin if packed_narrow_side(cin, cout) == "x" else cout
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


def wgrad_narrow_plan(cin: int, cout: int) -> dict:
    """The narrow dW kernel's plan at (Cin, Cout) (the .cu's
    ``narrow::plan``): the side whose 9 x channels make M (``side`` "x"
    where Cin <= Cout, the stem-like case, dW[t][c][n]; "g" otherwise, the
    head-like case, whose D[(t, c)][n] is dW[8 - t][n][c]), its ``cm``
    channels in ``tiles_m`` tiles of ``cmt`` (at most ``NARROW_MAX_CM``),
    9 x cmt rows in ``mt`` m64 tiles, ``mtw`` of them a consumer
    warpgroup (the least of ``NARROW_MTWS`` that holds half, rounded up);
    N the other side's ``cn`` channels in ``tiles_n`` tiles of ``bn`` (the
    least size of that ``mtw``'s instances holding ceil(cn / tiles_n),
    from the fewest tiles the widest size allows); pixel tiles of ``th``
    rows (the first of ``NARROW_THS`` where two ring stages fit). Shared
    memory: ``stages`` ring stages (at most ``NARROW_MAX_STAGES``) of
    ``stage_bytes``, each the M tile's three column-shifted channel-major
    copies and a zero plane (3 cmt + 1 planes of ``plane`` = (th + 2) rows
    x 32 B + 16 B) and B, th k16 steps of bn x 32 B; ``NARROW_RAW`` raw
    buffers of ``raw_bytes``, the M side's th + 2 rows of 18 pixels
    (``raw_m``) and the N side's th rows of 16 (``raw_n``) as the 16-byte
    chunks that hold them: whole rows of all the side's channels (each at
    a stride of its length + 14 to 21, congruent to W x channels mod 8)
    or, with ``runs`` where those do not fit at any N tile or pixel rows,
    each pixel's run of the tile's channels (at a stride of its length +
    14 to 21, congruent to the channels mod 8; a row at its runs' span +
    14 to 21); 128 B of mbarriers: ``bytes``, the figures the source's
    ``static_assert``s hold. Every shape has a plan."""
    up = lambda v, m: -(-v // m) * m   # noqa: E731
    side = "x" if cin <= cout else "g"
    cm, cn = (cin, cout) if side == "x" else (cout, cin)
    tiles_m = -(-cm // NARROW_MAX_CM)
    cmt = -(-cm // tiles_m)
    mt = -(-9 * cmt // 64)
    mtw = min(m for m in NARROW_MTWS if m >= -(-mt // 2))
    bns = [bn for m, bn in NARROW_INSTANCES if m == mtw]

    def geometry(bn, th, runs):
        plane = 32 * (th + 2) + 16
        planes = up((3 * cmt + 1) * plane, 128)
        stage = planes + th * bn * 32
        row_m = 18 * cmt + 378 if runs else 18 * cm + 21
        row_n = 16 * bn + 336 if runs else 16 * cn + 21
        raw_m = up(2 * ((th + 2) * row_m + 16), 128)
        raw_n = up(2 * (th * row_n + 16), 128)
        raw = raw_m + raw_n
        stages = min(NARROW_MAX_STAGES,
                     (BLOCK_SMEM - NARROW_RAW * raw - 128) // stage)
        return {"side": side, "cm": cm, "cn": cn, "cmt": cmt,
                "tiles_m": tiles_m, "mt": mt, "mtw": mtw, "bn": bn,
                "tiles_n": -(-cn // bn), "th": th, "runs": runs,
                "stages": stages, "plane": plane, "planes_bytes": planes,
                "stage_bytes": stage, "raw_m": raw_m, "raw_n": raw_n,
                "raw_bytes": raw,
                "bytes": stages * stage + NARROW_RAW * raw + 128}

    for runs in (False, True):
        tn = -(-cn // bns[-1])
        while True:
            bn = min(b for b in bns if b >= -(-cn // tn))
            for th in NARROW_THS:
                p = geometry(bn, th, runs)
                if p["stages"] >= 2:
                    return p
            if bn == bns[0]:
                break
            tn += 1
    raise AssertionError(f"no narrow dW plan at {cin}->{cout}")


def _count(fn, path: str) -> None:
    fn.launches += 1
    fn.path_launches[path] += 1


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor,
                xp: torch.Tensor = None) -> torch.Tensor:
    """conv3x3 pad-1: K4's kernel with a unit affine and no ReLU (on a CPU
    tensor, its plain version; while tracing, K4's op), reading x's padded
    copy ``xp`` where its f32 route pads x and the caller has one. Counts
    launches, not traces."""
    ones, zeros = _unit_affine(w.shape[3], x.device)
    out = conv3x3_bn_relu(x, w, ones, zeros, relu=False, xp=xp)
    if (x.device.type == "cuda" and x.numel()
            and not torch.compiler.is_compiling()):
        _count(conv3x3_fwd, route(x.dtype, w.shape[2], w.shape[3]))
    return out


def conv3x3_dgrad(g: torch.Tensor, w: torch.Tensor,
                  gp: torch.Tensor = None) -> torch.Tensor:
    """dx (N,H,W,Cin) for the cotangent g (N,H,W,Cout) of a conv with HWIO
    weights w (3,3,Cin,Cout): K4's kernel on g, reading w tap-reversed and
    transposed in place (``flip=True``), and g's padded copy ``gp`` where
    its f32 route pads g and the caller has one. On a CPU tensor,
    ``conv3x3_dgrad_plain``."""
    if g.device.type == "cpu":
        return conv3x3_dgrad_plain(g, w)
    ones, zeros = _unit_affine(w.shape[2], g.device)
    out = conv3x3_bn_relu(g, w, ones, zeros, relu=False, flip=True, xp=gp)
    if g.numel():
        _count(conv3x3_dgrad, route(g.dtype, w.shape[3], w.shape[2]))
    return out


@functools.cache
def _wgrad_library() -> ctypes.CDLL:
    return bind_wgrad(cuda_build.load(WGRAD_SOURCE))


def bind_wgrad(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C entry points of a library built from ``conv3x3_wgrad.cu`` (or
    an edit of it: chip_faults.py, dw_variants.py), typed."""
    lib.conv3x3_wgrad_bf16.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.conv3x3_wgrad_bf16.restype = ctypes.c_int
    lib.conv3x3_wgrad_pixel_tiles.argtypes = [ctypes.c_int] * 3
    lib.conv3x3_wgrad_pixel_tiles.restype = ctypes.c_longlong
    lib.conv3x3_wgrad_out_tiles.argtypes = [ctypes.c_int] * 2
    lib.conv3x3_wgrad_out_tiles.restype = ctypes.c_longlong
    lib.conv3x3_wgrad_path.argtypes = [ctypes.c_int] * 2
    lib.conv3x3_wgrad_path.restype = ctypes.c_int
    lib.conv3x3_wgrad_narrow_plan.argtypes = [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    lib.conv3x3_wgrad_narrow_plan.restype = None
    return lib


def wgrad_kernel_path(cin: int, cout: int) -> str:
    """The path the built library takes for (Cin, Cout) (``wgrad_path``'s
    rule as the .cu holds it; chip_smoke checks that the two agree)."""
    return WGRAD_PATHS[_wgrad_library().conv3x3_wgrad_path(cin, cout)]


def wgrad_kernel_narrow_plan(cin: int, cout: int) -> tuple:
    """(M side: 0 x, 1 g; m64 tiles a consumer warpgroup, N tile, N channel
    tiles, M channel tiles, pixel rows a tile, runs, ring stages, shared
    memory bytes) of the built library's narrow dW at (Cin, Cout)
    (``wgrad_narrow_plan``'s rule as the .cu holds it; chip_smoke checks
    that the two agree)."""
    out = (ctypes.c_int * 9)()
    _wgrad_library().conv3x3_wgrad_narrow_plan(cin, cout, out)
    return tuple(out)


def narrow_plan_key(p: dict) -> tuple:
    """``wgrad_narrow_plan``'s figures in ``wgrad_kernel_narrow_plan``'s
    order."""
    return (int(p["side"] == "g"), p["mtw"], p["bn"], p["tiles_n"],
            p["tiles_m"], p["th"], int(p["runs"]), p["stages"], p["bytes"])


def wgrad_splits(pixel_tiles: int, out_tiles: int, sms: int,
                 path: str = "narrow") -> int:
    """Split-K factor over the kernel's output tiles, at most one split per
    pixel tile (both counts come from the kernel's library). ``path``:
    "narrow" (one block resident per SM): one whole wave, ``sms`` //
    out_tiles splits; "wgmma" (one block resident per SM) and "packed"
    (two): at most
    ``_WGMMA_BLOCKS_PER_SM`` per SM, rounded down, so power-of-two tile
    counts fill whole waves (at 16 output tiles 17 splits would leave a
    third wave nearly empty)."""
    if path in ("wgmma", "packed"):
        want = _WGMMA_BLOCKS_PER_SM * sms // out_tiles
    else:
        want = sms // out_tiles
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
        if (x.shape[0] * x.shape[1] * x.shape[2] >= F32_MAX_PIXELS
                or 9 * x.shape[3] * g.shape[3] >= 2 ** 31):
            raise ValueError(f"unsupported shape for the f32 dW: x "
                             f"{tuple(x.shape)}, g {tuple(g.shape)}")
        return   # aligned16 gave TMA and the packed route their 16-byte
                 # bases; the padded copy reads any
    if x.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("x and g must be 16-byte aligned (TMA; the packed "
                         "and narrow paths' 16-byte loads)")
    if (wgrad_path(x.shape[3], g.shape[3]) == "narrow"
            and not (_holds_last_chunk(x) and _holds_last_chunk(g))):
        raise ValueError("the narrow dW copies x's and g's rows as whole "
                         "16-byte chunks: their storage must hold the last "
                         "16-byte chunk (fused_conv.whole_chunks)")


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


def _wgrad_f32_launch(x: torch.Tensor, g: torch.Tensor,
                      xp: torch.Tensor = None, gp: torch.Tensor = None,
                      route: str = None) -> torch.Tensor:
    """One call of the f32 dW on checked CUDA inputs on ``route`` (by
    default ``wgrad_f32_route``'s; either route takes a shape with both
    sides narrow): a side the route pads goes as its padded copy (``xp``,
    ``gp`` where given, else one made here), then the split-K pass and,
    past one split, the sum over the splits in split order. Returns dW
    (3,3,Cin,Cout) f32; raises on a CUDA error."""
    n, h, wd, cin = x.shape
    cout = g.shape[3]
    route = route or wgrad_f32_route(cin, cout)
    pad_x, pad_g = wgrad_f32_pads(cin, cout, route)
    xs = padded_input(x, xp) if pad_x else x
    gs = padded_input(g, gp) if pad_g else g
    with torch.cuda.device(x.device):
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        splits = wgrad_f32_splits(n, h, wd, cin, cout, sms, route)
        out = torch.empty((3, 3, cin, cout), dtype=torch.float32,
                          device=x.device)
        ws = (torch.empty((splits, 3, 3, cin, cout), dtype=torch.float32,
                          device=x.device) if splits > 1 else None)
        err = f32_library().conv3x3_wgrad_f32(
            xs.data_ptr(), gs.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, n, h, wd, cin, cout,
            xs.shape[3], gs.shape[3], splits,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_wgrad f32 kernel launch failed: CUDA "
                           f"error {err} at x {tuple(x.shape)}, Cout {cout}")
    return out


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor, xp: torch.Tensor = None,
                  gp: torch.Tensor = None) -> torch.Tensor:
    """dW (3,3,Cin,Cout) f32 of conv3x3 pad-1 from x (N,H,W,Cin) and the
    cotangent g (N,H,W,Cout), NHWC contiguous; ``xp``, ``gp``: their
    padded copies (``fused_conv.pad_channels``) where the caller has them,
    read where the f32 route pads that side (else unused).

    On a CPU tensor this is ``conv3x3_wgrad_plain``. On a CUDA tensor it
    launches a Hopper kernel or raises: bf16 x and g on
    ``csrc/conv3x3_wgrad.cu`` (f32 accumulation), f32 x and g on the
    split-TF32 dW of ``csrc/conv3x3_f32.cu`` (``wgrad_f32_route``), both
    split-K with a deterministic second pass; an x or g whose data is not
    16-byte aligned is copied first (``fused_conv.aligned16``; not a side
    the padded copy reads, at any alignment)."""
    if x.device.type == "cpu":
        return conv3x3_wgrad_plain(x, g)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_wgrad: no kernel for {x.device}")
    if x.numel() == 0 and x.shape[:3] == g.shape[:3]:
        # an empty map: the sum over no pixel, no work and no launch
        return torch.zeros((3, 3, x.shape[3], g.shape[3]), device=x.device)
    path = wgrad_route(x.dtype, x.shape[-1], g.shape[-1])
    pad_x, pad_g = (wgrad_f32_pads(x.shape[-1], g.shape[-1])
                    if x.dtype == torch.float32 else (False, False))
    x = x if pad_x else aligned16(x)
    g = g if pad_g else aligned16(g)
    if path == "narrow" and x.is_contiguous() and g.is_contiguous():
        x, g = whole_chunks(x), whole_chunks(g)
    _check_wgrad(x, g)
    out = (_wgrad_f32_launch(x, g, xp, gp) if x.dtype == torch.float32
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


def step_pad_copies(shapes) -> int:
    """The padded copies (``fused_conv.pad_channels``) of one f32 training
    step over conv blocks ``shapes`` ((H, W, Cin, Cout) each, forward
    order; the stem's input needs no gradient): a forward's x where its
    route pads it (kept for its dW), a backward's g once where its dx or
    its dW pads it, and a dW's x where the forward did not pad it."""
    copies = 0
    for i, (_, _, cin, cout) in enumerate(shapes):
        pad_x, pad_g = wgrad_f32_pads(cin, cout)
        copies += f32_pads_input(cin, cout) or pad_x
        copies += pad_g or (i > 0 and f32_pads_input(cout, cin))
    return copies


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

def _padded_copy(t: torch.Tensor, needed: bool):
    """``t``'s padded copy where ``needed`` and an f32 kernel reads it (a
    CUDA tensor outside tracing), else None."""
    if (needed and t.device.type == "cuda" and t.dtype == torch.float32
            and t.numel() and not torch.compiler.is_compiling()):
        return pad_channels(t)
    return None


class _Conv3x3Train(torch.autograd.Function):
    """One padded copy of each tensor: a forward that pads x keeps the copy
    for its dW; a backward pads g once for both dx and dW."""

    @staticmethod
    def forward(ctx, x, w):
        xp = _padded_copy(x, f32_pads_input(w.shape[2], w.shape[3]))
        ctx.save_for_backward(x, w, xp)
        return conv3x3_fwd(x, w, xp)

    @staticmethod
    def backward(ctx, g):
        x, w, xp = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        need_dx, need_dw = ctx.needs_input_grad[:2]
        cin, cout = w.shape[2], w.shape[3]
        gp = _padded_copy(g, (need_dx and f32_pads_input(cout, cin))
                          or (need_dw and wgrad_f32_pads(cin, cout)[1]))
        dx = conv3x3_dgrad(g, w, gp) if need_dx else None
        dw = (conv3x3_wgrad(x, g, xp, gp).to(w.dtype) if need_dw
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
