"""Compare variants of the f32 conv kernels (``csrc/conv3x3_f32.cu``) side
by side on one card: each variant is a textual edit of the source, built
with nvcc into ``_build/f32_variants/`` and called through its C entry
points. At each shape every variant's forward, dx (``flip``) and dW are
held against the same function in float64 on the card beside the plain
f32 version (cuDNN, TF32 off), by chip_smoke's phase 14 error rule
(``error_rule``); then the forward, dx and dW are timed at b10 by CUDA
events in two rounds, in turn and in reverse order. The builds' ptxas
lines name each kernel and its registers.

    python -m pytorch_camvid_tpu_torch.f32_variants [variant ...]
    python -m pytorch_camvid_tpu_torch.f32_variants --padded [--before SRC]

Variants (``VARIANTS``): ``kept`` (the source as it is; it must pass the
rule); the wgmma route's design knobs: ``step_k8`` and ``step_k16`` (a
step sum over one or two k8 steps, 3 or 6 products into one scratch,
where the kept design sums four k8 steps' 12), ``no_pingpong`` (the
forward on one scratch accumulator: each step sum waited for and added
before the next is issued, as the kept dW does), ``dw_pingpong`` (the dW
on two, as the kept forward up to N = 64), ``n64`` (the forward's N tile
at most 64, where the kept one takes 128 for Cout > 64) and
``running_accumulator`` (no step sums: every product goes straight into
the running accumulator, so the tensor core's truncated sums are taken at
the accumulator's magnitude instead of one step's); the packed route's
knob and diagnostics: ``pk_fwd_no_pingpong`` (its forward on one
scratch, where the kept one ping-pongs as fw's), ``pk_no_mma``
(both packed kernels without their wgmmas: the data path alone),
``pk_no_stores`` (the packed forward without its output stores),
``pk_fwd_producer_only`` (its consumers hand each stage back untouched:
the producers' copies alone), ``pk_fwd_consumer_only`` (its producers copy
nothing: the consumers alone) and ``pk_dw_no_build`` (the packed dW's
builders hand over the planes without building them); and the faults chip_faults.py plants (``FAULTS``), in the
wgmma, packed and K5 kernels: ``single_pass`` (single-pass TF32, the
hi*hi product only),
``lo_hi_dropped`` (without the lo*hi product), ``stale_scratch`` (a step
sum's first product added onto the scratch, scale-d 1, which still holds
the step sum two steps back), ``atomic_splits`` (the wgmma route's dW's
splits added with atomics into a zeroed dW in launch order instead of the
ordered second pass) and ``packed_dw_bgr`` (the packed dW's planes built
with the stem's x channels 0 and 2 swapped), ``pad_ones`` (the padded
copy's channels past C left as 1s: TMA never reads them, so only the
copy's own check against ``fused_conv.pad_channels_plain`` can see it)
and ``flip_pad_first`` (the split weights' zero rows past Cin put first
under ``flip``, the real rows after them). All but ``kept`` are
diagnostic, not held to the rule.
``--padded`` times the shapes whose channels TMA cannot describe and the
packed route does not take (``PADDED``: the 150- and 23-class heads,
23->64, 3->21, UNet 5/64's and 3/32's odd-width dW) at b10: each piece
through its wrapper (the padded copy included), the dW of a shape with
both sides narrow also on the other route (``ALT_ROUTE``), cuDNN f32 with
TF32 off and on, and the bound (chip_smoke's ``f32_bound``). With
``--before SRC`` (a ``conv3x3_f32.cu`` of an earlier revision, one that
has the ``*_f32_narrow`` entries of PR 13's mma.sync kernels) it builds
that source beside its own headers and times those entries on the same
inputs, in turn with the wrappers (before, after, after, before).
Needs a CUDA card and nvcc; exits 1 without a card, or when a build fails
or ``kept`` breaks the rule.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from pytorch_camvid_tpu_torch import bench
from pytorch_camvid_tpu_torch.ops import conv_train, cuda_build, fused_conv

OUT = cuda_build.BUILD_DIR / "f32_variants"
# (N, H, W, Cin, Cout): UNet's widest block, the 64->12 head (N tile 16),
# a 512-channel block at 22x30, a 1024->512 block and a ragged 45x61
# tile, the ragged stem and VOC's 64->21 head (the packed route's forward
# and dW, its dx), a 150-class head and 5->10 (padded copies: route "f32"
# and the packed dW with both sides narrow), at b2 for the errors; the
# stem, VOC's head and UNet 5/64's 5->5 (the packed dW, g padded) timed
# too
SHAPES = ((2, 360, 480, 64, 64), (2, 360, 480, 64, 12),
          (2, 22, 30, 512, 512), (2, 45, 60, 1024, 512),
          (2, 45, 61, 64, 64), (2, 45, 61, 3, 64), (2, 360, 480, 64, 21),
          (2, 45, 61, 64, 150), (2, 45, 61, 5, 10))
TIMED = ((10, 360, 480, 64, 64), (10, 45, 60, 512, 512),
         (10, 180, 240, 256, 128), (10, 45, 60, 1024, 512),
         (10, 360, 480, 3, 64), (10, 360, 480, 64, 21),
         (10, 360, 480, 5, 5))
# ``--padded``: (N, H, W, Cin, Cout, pieces) of the calls PR 13's mma.sync
# kernels took before the padded copy (route "f32_narrow"), at b10: the
# 150- and 23-class heads' dx and dW, 23->64's forward and dW, 3->21's dW
# and the odd-width dW of UNet 5/64 and 3/32 (both sides narrow: timed on
# both routes, ``ALT_ROUTE``)
PADDED = ((10, 360, 480, 64, 150, ("dx", "wgrad")),
          (10, 360, 480, 64, 23, ("dx", "wgrad")),
          (10, 360, 480, 23, 64, ("fwd", "wgrad")),
          (10, 360, 480, 3, 21, ("wgrad",)),
          (10, 360, 480, 3, 5, ("wgrad",)), (10, 360, 480, 5, 5, ("wgrad",)),
          (10, 180, 240, 5, 10, ("wgrad",)),
          (10, 180, 240, 10, 10, ("wgrad",)),
          (10, 360, 480, 10, 5, ("wgrad",)),
          (10, 360, 480, 3, 6, ("wgrad",)), (10, 360, 480, 6, 6, ("wgrad",)))
ALT_ROUTE = {"f32": "f32_packed", "f32_packed": "f32"}
# the mma.sync dW's split rule: enough splits for four blocks on each SM
# over its 64 x 64 tiles of (tap, Cin) rows x Cout, at most one a 32-pixel
# chunk
BEFORE_BLOCKS_PER_SM, BEFORE_TILE, BEFORE_CHUNK = 4, 64, 32
# chip_smoke's phase 14 rule: err(t) = max|t - f64|; a kernel passes where
# err(kernel) <= max(ERR_FACTOR * err(plain f32), ERR_FLOOR * max|f64|)
ERR_FACTOR, ERR_FLOOR = 4.0, 2e-6
# the split product of one k8 step, in every wgmma kernel (K5's too)
_PRODUCTS = """  sm90::wgmma_tf32<N>(d, al, bh, first ? 0 : 1);   // lo * hi
  sm90::wgmma_tf32<N>(d, ah, bl, 1);               // hi * lo
  sm90::wgmma_tf32<N>(d, ah, bh, 1);               // hi * hi
"""
_SINGLE = [(_PRODUCTS,
            "  sm90::wgmma_tf32<N>(d, ah, bh, first ? 0 : 1);   // hi * hi\n")]
_NO_LO_HI = [(_PRODUCTS,
              "  sm90::wgmma_tf32<N>(d, ah, bl, first ? 0 : 1);   // hi * lo\n"
              "  sm90::wgmma_tf32<N>(d, ah, bh, 1);"
              "               // hi * hi\n")]
_STALE = [("  sm90::wgmma_tf32<N>(d, al, bh, first ? 0 : 1);   // lo * hi",
           "  sm90::wgmma_tf32<N>(d, al, bh, 1);   // lo * hi")]
_ATOMIC = [
    ("    float* dst = out + static_cast<int64_t>(split) * 9 * Cin * Cout;",
     "    float* dst = out;"),
    ("          *reinterpret_cast<float2*>(row + co) = make_float2(v0, v1);",
     "          atomicAdd(row + co, v0);\n"
     "          atomicAdd(row + co + 1, v1);"),
    ("          row[co] = v0;\n          if (co + 1 < Cout) row[co + 1] = v1;",
     "          atomicAdd(row + co, v0);\n"
     "          if (co + 1 < Cout) atomicAdd(row + co + 1, v1);"),
    ("    e = wgf::run(xf, gf, dst, N, H, W, Cin, Cout, xc, gc, splits, st);",
     "    cudaMemsetAsync(of, 0, elems * sizeof(float), st);\n"
     "    // no ordered second pass\n"
     "    return static_cast<int>(\n"
     "        wgf::run(xf, gf, of, N, H, W, Cin, Cout, xc, gc, splits, st));")]
_PACKED_BGR = [("            const int n = dx * Cn + c;   // the plane row "
                "of tap column dx",
                "            const int n = dx * Cn + (Cn == 3 ? 2 - c : c);")]
_PAD_ONES = [("    v.y = c + 1 < C ? src[1] : 0.f;\n"
              "    v.z = c + 2 < C ? src[2] : 0.f;\n"
              "    v.w = c + 3 < C ? src[3] : 0.f;",
              "    v.y = c + 1 < C ? src[1] : 1.f;\n"
              "    v.z = c + 2 < C ? src[2] : 1.f;\n"
              "    v.w = c + 3 < C ? src[3] : 1.f;")]
_FLIP_PAD_FIRST = [
    ("    const float v =\n"
     "        c >= Cin ? 0.f\n"
     "        : flip   ? w[(static_cast<int64_t>(8 - t) * Cout + n) * Cin + c]\n"
     "                 : w[(static_cast<int64_t>(t) * Cin + c) * Cout + n];",
     "    const int cf = flip ? c - (Cs - Cin) : c;\n"
     "    const float v =\n"
     "        cf < 0 || cf >= Cin ? 0.f\n"
     "        : flip ? w[(static_cast<int64_t>(8 - t) * Cout + n) * Cin + cf]\n"
     "               : w[(static_cast<int64_t>(t) * Cin + cf) * Cout + n];")]
VARIANTS = {
    "kept": [],
    "step_k8": [("constexpr int STEP_K8 = 4;", "constexpr int STEP_K8 = 1;")],
    "step_k16": [("constexpr int STEP_K8 = 4;", "constexpr int STEP_K8 = 2;")],
    "no_pingpong": [("constexpr bool PINGPONG = true;",
                     "constexpr bool PINGPONG = false;")],
    "dw_pingpong": [("constexpr bool DW_PINGPONG = false;",
                     "constexpr bool DW_PINGPONG = true;")],
    "n64": [("constexpr int MAX_TILE_N = 128;",
             "constexpr int MAX_TILE_N = 64;")],
    "running_accumulator": [("constexpr bool STEP_SUMS = true;",
                             "constexpr bool STEP_SUMS = false;")],
    "pk_fwd_no_pingpong": [
        ("        k8_step<F_BN, kPingpong<F_BN>>(acc, sc, s, ah, al, bh, bl);",
         "        k8_step<F_BN, false>(acc, sc, s, ah, al, bh, bl);"),
        ("      k8_drain<F_BN, kPingpong<F_BN>>(acc, sc, KSTEPS);",
         "      k8_drain<F_BN, false>(acc, sc, KSTEPS);")],
    "pk_no_mma": [
        ("        k8_step<F_BN, kPingpong<F_BN>>(acc, sc, s, ah, al, bh, bl);",
         "        acc[s % 32] += __uint_as_float(ah[0] ^ al[1] ^ ah[2] ^ al[3]"
         " ^ static_cast<uint32_t>(bh ^ bl));"),
        ("        k8_step<BN, PP>(acc, sc, j, ah, al, bh, bl);",
         "        acc[j % (BN / 2)] += __uint_as_float(ah[0] ^ al[1] ^ ah[2]"
         " ^ al[3] ^ static_cast<uint32_t>(bh ^ bl));")],
    "pk_no_stores": [("          if (ww >= W || h >= H) continue;",
                      "          if (ww >= W || h >= H || relu < 2) continue;"),
                     ("          if (h < H) {\n            sm90::tma_store_4d",
                      "          if (h < H && relu > 1) {\n"
                      "            sm90::tma_store_4d")],
    "pk_dw_no_build": [("        build(t_begin + it, planes + pbuf * 2 * PLANE,",
                        "        if (Cn < 0) build(t_begin + it, planes + pbuf * 2 * PLANE,")],
    "pk_fwd_producer_only": [
        ("      sm90::mbar_wait(&pfull[st], (it / F_STAGES) & 1);\n",
         "      sm90::mbar_wait(&pfull[st], (it / F_STAGES) & 1);\n"
         "      if (relu < 2) {\n"
         "        if (lane == 0) sm90::mbar_arrive(&pempty[st]);\n"
         "        continue;\n"
         "      }\n")],
    "pk_fwd_consumer_only": [
        ("        for (int i = p; i < F_PH * CPR; i += F_PRODUCERS) {",
         "        for (int i = p; i < F_PH * CPR && relu > 1;"
         " i += F_PRODUCERS) {")],
    "packed_dw_bgr": _PACKED_BGR,
    "single_pass": _SINGLE, "lo_hi_dropped": _NO_LO_HI,
    "stale_scratch": _STALE, "atomic_splits": _ATOMIC,
    "pad_ones": _PAD_ONES, "flip_pad_first": _FLIP_PAD_FIRST}
FAULTS = ("single_pass", "lo_hi_dropped", "stale_scratch", "atomic_splits",
          "packed_dw_bgr", "pad_ones", "flip_pad_first")


def error_rule(got: torch.Tensor, plain: torch.Tensor,
               ref: torch.Tensor) -> tuple:
    """(err(kernel), err(plain), max|f64|, the limit) of the f32 error rule
    against the float64 ``ref``; a NaN error fails it."""
    ek = (got.double() - ref).abs().max().item()
    ep = (plain.double() - ref).abs().max().item()
    scale = ref.abs().max().item()
    return ek, ep, scale, max(ERR_FACTOR * ep, ERR_FLOOR * scale)


def _edited(edits) -> str:
    src = fused_conv.F32_SOURCE.read_text()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"variant edit does not apply: {old!r}")
        src = src.replace(old, new)
    return src


def _build(name: str):
    """(name, the bound library or None, ptxas's register lines)."""
    src = OUT / f"f32_{name}.cu"
    src.write_text(_edited(VARIANTS[name]))
    lib = src.with_suffix(".so")
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                        "-I", str(cuda_build.CSRC), "-o", str(lib), str(src)],
                       capture_output=True, text=True)
    log = [ln.strip()[:120] for ln in (r.stdout + r.stderr).splitlines()
           if "error" in ln or "registers" in ln or "spill" in ln
           or "Compiling entry" in ln or "serialized" in ln]
    if r.returncode:
        return name, None, log
    return name, fused_conv.bind_f32(ctypes.CDLL(str(lib))), log


def build(names) -> tuple:
    """The variants ``names`` built side by side: ({name: bound library}
    of those that built, [(name, ok, ptxas's lines)])."""
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build, names))
    return ({n: lib for n, lib, _ in built if lib},
            [(n, lib is not None, log) for n, lib, log in built])


def _ms(fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _calls(lib, x, w, g):
    """The variant's forward, dx and dW on (x, w, g), each side that its
    route pads as a padded copy made once here (``pad_channels_plain``):
    each returns its output after one launch (or raises on a CUDA
    error)."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = conv_train.wgrad_f32_splits(n, h, wd, cin, cout, sms)
    ones = {c: (torch.ones(c, device="cuda"), torch.zeros(c, device="cuda"))
            for c in (cin, cout)}
    ws = torch.empty(splits, 3, 3, cin, cout, device="cuda")
    padded = {c: fused_conv.pad_channels_plain(t).contiguous()
              for c, t in ((cin, x), (cout, g)) if c % 4}
    wide = max(cin, cout)
    wsplit = torch.empty(18 * fused_conv.f32_stride(wide) * wide,
                         device="cuda")

    def conv(t, cout_, flip):
        out = torch.empty(t.shape[:3] + (cout_,), device="cuda")
        a, b = ones[cout_]
        c = t.shape[3]
        src = padded[c] if fused_conv.f32_pads_input(c, cout_) else t
        err = lib.conv3x3_bn_relu_f32(
            src.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), wsplit.data_ptr(), n, h, wd, c, cout_,
            src.shape[3], 0, int(flip), stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return out

    pad_x, pad_g = conv_train.wgrad_f32_pads(cin, cout)
    xs, gs = padded[cin] if pad_x else x, padded[cout] if pad_g else g

    def wgrad():
        out = torch.empty(3, 3, cin, cout, device="cuda")
        err = lib.conv3x3_wgrad_f32(
            xs.data_ptr(), gs.data_ptr(), out.data_ptr(), ws.data_ptr(), n,
            h, wd, cin, cout, xs.shape[3], gs.shape[3], splits, stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return out

    return {"fwd": lambda: conv(x, cout, False),
            "dx": lambda: conv(g, cin, True), "wgrad": wgrad}


def _references(x, w, g) -> dict:
    """{piece: (plain f32, float64)} on the card."""
    x64, w64, g64 = x.double(), w.double(), g.double()
    dw64 = torch.nn.grad.conv2d_weight(
        x64.permute(0, 3, 1, 2), (w.shape[3], x.shape[3], 3, 3),
        g64.permute(0, 3, 1, 2), padding=1)
    return {"fwd": (conv_train.conv3x3_train_plain(x, w),
                    conv_train.conv3x3_train_plain(x64, w64)),
            "dx": (conv_train.conv3x3_dgrad_plain(g, w),
                   conv_train.conv3x3_dgrad_plain(g64, w64)),
            "wgrad": (conv_train.conv3x3_wgrad_plain(x, g),
                      dw64.permute(2, 3, 1, 0))}


def f32_bound(n, h, w, cin, cout) -> tuple:
    """Bound of one f32 conv3x3 pass (fwd, dx and dW alike; chip_smoke's
    too): the FLOPs at the split product's rate, a third of the TF32 peak,
    or each f32 tensor moved once at the memory rate, whichever is
    larger."""
    return bench.bound_ms(2.0 * 9 * n * h * w * cin * cout,
                          4 * (n * h * w * (cin + cout) + 9 * cin * cout),
                          bench.H100_TF32_PEAK / 3)


def build_before(src: Path) -> ctypes.CDLL:
    """An earlier revision's ``conv3x3_f32.cu`` (one with the
    ``*_f32_narrow`` entries of PR 13's mma.sync kernels) built beside its
    own headers, those two entries typed; raises if the build fails."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "f32_before.so"
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                        str(src.parent), "-o", str(lib), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{src}: nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(lib))
    lib.conv3x3_bn_relu_f32_narrow.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.conv3x3_wgrad_f32_narrow.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.conv3x3_bn_relu_f32_narrow.restype = ctypes.c_int
    lib.conv3x3_wgrad_f32_narrow.restype = ctypes.c_int
    return lib


def _before_calls(lib, x, w, g) -> dict:
    """The earlier revision's mma.sync kernels on (x, w, g): K1's forward,
    dx and dW (split as that revision split it)."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-9 * cin // BEFORE_TILE) * -(-cout // BEFORE_TILE)
    splits = max(1, min(-(-BEFORE_BLOCKS_PER_SM * sms // blocks),
                        -(-n * h * wd // BEFORE_CHUNK), 65535))
    ws = torch.empty(splits, 3, 3, cin, cout, device="cuda")
    ones = {c: (torch.ones(c, device="cuda"), torch.zeros(c, device="cuda"))
            for c in (cin, cout)}

    def conv(t, cout_, flip):
        out = torch.empty(t.shape[:3] + (cout_,), device="cuda")
        a, b = ones[cout_]
        err = lib.conv3x3_bn_relu_f32_narrow(
            t.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, h, wd, t.shape[3], cout_, 0, int(flip),
            stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return out

    def wgrad():
        out = torch.empty(3, 3, cin, cout, device="cuda")
        err = lib.conv3x3_wgrad_f32_narrow(
            x.data_ptr(), g.data_ptr(), out.data_ptr(), ws.data_ptr(), n, h,
            wd, cin, cout, splits, stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return out

    return {"fwd": lambda: conv(x, cout, False),
            "dx": lambda: conv(g, cin, True), "wgrad": wgrad}


def padded_timings(before: Path = None) -> int:
    """``--padded``: at each of ``PADDED``'s calls, the wrappers' time (the
    padded copy included) and the copy's alone, a dW with both sides
    narrow also on ``ALT_ROUTE``'s route, cuDNN f32 with TF32 off and on
    and the bound; with ``before``, the earlier revision's mma.sync
    kernels on the same inputs in turn with the wrappers (before, after,
    after, before). One line a call."""
    lib = build_before(before) if before else None
    print(bench.card(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, h, w, cin, cout, pieces in PADDED:
        x = torch.randn(n, h, w, cin, generator=gen, device="cuda")
        wt = (torch.randn(3, 3, cin, cout, generator=gen, device="cuda")
              * (2.0 / (9 * cin)) ** 0.5)
        g = torch.randn(n, h, w, cout, generator=gen, device="cuda")
        after = {"fwd": lambda: conv_train.conv3x3_fwd(x, wt),
                 "dx": lambda: conv_train.conv3x3_dgrad(g, wt),
                 "wgrad": lambda: conv_train.conv3x3_wgrad(x, g)}
        library = {"fwd": lambda: conv_train.conv3x3_train_plain(x, wt),
                   "dx": lambda: conv_train.conv3x3_dgrad_library(g, wt, x),
                   "wgrad": lambda: conv_train.conv3x3_wgrad_plain(x, g)}
        old = _before_calls(lib, x, wt, g) if lib else {}
        line = []
        for piece in pieces:
            if piece == "wgrad":
                route = conv_train.wgrad_f32_route(cin, cout)
                pads = conv_train.wgrad_f32_pads(cin, cout)
                sides = [t for t, p in zip((x, g), pads) if p]
            else:
                src, c_out = (g, cin) if piece == "dx" else (x, cout)
                route = fused_conv.f32_route(src.shape[3], c_out)
                pads = fused_conv.f32_pads_input(src.shape[3], c_out)
                sides = [src] if pads else []
            t = [_ms(old[piece])] if lib else []
            t += [_ms(after[piece]), _ms(after[piece])]
            if lib:
                t.append(_ms(old[piece]))
            copy = sum(_ms(lambda s=s: fused_conv.pad_channels(s))
                       for s in sides)
            alt = ""
            if (piece == "wgrad" and cin % 4 and cout % 4
                    and conv_train.packed_narrow_side(cin, cout)):
                other = ALT_ROUTE[route]
                ms = _ms(lambda: conv_train._wgrad_f32_launch(
                    x, g, route=other))
                alt = f", on {other} {ms:.4f}"
            lib_ms = _ms(library[piece])
            torch.backends.cudnn.allow_tf32 = True
            tf32_ms = _ms(library[piece])
            torch.backends.cudnn.allow_tf32 = False
            bound, by = f32_bound(n, h, w, cin, cout)
            now = t[1:3] if lib else t
            line.append(
                f"{piece} on {route} {now[0]:.4f}/{now[1]:.4f} ms (copies "
                f"{copy:.4f}{alt})"
                + (f", mma.sync {t[0]:.4f}/{t[3]:.4f}" if lib else "")
                + f"; cuDNN f32 {lib_ms:.4f}, TF32 {tf32_ms:.4f}; bound "
                f"{bound:.4f} by {by}")
        print(f"{n}x{h}x{w} {cin}->{cout}: " + "; ".join(line), flush=True)
        del x, wt, g, after, library, old
        torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    if not torch.cuda.is_available():
        print("f32_variants: no CUDA device", file=sys.stderr)
        return 1
    if args[:1] == ["--padded"]:
        before = (Path(args[args.index("--before") + 1])
                  if "--before" in args else None)
        return padded_timings(before)
    names = args or list(VARIANTS)
    libs, logs = build(names)
    for name, built, log in logs:
        print(f"build {name}: {'ok' if built else 'FAILED'}; "
              + " | ".join(log), flush=True)
    if not libs:
        return 1
    print(bench.card(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = len(libs) == len(names)
    for n, h, w, cin, cout in SHAPES + TIMED:
        x = torch.randn(n, h, w, cin, generator=gen, device="cuda")
        wt = (torch.randn(3, 3, cin, cout, generator=gen, device="cuda")
              * (2.0 / (9 * cin)) ** 0.5)
        g = torch.randn(n, h, w, cout, generator=gen, device="cuda")
        calls = {name: _calls(lib, x, wt, g) for name, lib in libs.items()}
        line = []
        if (n, h, w, cin, cout) in SHAPES:
            for piece, (plain, ref) in _references(x, wt, g).items():
                errs = {}
                for name, fns in calls.items():
                    errs[name], ep, _, limit = error_rule(fns[piece](), plain,
                                                          ref)
                    ok &= name != "kept" or errs[name] <= limit
                line.append(f"{piece} plain {ep:.3g} limit {limit:.3g} "
                            + " ".join(f"{k} {v:.3g}"
                                       for k, v in errs.items()))
        else:
            for piece in ("fwd", "dx", "wgrad"):
                fns = {name: c[piece] for name, c in calls.items()}
                times = {name: [_ms(fn)] for name, fn in fns.items()}
                for name, fn in reversed(list(fns.items())):
                    times[name].append(_ms(fn))
                line.append(f"{piece} " + " ".join(
                    f"{k} {t[0]:.4f}/{t[1]:.4f} ms"
                    for k, t in times.items()))
        print(f"{n}x{h}x{w} {cin}->{cout}: " + "; ".join(line), flush=True)
        del x, wt, g, calls
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
