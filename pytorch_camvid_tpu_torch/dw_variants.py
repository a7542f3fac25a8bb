"""Time variants of the dW kernels (``csrc/conv3x3_wgrad.cu``) side by side
on one card: each variant is a textual edit of the source, built with nvcc
into ``_build/dw_variants/``.

    python -m pytorch_camvid_tpu_torch.dw_variants [variant ...]

The packed path (namespace ``pk``), ``VARIANTS``, called through its C
entry point at the stem's and the head's shapes (360x480, UNet's batch 24),
timed by CUDA events in two rounds, in turn and in reverse order, beside
cuDNN's bf16 wgrad: ``kept`` (the source as it is, checked against the
plain version at the dW limit, 1e-2 of max|plain|, as are all but the
diagnostic ones); two that leave work out and so compute something else
(``DIAGNOSTIC``, not checked): ``no_mma`` (the consumers wait for each
stage and release it, with no wgmma: the loads alone) and
``no_narrow_loads`` (the producers copy none of the narrow patch from
device memory and transpose what the buffers hold: TMA, the transposition
and the wgmmas alone); ``scalar_loads`` (the producers' first design: one
2-byte load a pixel and channel into registers, where the kept one copies
the patch rows as 16-byte cp.async into shared memory and reads them from
there); ``narrow_path`` (the stem and the head on the narrow path); and
``kept_2x_splits`` (the source as it is at twice the split-K, two waves).

The narrow path (namespace ``narrow``), ``NARROW_VARIANTS`` (names
``narrow_*``), called through ``conv_train.conv3x3_wgrad`` with the
variant's library in place of the built one, at UNet 9/16's narrow dW
(b24, ``bench.narrow_wgrad_cases``) and a 150-class head's 64->150: each
held to the plain version (1e-2 of max|plain|) at 2x45x61, then timed as
device-busy ms (``perf_probe.time_op``) on inputs spanning 200 MB, the
variants in turn, then in reverse order, the lesser of the two kept:
``narrow_kept``; ``narrow_first`` (every shape on the first, mma.sync,
design, ``csrc/wgrad_mma_sync.cuh``, at its own split rule: the reading
before the redesign); ``narrow_gather_a`` (route (a): the producers copy
the M side's raw rows as they lie into the stage and each consumer lane
gathers A at its rows' offsets, where the kept route (b) builds three
column-shifted channel-major planes and loads A with ldmatrix; whole rows
of one M tile only, as at these shapes); ``narrow_raw_4`` (four raw
buffers, three tiles ahead, and two ring stages); ``narrow_stages_2`` (two
ring stages
where three fit); ``narrow_2x_splits`` (two waves of blocks, the split
rule's alternative); and the diagnostic ``narrow_no_mma`` (no wgmma),
``narrow_no_put`` (no transposition into the stage) and ``narrow_no_copy``
(no copy from device memory). Needs a CUDA card and nvcc; exits 1
without a card.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from pytorch_camvid_tpu_torch import bench
from pytorch_camvid_tpu_torch.ops import conv_train, cuda_build

OUT = cuda_build.BUILD_DIR / "dw_variants"
SHAPES = ((2, 45, 61, 3, 64), (2, 45, 61, 64, 12), (24, 360, 480, 3, 64),
          (24, 360, 480, 64, 12))
# the first design of the producers' narrow loads, kept as a variant: each
# thread one line (patch row, channel) of 18 pixels, one 2-byte load a
# pixel, two tiles ahead in registers, written as 16-byte rows of each copy
_FIRST = ("    // Patch row pr (input row h0 + pr - 1) is L = 18 x Cn "
          "elements,",
          "  } else {\n    // ------------------------------------------------"
          "------ consumers")
_SCALAR_PRODUCERS = r"""    int pr[LPT], ch[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = p + j * PRODUCERS;
      pr[j] = l < PH * Cn ? l / Cn : -1;
      ch[j] = l % Cn;
    }
    uint32_t va[LPT][PWN], vb[LPT][PWN];
    auto fetch = [&](uint32_t (&v)[LPT][PWN], int t) {
      if (t >= t_end) return;
      const int w0 = t % tiles_w * TW;
      const int h0 = t / tiles_w % tiles_h * TH;
      const int img = t / (tiles_w * tiles_h);
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int h = h0 + pr[j] - 1;
        const bool row = pr[j] >= 0 && h >= 0 && h < H;
        const int64_t base =
            ((static_cast<int64_t>(img) * H + h) * W + w0 - 1) * Cn + ch[j];
#pragma unroll
        for (int q = 0; q < PWN; ++q) {
          const int w = w0 + q - 1;
          v[j][q] = row && w >= 0 && w < W
                        ? static_cast<uint32_t>(
                              __ldg(xs + base + static_cast<int64_t>(q) * Cn))
                        : 0u;
        }
      }
    };
    auto put = [&](const uint32_t (&v)[LPT][PWN], unsigned char* st) {
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        if (pr[j] < 0) continue;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const uint32_t a =
              smem_u32(st + (dx * Cn + ch[j]) * PLANE + pr[j] * (TW * 2));
          uint32_t u[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            u[e] = v[j][dx + 2 * e] | (v[j][dx + 2 * e + 1] << 16);
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
                       "r"(u[0]), "r"(u[1]), "r"(u[2]), "r"(u[3])
                       : "memory");
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                           a + 16),
                       "r"(u[4]), "r"(u[5]), "r"(u[6]), "r"(u[7])
                       : "memory");
        }
      }
    };
    int s = 0;
    uint32_t phase = 0;
    auto step = [&](const uint32_t (&v)[LPT][PWN], int t) {
      sm90::mbar_wait(&empty[s], phase ^ 1);
      if (p == 0) {
        const int w0 = t % tiles_w * TW;
        const int h0 = t / tiles_w % tiles_h * TH;
        const int img = t / (tiles_w * tiles_h);
        sm90::mbar_arrive_expect_tx(&full[s], WIDE_TX);
        sm90::tma_load_4d(smem + s * WIDE_TX, &wmap, &full[s], n0, w0, h0,
                          img);
      }
      put(v, nar0 + s * nb);
      sm90::mbar_arrive(&full[s]);
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    };
    fetch(va, t_begin);
    fetch(vb, t_begin + 1);
    for (int t = t_begin; t < t_end; t += 2) {
      step(va, t);
      fetch(va, t + 2);
      if (t + 1 >= t_end) break;
      step(vb, t + 1);
      fetch(vb, t + 3);
    }
"""
VARIANTS = {
    "kept": [],
    "no_mma": [("sm90::wgmma_rs<64, 1>(acc[mi], afrag[r & 1][mi], desc);",
                "")],
    "no_narrow_loads": [
        ("          sm90::cp_async16(smem_u32(rb + i * 16), xs + g0, 2 * n8);",
         "")],
    "scalar_loads": [(_FIRST, _SCALAR_PRODUCERS)],
    "narrow_path": [("    return 2;\n  return 0;\n}",
                     "    return 0;\n  return 0;\n}")],
}
DIAGNOSTIC = ("no_mma", "no_narrow_loads")
# variants that run a built source at another split-K: (source, factor)
SPLIT_RUNS = {"kept_2x_splits": ("kept", 2)}

# route (a) of the narrow dW: the producers copy the M side's raw rows as
# they lie into the stage (zeroing what lies outside the image); each
# consumer lane gathers its A fragment's 16-bit values at its rows'
# offsets (pad rows masked to zero), where the kept route (b) builds the
# three shifted channel-major planes and loads A with ldmatrix
_GATHER_PRODUCERS = r"""      const bool inner = h0 >= 1 && h0 + th < H && w0 >= 1 && w0 + TW < W;
      for (int i = p; i < geo.raw_m / 16; i += PRODUCERS) {
        uint32_t w[4];
        asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                     : "r"(rb + 16 * i));
        sts128(st + 16 * i, w[0], w[1], w[2], w[3]);
      }
      if (!inner) {
        asm volatile("bar.sync 2, %0;\n" ::"n"(PRODUCERS) : "memory");
        for (int i = p; i < ph * lm; i += PRODUCERS) {
          const int pr = i / lm, e = i - pr * lm, q = e / cm;
          const int h = h0 + pr - 1, w = w0 + q - 1;
          if (h < 0 || h >= H || w < 0 || w >= W)
            asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(
                             st + 2 * (bm + pr * geo.rsm + e)),
                         "h"(static_cast<unsigned short>(0))
                         : "memory");
        }
      }
"""
_GATHER_OFFSETS = r"""    // route (a): rows g8 and g8 + 8 of each m64 tile, their byte offsets
    // at pixel 2 (lane % 4), the pixel stride, and a mask (0: a pad row)
    uint32_t ao[MTW][2], am[MTW][2];
    const uint32_t ps = 2 * cm;
#pragma unroll
    for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = 64 * (mfirst + mi) + 16 * warp + (lane >> 2) + 8 * j;
        const int tap = m / cm, c = m - tap * cm;
        ao[mi][j] = m < 9 * cm ? 2 * ((tap / 3) * geo.rsm + (tap % 3) * cm +
                                      c) + 2 * (lane & 3) * ps
                               : 0;
        am[mi][j] = m < 9 * cm ? 0xFFFFFFFFu : 0u;
      }
    auto gather = [&](uint32_t (&f)[4], uint32_t base, int mi) {
      const uint32_t p0 = base + ao[mi][0], p1 = base + ao[mi][1];
      f[0] = (lds16(p0) | lds16(p0 + ps) << 16) & am[mi][0];
      f[1] = (lds16(p1) | lds16(p1 + ps) << 16) & am[mi][1];
      f[2] = (lds16(p0 + 8 * ps) | lds16(p0 + 9 * ps) << 16) & am[mi][0];
      f[3] = (lds16(p1 + 8 * ps) | lds16(p1 + 9 * ps) << 16) & am[mi][1];
    };
"""

# the narrow dW's variants (namespace narrow); each but the kept source
# drops the plan's static_asserts, which an edit may move
NARROW_VARIANTS = {
    "narrow_kept": [],
    "narrow_first": [
        ("// ================================================================ "
         "narrow\n",
         '#include "wgrad_mma_sync.cuh"\n\n'),
        ("  const Plan p = plan(Cin, Cout);\n"
         "  if (p.smem == 0 || p.tiles_m > 65535) return cudaErrorInvalidValue;"
         "\n",
         "  return mma_sync::run(x, g, dst, N, H, W, Cin, Cout, splits, st);\n"
         "  const Plan p = plan(Cin, Cout);\n"),
        ("  return static_cast<long long>(p.tiles_n) * p.tiles_m;\n",
         "  return static_cast<long long>((Cin + mma_sync::KC - 1) / "
         "mma_sync::KC) * ((Cout + mma_sync::BN - 1) / mma_sync::BN);\n")],
    "narrow_gather_a": [
        (("      for (int l = p; l < ph * cmb; l += PRODUCERS) {",
          "      const uint32_t nsrc = rb + geo.raw_m"), _GATHER_PRODUCERS),
        (("    uint32_t aoff[MTW];", "    float acc[MTW][BN / 2];"),
         _GATHER_OFFSETS),
        ("        const uint32_t bs = st + geo.planes_bytes;\n",
         "        const uint32_t bs = st + geo.planes_bytes;\n"
         "        int img, h0, w0;\n"
         "        origin(t, img, h0, w0);\n"
         "        const uint32_t sa =\n"
         "            st + 2 * static_cast<int>(corner_m(img, h0, w0) & 7);\n"),
        ("            sm90::ldmatrix_x4(fa[mi], st + aoff[mi] + r * 32);",
         "            gather(fa[mi], sa + 2 * r * geo.rsm, mi);"),
        ("            sm90::ldmatrix_x4(fb[mi], st + aoff[mi] + (r + 1) * 32);",
         "            gather(fb[mi], sa + 2 * (r + 1) * geo.rsm, mi);")],
    "narrow_raw_4": [("constexpr int RAW = 3; ", "constexpr int RAW = 4; "),
                     ("constexpr int MAX_STAGES = 3;",
                      "constexpr int MAX_STAGES = 2;")],
    "narrow_stages_2": [("constexpr int MAX_STAGES = 3;",
                         "constexpr int MAX_STAGES = 2;")],
    "narrow_no_mma": [
        ("            sm90::wgmma_rs_kmajor<BN>(acc[mi], fa[mi], bs + r * "
         "(BN * 32));", ""),
        ("            sm90::wgmma_rs_kmajor<BN>(acc[mi], fb[mi],\n"
         "                                      bs + (r + 1) * (BN * 32));",
         "")],
    "narrow_no_put": [("      put(t, smem_s + s * geo.stage_bytes);\n", "")],
    "narrow_no_copy": [
        ("        sm90::cp_async16(dst + 2 * static_cast<int>(a - a0), "
         "src + a, 16);\n", "        ;\n")],
}
NARROW_DIAGNOSTIC = ("narrow_no_mma", "narrow_no_put", "narrow_no_copy")
NARROW_SPLIT_RUNS = {"narrow_2x_splits": ("narrow_kept", 2)}
# the first design's split-K: at least this many blocks an SM over its
# 32 x 64 output tiles
FIRST_BLOCKS_PER_SM = 8
NARROW_TOL = 1e-2   # max|variant - plain| / max|plain|, as chip_smoke's dW
WIDTH = 0.5625      # UNet at 9/16
SPAN = 200_000_000  # bytes of x and g a timed rotation spans: 4x the L2


def _first_splits(pixel_tiles: int, out_tiles: int, sms: int,
                  path: str) -> int:
    """``conv_train.wgrad_splits`` for ``narrow_first``: the first design's
    rule."""
    return max(1, min(-(-FIRST_BLOCKS_PER_SM * sms // out_tiles),
                      pixel_tiles, 65535))


def _edited(edits) -> str:
    """The source with each edit applied: (old, new) replaces the text
    old; ((first, last), new) replaces the text from first up to the next
    last."""
    src = conv_train.WGRAD_SOURCE.read_text()
    for old, new in edits:
        if isinstance(old, tuple):
            i = src.find(old[0])
            j = src.find(old[1], i)
            if i < 0 or j < i:
                raise ValueError(f"variant edit does not apply: {old!r}")
            old = src[i:j]
        if old not in src:
            raise ValueError(f"variant edit does not apply: {old!r}")
        src = src.replace(old, new)
    return src


def edited_source(name: str) -> str:
    """The source of variant ``name`` (a narrow one without the plan's
    ``static_assert``s where it edits the source)."""
    if name in NARROW_VARIANTS:
        edits = NARROW_VARIANTS[name]
        src = _edited(edits)
        return re.sub(r"static_assert\(plan\(.*\n", "", src) if edits \
            else src
    return _edited(VARIANTS[name])


def _build(name: str):
    """(name, the bound library or None, ptxas's lines for the kernels of
    the variant's path)."""
    src = OUT / f"dw_{name}.cu"
    src.write_text(edited_source(name))
    lib = src.with_suffix(".so")
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                        str(lib), str(src)], capture_output=True, text=True)
    lines = (r.stdout + r.stderr).splitlines()
    key = "narrow" if name in NARROW_VARIANTS else "packed"
    log = [ln.strip()[:160] for i, ln in enumerate(lines)
           if "error" in ln or "fatal" in ln
           or (("registers" in ln or "spill" in ln)
               and any(key in p for p in lines[max(0, i - 2):i]))]
    if r.returncode:
        return name, None, log
    return name, conv_train.bind_wgrad(ctypes.CDLL(str(lib))), log


def _ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _packed(names, libs, gen, sms) -> bool:
    """The packed variants at ``SHAPES`` (module docstring)."""
    ok = True
    for n, h, w, cin, cout in SHAPES:
        x = torch.randn(n, h, w, cin, generator=gen, device="cuda"
                        ).bfloat16()
        g = torch.randn(n, h, w, cout, generator=gen, device="cuda"
                        ).bfloat16()
        ref = conv_train.conv3x3_wgrad_plain(x, g)
        tiles = n * -(-h // 8) * -(-w // 16)
        # each variant at the split-K the wrapper picks for its path
        splits, lib_of = {}, {}
        for name in names:
            src, factor = SPLIT_RUNS.get(name, (name, 1))
            if src not in libs:
                continue
            lib_of[name] = lib = libs[src]
            path = conv_train.WGRAD_PATHS[lib.conv3x3_wgrad_path(cin, cout)]
            base = conv_train.wgrad_splits(
                tiles, lib.conv3x3_wgrad_out_tiles(cin, cout), sms, path)
            splits[name] = min(base * factor, tiles, 65535)
        if not lib_of:
            return ok
        out = torch.empty(3, 3, cin, cout, device="cuda")
        ws = torch.empty(max(splits.values()), 3, 3, cin, cout,
                         device="cuda")
        calls = {name: (lambda lib=lib, s=splits[name]:
                        lib.conv3x3_wgrad_bf16(
                            x.data_ptr(), g.data_ptr(), out.data_ptr(),
                            ws.data_ptr(), n, h, w, cin, cout, s,
                            torch.cuda.current_stream().cuda_stream))
                 for name, lib in lib_of.items()}
        line = []
        for name, call in calls.items():
            rc = call()
            torch.cuda.synchronize()
            err = ((out - ref).abs().max() / ref.abs().max()).item()
            ok &= rc == 0 and (name in DIAGNOSTIC or err <= 1e-2)
            line.append(f"{name} rc {rc} err {err:.3g} splits "
                        f"{splits[name]}")
        if n == 24:
            times = {name: [_ms(call)] for name, call in calls.items()}
            for name, call in reversed(list(calls.items())):
                times[name].append(_ms(call))
            line += [f"{name} {t[0]:.4f}/{t[1]:.4f} ms"
                     for name, t in times.items()]
            xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            line.append("cuDNN bf16 wgrad {:.4f}".format(_ms(
                lambda: torch.nn.grad.conv2d_weight(
                    xc, (cout, cin, 3, 3), gc, padding=1))))
        print(f"{n}x{h}x{w} {cin}->{cout}: " + "; ".join(line), flush=True)
        del x, g, ws
        torch.cuda.empty_cache()
    return ok


def _narrow(names, libs, gen) -> bool:
    """The narrow variants at UNet 9/16's narrow dW and 64->150 (module
    docstring), through the wrapper with each library in its place."""
    from pytorch_camvid_tpu_torch import perf_probe

    runs = {name: NARROW_SPLIT_RUNS.get(name, (name, 1)) for name in names
            if NARROW_SPLIT_RUNS.get(name, (name, 1))[0] in libs}
    if not runs:
        return True
    ok = True
    real_lib, real_splits = conv_train._wgrad_library, conv_train.wgrad_splits
    cases = bench.narrow_wgrad_cases(WIDTH, 24) + [(24, 360, 480, 64, 150, 0)]
    sums = dict.fromkeys(runs, 0.0)
    try:
        for n, h, w, cin, cout, blocks in cases:
            xs = torch.randn(2, 45, 61, cin, generator=gen, device="cuda"
                             ).bfloat16()
            gs = torch.randn(2, 45, 61, cout, generator=gen, device="cuda"
                             ).bfloat16()
            ref = conv_train.conv3x3_wgrad_plain(xs, gs)
            count = max(2, min(20, -(-SPAN // (2 * n * h * w * (cin + cout)))))
            ins = [(torch.randn(n, h, w, cin, generator=gen, device="cuda"
                                ).bfloat16(),
                    torch.randn(n, h, w, cout, generator=gen, device="cuda"
                                ).bfloat16()) for _ in range(count)]
            bound = bench.conv_bound(n, h, w, cin, cout, "wgrad")[0]
            times, line = {name: [] for name in runs}, []
            for order in (list(runs), list(runs)[::-1]):
                for name in order:
                    src, factor = runs[name]
                    conv_train._wgrad_library = lambda lib=libs[src]: lib
                    conv_train.wgrad_splits = (
                        _first_splits if src == "narrow_first" else
                        lambda *a, f=factor: min(real_splits(*a) * f,
                                                 a[0], 65535))
                    err = ((conv_train.conv3x3_wgrad(xs, gs) - ref).abs().max()
                           / ref.abs().max()).item()
                    ok &= name in NARROW_DIAGNOSTIC or err <= NARROW_TOL
                    turn = iter(range(10 ** 9))
                    times[name].append(perf_probe.time_op(
                        lambda: conv_train.conv3x3_wgrad(
                            *ins[next(turn) % len(ins)]),
                        20, torch.device("cuda"),
                        0.0 if name in NARROW_DIAGNOSTIC else bound)[1])
                    if len(times[name]) == 1:
                        line.append(f"{name} err {err:.3g}")
            for name, t in times.items():
                sums[name] += min(t) * blocks
            print(f"b{n} {h}x{w} {cin}->{cout} x{blocks} (bound {bound:.4f} "
                  f"ms): " + "; ".join(line + [
                      f"{name} {t[0]:.4f}/{t[1]:.4f} ms"
                      for name, t in times.items()]), flush=True)
            del ins, xs, gs
            torch.cuda.empty_cache()
    finally:
        conv_train._wgrad_library = real_lib
        conv_train.wgrad_splits = real_splits
    for name, total in sums.items():
        print(f"{name}: UNet 9/16's 7 narrow dW {total:.4f} ms (the lesser "
              f"of the two rounds)", flush=True)
    return ok


def main(argv=None) -> int:
    names = list(argv if argv is not None else sys.argv[1:]) or [
        *VARIANTS, *SPLIT_RUNS, *NARROW_VARIANTS, *NARROW_SPLIT_RUNS]
    if not torch.cuda.is_available():
        print("dw_variants: no CUDA device", file=sys.stderr)
        return 1
    split_runs = {**SPLIT_RUNS, **NARROW_SPLIT_RUNS}
    sources = sorted({split_runs.get(n, (n, 1))[0] for n in names})
    OUT.mkdir(parents=True, exist_ok=True)
    for header in ("sm90_common.cuh", "wgrad_mma_sync.cuh"):
        shutil.copy(cuda_build.CSRC / header, OUT)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(_build, sources))
    libs = {}
    for name, lib, log in built:
        print(f"build {name}: {'ok' if lib else 'FAILED'}; "
              + " | ".join(log), flush=True)
        if lib:
            libs[name] = lib
    if not libs:
        return 1
    print(bench.card(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok = _packed([n for n in names if not n.startswith("narrow_")], libs,
                 gen, sms)
    ok &= _narrow([n for n in names if n.startswith("narrow_")], libs, gen)
    return 0 if ok and len(libs) == len(sources) else 1


if __name__ == "__main__":
    sys.exit(main())
