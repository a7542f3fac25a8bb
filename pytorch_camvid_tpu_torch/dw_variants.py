"""Time variants of the packed dW path (``csrc/conv3x3_wgrad.cu``, namespace
``pk``) side by side on one card, to see what holds it: each variant is a
textual edit of the source, built with nvcc into ``_build/dw_variants/``
and called through its C entry point at the stem's and the head's shapes
(360x480, UNet's batch 24), timed by CUDA events in two rounds, in turn and
in reverse order, beside cuDNN's bf16 wgrad.

    python -m pytorch_camvid_tpu_torch.dw_variants [variant ...]

Variants (``VARIANTS``): ``kept`` (the source as it is, checked against
the plain version at the dW limit, 1e-2 of max|plain|, as are all but the
diagnostic ones); two that leave work out and so compute something else
(``DIAGNOSTIC``, not checked): ``no_mma`` (the consumers wait for each
stage and release it, with no wgmma: the loads alone) and
``no_narrow_loads`` (the producers copy none of the narrow patch from
device memory and transpose what the buffers hold: TMA, the transposition
and the wgmmas alone); ``scalar_loads`` (the producers' first design: one
2-byte load a pixel and channel into registers, where the kept one copies
the patch rows as 16-byte cp.async into shared memory and reads them from
there); ``narrow_path`` (the stem and the head on the narrow path, which
took them before the packed one, at its own split-K); and
``kept_2x_splits`` (the source as it is at twice the split-K, two waves).
Needs a CUDA card and nvcc; exits 1 without a card.
"""

from __future__ import annotations

import ctypes
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
        ("          narrow::cp_async16(rb + i * 16, xs + g0, 2 * n8);", "")],
    "scalar_loads": [(_FIRST, _SCALAR_PRODUCERS)],
    "narrow_path": [("    return 2;\n  return 0;\n}",
                     "    return 0;\n  return 0;\n}")],
}
DIAGNOSTIC = ("no_mma", "no_narrow_loads")
# variants that run a built source at another split-K: (source, factor)
SPLIT_RUNS = {"kept_2x_splits": ("kept", 2)}


def _edited(edits) -> str:
    """The source with each edit applied: (old, new) replaces the text
    old; ((first, last), new) replaces the text from first up to last."""
    src = conv_train.WGRAD_SOURCE.read_text()
    for old, new in edits:
        if isinstance(old, tuple):
            i, j = src.find(old[0]), src.find(old[1])
            if i < 0 or j < i:
                raise ValueError(f"variant edit does not apply: {old!r}")
            old = src[i:j]
        if old not in src:
            raise ValueError(f"variant edit does not apply: {old!r}")
        src = src.replace(old, new)
    return src


def _build(name: str):
    """(name, C entry point or None, ptxas's lines for the packed kernels)."""
    src = OUT / f"dw_{name}.cu"
    src.write_text(_edited(VARIANTS[name]))
    lib = src.with_suffix(".so")
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                        str(lib), str(src)], capture_output=True, text=True)
    lines = (r.stdout + r.stderr).splitlines()
    log = [ln.strip()[:160] for i, ln in enumerate(lines)
           if "error" in ln or "fatal" in ln
           or (("registers" in ln or "spill" in ln)
               and any("packed" in p for p in lines[max(0, i - 2):i]))]
    if r.returncode:
        return name, None, log
    lib = ctypes.CDLL(str(lib))
    fn = lib.conv3x3_wgrad_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for f in (lib.conv3x3_wgrad_path, lib.conv3x3_wgrad_out_tiles):
        f.argtypes = [ctypes.c_int] * 2
    lib.conv3x3_wgrad_out_tiles.restype = ctypes.c_longlong
    fn.lib = lib
    return name, fn, log


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


def main(argv=None) -> int:
    names = list(argv if argv is not None else sys.argv[1:]) or [
        *VARIANTS, *SPLIT_RUNS]
    if not torch.cuda.is_available():
        print("dw_variants: no CUDA device", file=sys.stderr)
        return 1
    sources = sorted({SPLIT_RUNS.get(n, (n, 1))[0] for n in names})
    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(cuda_build.CSRC / "sm90_common.cuh", OUT)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(_build, sources))
    fns = {}
    for name, fn, log in built:
        print(f"build {name}: {'ok' if fn else 'FAILED'}; "
              + " | ".join(log), flush=True)
        if fn:
            fns[name] = fn
    if not fns:
        return 1
    print(bench.card(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok = True
    for n, h, w, cin, cout in SHAPES:
        x = torch.randn(n, h, w, cin, generator=gen, device="cuda"
                        ).bfloat16()
        g = torch.randn(n, h, w, cout, generator=gen, device="cuda"
                        ).bfloat16()
        ref = conv_train.conv3x3_wgrad_plain(x, g)
        tiles = n * -(-h // 8) * -(-w // 16)
        # each variant at the split-K the wrapper picks for its path
        splits, fn_of = {}, {}
        for name in names:
            src, factor = SPLIT_RUNS.get(name, (name, 1))
            if src not in fns:
                continue
            fn_of[name] = fn = fns[src]
            path = conv_train.WGRAD_PATHS[fn.lib.conv3x3_wgrad_path(cin,
                                                                    cout)]
            base = conv_train.wgrad_splits(
                tiles, fn.lib.conv3x3_wgrad_out_tiles(cin, cout), sms, path)
            splits[name] = min(base * factor, tiles, 65535)
        out = torch.empty(3, 3, cin, cout, device="cuda")
        ws = torch.empty(max(splits.values()), 3, 3, cin, cout,
                         device="cuda")
        calls = {name: (lambda fn=fn, s=splits[name]: fn(
                     x.data_ptr(), g.data_ptr(), out.data_ptr(),
                     ws.data_ptr(), n, h, w, cin, cout, s,
                     torch.cuda.current_stream().cuda_stream))
                 for name, fn in fn_of.items()}
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
    return 0 if ok and len(fns) == len(sources) else 1


if __name__ == "__main__":
    sys.exit(main())
