"""Time design variants of the int8 block (``csrc/conv3x3_int8.cu``) side
by side on one card: each variant is a textual edit of the source, built
with nvcc into ``_build/int8_variants/`` and called through its C entry
point. Each is checked bit for bit against the plain version in the three
output modes at ``CHECK_SHAPES`` (a mismatch is printed; a probe's is
expected), then all are timed by CUDA events at the 19 quantized block
shapes of UNet and SegNet (b8, 360x480) in the int8 and bf16 output modes,
in two rounds, in turn and in reverse order.

    python -m pytorch_camvid_tpu_torch.int8_variants [--parent SRC] [variant ...]

``--parent SRC`` adds another version of the source (a parent commit's
``conv3x3_int8.cu``, unpacked with ``git archive`` into an ignored
directory, built with its own directory's headers) as "parent", checked
and timed in the same turns: the side-by-side comparison of two commits
on one card. Its packed weights are laid out as its ``packed_k`` says
(9 x Cin4 as here, or PR 21's 9 x Cin).

Variants (``VARIANTS``): ``kept`` (the source as it is); ``no_handoff``
(the ping-pong without its named-barrier handoff: both warpgroups multiply
at once); ``streamed_n256`` (N = 256 past Cout 128, 128 accumulators a
thread); ``streamed_n128_mt2`` (N = 128 with two m64 tiles a warpgroup,
256 pixels a weight load); ``threads320`` (one producer warp pair, 200
registers a thread, no setmaxnreg); ``streamed_g1`` / ``streamed_g4``
(1 or 4 k32 steps a commit group past Cin 128); ``streamed_direct`` (past
Cin 128 the staged rows copied out element by element, no TMA store);
``w8`` (8 weight stages, 4 KB of staging a warp) and ``stagger{2,4,6}``
(with the second warpgroup's first tile held until the first's tap 2, 4
or 6); ``res_wait_once`` (the resident taps' barriers waited on a
warpgroup's first tile only); ``magic_i2f`` (int -> float by a magic
add, exact below 2^22 only); ``stem_tw16`` (the stem on 16-column tiles,
three blocks an SM). Probes, whose outputs are wrong by design:
``probe_no_weights`` (no weight load after a block's first tile),
``probe_no_patch`` (no patch load after it), ``probe_no_epilogue`` (no
output at all). Needs a CUDA card and nvcc; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from pytorch_camvid_tpu_torch import bench
from pytorch_camvid_tpu_torch.ops import cuda_build
from pytorch_camvid_tpu_torch.ops import fused_conv_int8 as fq

OUT = cuda_build.BUILD_DIR / "int8_variants"
HW = (360, 480)
BATCH = 8
MIN_COUT = 64   # quant.quantize_model's default: the heads stay float
CHECK_SHAPES = ((BATCH, 360, 480, 3, 64), (BATCH, 90, 120, 64, 64),
                (BATCH, 90, 120, 256, 256), (BATCH, 22, 30, 512, 512),
                (2, 45, 61, 192, 200))
MODES = (torch.int8, torch.bfloat16, torch.float32)


def _wgmma_s8(n: int) -> str:
    """The source of ``wgmma_s8_n{n}``: wgmma.m64nNk32 s8 with A from
    registers, as the source's own instances."""
    k = n // 2
    outs = ", ".join(f"%{i}" for i in range(k))
    regs = ",\n        ".join(f'"+r"(d[{i}])' for i in range(k))
    return (
        f"__device__ __forceinline__ void wgmma_s8_n{n}(int (&d)[{k}],\n"
        f"    const uint32_t (&a)[4], uint64_t desc_b) {{\n"
        f"  asm volatile(\n"
        f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{k + 5}, 0;\\n"\n'
        f'      "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 "\n'
        f'      "{{{outs}}}, {{%{k}, %{k + 1}, %{k + 2}, %{k + 3}}}, '
        f'%{k + 4}, p;\\n}}\\n"\n'
        f"      : {regs}\n"
        f'      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), '
        f'"l"(desc_b), "r"(1));\n}}\n\n')


_WGMMA_DISPATCH = "template <int N>\n__device__ __forceinline__ void wgmma_s8("
_STREAMED_128 = ("  return launch<128, false, 128>(x, wk, s_w, b_eff, s_x, "
                 "s_out, out, mode, N,\n                                 H, W, "
                 "Cin, Cout, st);")
_MT = "  static constexpr int MT = RES || BN == 64 ? 2 : 1;  // m64 a WG"
_G = "  constexpr int G = RES ? KS : 2;"
_THREADS320 = [
    ("constexpr int THREADS = 384; // warpgroups 0, 1 consume; 2 produces",
     "constexpr int THREADS = 320; // warpgroups 0, 1 consume; 2 produces"),
    ("    sm90::setmaxnreg_dec<40>();\n", ""),
    ("    sm90::setmaxnreg_inc<232>();\n", "")]
_W8 = [("constexpr int OUT_WARP = 8192;", "constexpr int OUT_WARP = 4096;"),
       ("  static constexpr int W_STAGES = RES ? 9 : 4;",
        "  static constexpr int W_STAGES = RES ? 9 : 8;")]


def _stagger(tap: int) -> list:
    return _W8 + [
        ("      } else {\n        for (int c = 0; c < nch; ++c, ++pit) {",
         "      } else {\n        if (wgi == 1 && j == 0) named_sync(1, 256);"
         "\n        for (int c = 0; c < nch; ++c, ++pit) {"),
        ("              if (gi == 0 && tap > 0 && lane == 0)",
         f"              if (wgi == 0 && j == 0 && c == 0 && tap == {tap} "
         f"&& gi == 0)\n                named_arrive(1, 256);\n"
         f"              if (gi == 0 && tap > 0 && lane == 0)")]


VARIANTS = {
    "kept": [],
    "no_handoff": [("        if (j > 0) named_sync(1 + wgi, 256);\n", ""),
                   ("        if (t + gridDim.x < total) named_arrive(2 - wgi, "
                    "256);\n", "")],
    "streamed_n256": [
        (_WGMMA_DISPATCH, _wgmma_s8(256) + _WGMMA_DISPATCH),
        ("  else wgmma_s8_n128(d, a, desc_b);",
         "  else if constexpr (N == 128) wgmma_s8_n128(d, a, desc_b);\n"
         "  else wgmma_s8_n256(d, a, desc_b);"),
        ("  static constexpr int W_STAGES = RES ? 9 : 4;",
         "  static constexpr int W_STAGES = RES ? 9 : BN == 256 ? 3 : 4;"),
        (_STREAMED_128, "  if (Cout > 128)\n    return launch<256, false, 128>"
         "(x, wk, s_w, b_eff, s_x, s_out, out, mode, N, H, W, Cin, Cout, "
         "st);\n" + _STREAMED_128)],
    "streamed_n128_mt2": [(_MT, "  static constexpr int MT = 2;")],
    "threads320": _THREADS320,
    "streamed_g1": [(_G, "  constexpr int G = RES ? KS : 1;")],
    "streamed_g4": [(_G, "  constexpr int G = KS;")],
    "streamed_direct": [
        ("  const bool tma = tma_ok(mode, Cout);\n  if (tma && "
         "!encode_out_map(&omap, out, mode, N, H, W, Cout, TW))\n    return "
         "cudaErrorInvalidValue;\n  auto kern = conv3x3_int8_wgmma_kernel",
         "  const bool tma = RES && tma_ok(mode, Cout);\n  if (tma && "
         "!encode_out_map(&omap, out, mode, N, H, W, Cout, TW))\n    return "
         "cudaErrorInvalidValue;\n  auto kern = conv3x3_int8_wgmma_kernel")],
    "w8": _W8,
    "stagger2": _stagger(2),
    "stagger4": _stagger(4),
    "stagger6": _stagger(6),
    "res_wait_once": [("          sm90::mbar_wait(&wfull[tap], 0);\n",
                       "          if (j < 2) sm90::mbar_wait(&wfull[tap], 0);"
                       "\n")],
    "magic_i2f": [(
        "  const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), "
        "bias);",
        "  const float y = __fadd_rn(__fmul_rn(__fsub_rn(__int_as_float("
        "0x4B400000 + acc), 12582912.f), scale), bias);")],
    "stem_tw16": [
        ("constexpr int TW = 32;         // output columns: MT m16 tiles a "
         "warp", "constexpr int TW = 16;"),
        ("constexpr int BLOCKS = 2;      // resident blocks an SM (registers "
         "<= 128)", "constexpr int BLOCKS = 3;")],
    "probe_no_weights": [(
        "              sm90::mbar_arrive_expect_tx(&wfull[ws], T::W_BYTES);",
        "              if (t != static_cast<int>(blockIdx.x)) {\n"
        "                sm90::mbar_arrive(&wfull[ws]);\n"
        "                continue;\n              }\n"
        "              sm90::mbar_arrive_expect_tx(&wfull[ws], T::W_BYTES);")],
    "probe_no_patch": [(
        "          sm90::mbar_arrive_expect_tx(&pfull[ps], T::PATCH_TX);",
        "          if (t != static_cast<int>(blockIdx.x)) {\n"
        "            sm90::mbar_arrive(&pfull[ps]);\n            continue;\n"
        "          }\n"
        "          sm90::mbar_arrive_expect_tx(&pfull[ps], T::PATCH_TX);")],
    "probe_no_epilogue": [("          if (c0 >= Cout) break;\n",
                           "          if (c0 >= Cout || Cout > 0) break;\n")],
}


def _edited(edits) -> str:
    src = fq.SOURCE.read_text()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"variant edit does not apply: {old!r}")
        src = src.replace(old, new)
    return src


def _build(name: str, parent: Path = None):
    """(name, the library bound as ``fused_conv_int8.bind`` does, or None,
    the count of C7519 and C7512 warnings and the spill lines). ``parent``:
    build that source as it is, with its own directory's headers."""
    src = OUT / f"int8_{name}.cu"
    src.write_text(parent.read_text() if parent else
                   _edited(VARIANTS[name]))
    lib = src.with_suffix(".so")
    inc = ["-I", str(parent.resolve().parent)] if parent else []
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *inc,
                        "-o", str(lib), str(src)], capture_output=True,
                       text=True)
    log = r.stdout + r.stderr
    notes = [f"C7519 {log.count('C7519')}", f"C7512 {log.count('C7512')}"]
    notes += sorted({ln.strip() for ln in log.splitlines()
                     if "spill" in ln and " 0 bytes spill stores" not in ln})
    notes += [ln.strip()[:160] for ln in log.splitlines()
              if "error" in ln or "fatal" in ln]
    if r.returncode:
        return name, None, notes
    return name, fq.bind(ctypes.CDLL(str(lib))), notes


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


def _inputs(gen, n, h, w, cin, cout) -> dict:
    """chip_smoke's int8 block operands: int8 x and w_q uniform in [-127,
    127], scales that keep acc * s_x * s_w of order 1."""
    dev = torch.device("cuda")
    x = torch.randint(-127, 128, (n, h, w, cin), generator=gen, device=dev,
                      dtype=torch.int8)
    wq = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen,
                       device=dev, dtype=torch.int8)
    s_w = (torch.rand(cout, generator=gen, device=dev) + 0.5) \
        / (73.3 * (9 * cin) ** 0.5)
    return {"x": x, "w_q": wq, "s_w": s_w,
            "s_x": torch.tensor(1 / 127, device=dev),
            "b_eff": torch.randn(cout, generator=gen, device=dev) * 0.5,
            "s_out": torch.tensor(4 / 127, device=dev),
            "packed": {}}


def _packed(lib, w_q: torch.Tensor) -> torch.Tensor:
    """``w_q`` in the layout ``lib`` reads: ``pack_weights``'s, or on the
    packed path PR 21's k = tap * Cin + ci where its packed K says so."""
    cin, cout = w_q.shape[2], w_q.shape[3]
    kp = lib.conv3x3_int8_packed_k(cin)
    if fq.int8_path(cin) != "packed" or kp == fq.packed_k(cin):
        return fq.pack_weights(w_q)
    return F.pad(w_q.reshape(9 * cin, cout).t(), (0, kp - 9 * cin)
                 ).contiguous()


def _call(lib, t: dict, mode: torch.dtype) -> torch.Tensor:
    x = t["x"]
    n, h, w, cin = x.shape
    cout = t["w_q"].shape[3]
    out = torch.empty((n, h, w, cout), dtype=mode, device=x.device)
    s_out = t["s_out"] if mode == torch.int8 else None
    packed = t["packed"][id(lib)]
    err = lib.conv3x3_int8(
        x.data_ptr(), packed.data_ptr(), t["s_w"].data_ptr(),
        t["b_eff"].data_ptr(), t["s_x"].data_ptr(),
        s_out.data_ptr() if s_out is not None else None, out.data_ptr(),
        fq.OUT_MODES[mode], n, h, w, cin, cout,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"conv3x3_int8 variant launch failed: {err}")
    return out


def block_shapes() -> list:
    """(H, W, Cin, Cout) of UNet's and SegNet's quantized blocks, each
    once."""
    return list(dict.fromkeys(
        s for net in ("unet", "segnet") for s in bench.block_shapes(net, HW)
        if s[3] >= MIN_COUT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="int8_variants")
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args(argv)
    unknown = [n for n in args.variants if n not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}; they are {list(VARIANTS)}")
    names = args.variants or list(VARIANTS)
    if not torch.cuda.is_available():
        print("int8_variants: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(cuda_build.CSRC / "sm90_common.cuh", OUT)
    jobs = [(n, None) for n in names]
    if args.parent:
        jobs.insert(0, ("parent", args.parent))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: _build(*job), jobs))
    libs = {}
    for name, lib, notes in built:
        print(f"build {name}: {'ok' if lib else 'FAILED'}; "
              + " | ".join(notes), flush=True)
        if lib:
            libs[name] = lib
    print(bench.card(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in CHECK_SHAPES:
        t = _inputs(gen, *shape)
        t["packed"] = {id(lib): _packed(lib, t["w_q"])
                       for lib in libs.values()}
        acc = fq.conv2d_int8(t["x"], t["w_q"])
        want = {m: fq.int8_epilogue(acc, t["s_w"], t["s_x"], t["b_eff"],
                                    t["s_out"] if m == torch.int8 else None,
                                    m) for m in MODES}
        for name, lib in libs.items():
            bad = [str(m)[6:] for m in MODES
                   if not torch.equal(_call(lib, t, m), want[m])]
            torch.cuda.synchronize()
            if bad:
                print(f"check {name} at {shape}: NOT bit-equal in {bad}",
                      flush=True)
        del t, acc, want
    print(f"checked {list(libs)} at {len(CHECK_SHAPES)} shapes", flush=True)
    sums = {name: [0.0, 0.0] for name in libs}
    for h, w, cin, cout in block_shapes():
        t = _inputs(gen, BATCH, h, w, cin, cout)
        t["packed"] = {id(lib): _packed(lib, t["w_q"])
                       for lib in libs.values()}
        times = {}
        for name in list(libs) + list(libs)[::-1]:
            for m in (torch.int8, torch.bfloat16):
                times.setdefault((name, m), []).append(
                    _ms(lambda: _call(libs[name], t, m)))
        row = []
        for name in libs:
            t8 = min(times[(name, torch.int8)])
            tb = min(times[(name, torch.bfloat16)])
            sums[name][0] += t8
            sums[name][1] += tb
            row.append(f"{name} {t8:.4f}/{tb:.4f}")
        print(f"b{BATCH} {h}x{w} {cin}->{cout} ms (int8/bf16 out): "
              + "; ".join(row), flush=True)
        del t
    print("sums over the 19 shapes (int8/bf16 out): " + "; ".join(
        f"{n} {a:.4f}/{b:.4f}" for n, (a, b) in sums.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
