"""Time design variants of K5 (``csrc/conv3x3_pair_bn_relu.cu``) side by
side on one card: each variant is a textual edit of the source, built with
nvcc into ``_build/k5_variants/`` and called through its C entry point,
against the plain version (error) and timed by CUDA events in two rounds,
in turn and in reverse order, beside K4 and cuDNN's conv alone.

    python -m pytorch_camvid_tpu_torch.k5_variants [variant ...]

Variants (``VARIANTS``): ``kept`` (the source as it is); ``rows2`` and
``rows3`` (two or three patch rows' wgmmas per commit group); ``th2`` (tiles
of 2 output rows) and ``th2_spw3`` (with three patch stages per consumer);
``one_consumer_rows{1,2,3}`` (one consumer warpgroup and one producer warp,
160 threads: 255 registers a thread). Needs a CUDA card and nvcc; exits 1
without a card.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

from pytorch_camvid_tpu_torch import bench
from pytorch_camvid_tpu_torch.ops import cuda_build, fused_conv, fused_conv_pair

OUT = cuda_build.BUILD_DIR / "k5_variants"
SHAPES = ((2, 22, 30, 80, 48), (2, 46, 61, 16, 16), (24, 360, 480, 64, 64),
          (24, 360, 480, 128, 64))
# the plan's figures hold for the kept tiles only
_NO_ASSERT = [("static_assert(smem_bytes<32>(64) == 193608", "static_assert(true"),
              ("static_assert(smem_bytes<16>(128) == 218184", "static_assert(true")]
_ONE_CONSUMER = _NO_ASSERT + [
    ("constexpr int THREADS = 320;", "constexpr int THREADS = 160;"),
    ("constexpr int CONSUMER_WARPS = 8;", "constexpr int CONSUMER_WARPS = 4;"),
    ("constexpr int SPW = 2;", "constexpr int SPW = 4;"),
    ("if (wgi == 2) {", "if (wgi == 1) {"),
    ("threadIdx.x == 256 ? 0 : threadIdx.x == 288 ? 1 : -1",
     "threadIdx.x == 128 ? 0 : -1"),
    ("t += 2 * gridDim.x", "t += gridDim.x"),
    ("2 * SPW * Plan<KC>::PATCH", "SPW * Plan<KC>::PATCH"),
    ("patch + 2 * SPW * P::PATCH", "patch + SPW * P::PATCH")]
VARIANTS = {
    "kept": [],
    "rows2": [("int RG = 1;", "int RG = 2;")],
    "rows3": [("int RG = 1;", "int RG = 3;")],
    "th2": _NO_ASSERT + [("int TH = 4;", "int TH = 2;")],
    "th2_spw3": _NO_ASSERT + [("int TH = 4;", "int TH = 2;"),
                              ("int SPW = 2;", "int SPW = 3;")],
    "one_consumer_rows1": _ONE_CONSUMER,
    "one_consumer_rows2": _ONE_CONSUMER + [("int RG = 1;", "int RG = 2;")],
    "one_consumer_rows3": _ONE_CONSUMER + [("int RG = 1;", "int RG = 3;")],
}


def _edited(edits) -> str:
    src = fused_conv_pair.SOURCE.read_text()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"variant edit does not apply: {old!r}")
        src = src.replace(old, new)
    return src


def _build(name: str):
    """(name, C entry point or None, ptxas's register and spill lines)."""
    src = OUT / f"k5_{name}.cu"
    src.write_text(_edited(VARIANTS[name]))
    lib = src.with_suffix(".so")
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                        str(lib), str(src)], capture_output=True, text=True)
    log = [ln.strip()[:160] for ln in (r.stdout + r.stderr).splitlines()
           if "registers" in ln or "spill" in ln or "Performance" in ln
           or "error" in ln or "fatal" in ln]
    if r.returncode:
        return name, None, log
    fn = ctypes.CDLL(str(lib)).conv3x3_pair_bn_relu_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
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
    names = list(argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    if not torch.cuda.is_available():
        print("k5_variants: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(cuda_build.CSRC / "sm90_common.cuh", OUT)
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build, names))
    fns = {}
    for name, fn, log in built:
        print(f"build {name}: {'ok' if fn else 'FAILED'}; "
              + " | ".join(log), flush=True)
        if fn:
            fns[name] = fn
    print(bench.card(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for n, h, w, cin, cout in SHAPES:
        x = torch.randn(n, h, w, cin, generator=gen, device="cuda"
                        ).bfloat16()
        wt = (torch.randn(3, 3, cin, cout, generator=gen, device="cuda")
              * (2 / (9 * cin)) ** 0.5).bfloat16()
        a = torch.rand(cout, generator=gen, device="cuda") + 0.5
        b = torch.randn(cout, generator=gen, device="cuda") * 0.1
        ref = fused_conv_pair.conv3x3_pair_bn_relu_plain(x, wt, a, b).float()
        out = torch.empty(n, h, w, cout, dtype=torch.bfloat16, device="cuda")
        calls = {name: (lambda fn=fn: fn(
            x.data_ptr(), wt.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, h, w, cin, cout, 1,
            torch.cuda.current_stream().cuda_stream))
            for name, fn in fns.items()}
        line = []
        for name, call in calls.items():
            rc = call()
            torch.cuda.synchronize()
            err = ((out.float() - ref).abs().max() / ref.abs().max()).item()
            ok &= rc == 0 and err <= 2e-2
            line.append(f"{name} rc {rc} err {err:.3g}")
        if n == 24:
            times = {name: [_ms(call)] for name, call in calls.items()}
            for name, call in reversed(list(calls.items())):
                times[name].append(_ms(call))
            line += [f"{name} {t[0]:.4f}/{t[1]:.4f} ms"
                     for name, t in times.items()]
            xc, wc = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
            line.append(f"K4 {_ms(lambda: fused_conv.conv3x3_bn_relu(x, wt, a, b)):.4f}")
            line.append(f"cuDNN conv alone {_ms(lambda: F.conv2d(xc, wc, padding=1)):.4f}")
        print(f"{n}x{h}x{w} {cin}->{cout}: " + "; ".join(line), flush=True)
    return 0 if ok and len(fns) == len(names) else 1


if __name__ == "__main__":
    sys.exit(main())
