"""Time design variants of K4's narrow path (``csrc/conv3x3_bn_relu.cu``
namespace ``narrow``) side by side on one card, at UNet 9/16's narrow
blocks: the seven forwards at b8 and the six dx at b24 (``bench.
narrow_cases``). Each variant is a textual edit of the source, built with
nvcc into ``_build/narrow_variants/`` and called through the wrapper with
its library in place of the built one; each call is held against the plain
version (2e-2 of max|plain|) at 2x45x61, then timed as device-busy ms
(``perf_probe.time_op``) on inputs spanning 200 MB, so that each call reads
x from HBM; the variants in turn, then in reverse order.

    python -m pytorch_camvid_tpu_torch.narrow_variants [variant ...]

Variants (``VARIANTS``): ``kept`` (the source as it is); ``one_m64`` (one
m64 a warpgroup at every N, where the kept plan takes two up to N 40:
tiles of 8 rows, not 16); ``no_interleave`` (each lane's A rows
pixels g8 and g8 + 8 at every Cin, where the kept source takes 2 g8 and 2
g8 + 1 where that meets fewer banks). Needs a CUDA card and nvcc; exits 1
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

from pytorch_camvid_tpu_torch import bench, perf_probe
from pytorch_camvid_tpu_torch.ops import cuda_build, fused_conv

OUT = cuda_build.BUILD_DIR / "narrow_variants"
TOL = 2e-2
WIDTH = 0.5625   # UNet at 9/16
SPAN = 200_000_000   # bytes of x a timed rotation spans: 4x the L2
VARIANTS = {
    "kept": [],
    "one_m64": [("constexpr int MAX_N_MT2 = 40;",
                 "constexpr int MAX_N_MT2 = 0;")],
    "no_interleave": [("              interleaved(Cin)};",
                       "              false};")],
}


def _edited(edits) -> str:
    """The source with each (old, new) edit applied, its plan's
    ``static_assert``s dropped where the edits move the plan; raises if an
    edit does not apply."""
    src = fused_conv.SOURCE.read_text()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"variant edit does not apply: {old!r}")
        src = src.replace(old, new)
    if edits:
        src = re.sub(r"static_assert\(plan\(.*\n", "", src)
    return src


def _build(name: str):
    """(name, the bound library or None, nvcc's errors)."""
    src = OUT / f"k4_{name}.cu"
    src.write_text(_edited(VARIANTS[name]))
    lib = src.with_suffix(".so")
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                        str(lib), str(src)], capture_output=True, text=True)
    if r.returncode:
        return name, None, [ln for ln in r.stderr.splitlines()
                            if "error" in ln][:5]
    return name, fused_conv.bind(ctypes.CDLL(str(lib))), []


def _inputs(gen, n, h, w, cin, cout, flip, count=1):
    out = []
    for _ in range(count):
        x = torch.randn(n, h, w, cin, generator=gen, device="cuda").to(
            torch.bfloat16)
        shape = (3, 3, cout, cin) if flip else (3, 3, cin, cout)
        wt = (torch.randn(*shape, generator=gen, device="cuda")
              * (2.0 / (9 * cin)) ** 0.5).to(torch.bfloat16)
        out.append((x, wt))
    return out


def main(argv=None) -> int:
    names = list(argv if argv is not None else sys.argv[1:]) or list(
        VARIANTS)
    if not torch.cuda.is_available():
        print("narrow_variants: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(cuda_build.CSRC / "sm90_common.cuh", OUT)
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build, names))
    libs = {}
    for name, lib, log in built:
        print(f"build {name}: {'ok' if lib else 'FAILED ' + str(log)}",
              flush=True)
        if lib:
            libs[name] = lib
    if not libs:
        return 1
    print(bench.card(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    real = fused_conv._library
    ok, sums = True, {name: {"fwd": 0.0, "dx": 0.0} for name in libs}
    try:
        for n, h, w, cin, cout, flip, blocks in bench.narrow_cases(
                WIDTH, 8, 24):
            a = torch.rand(cout, generator=gen, device="cuda") + 0.5
            b = torch.randn(cout, generator=gen, device="cuda") * 0.1
            (xs, ws), = _inputs(gen, 2, 45, 61, cin, cout, flip)
            ref = fused_conv.conv3x3_bn_relu_plain(xs, ws, a, b, True,
                                                   flip).float()
            ins = _inputs(gen, n, h, w, cin, cout, flip,
                          max(2, min(20, -(-SPAN // (2 * n * h * w * cin)))))
            bound = bench.conv_bound(n, h, w, cin, cout)[0]
            times, line = {name: [] for name in libs}, []
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    fused_conv._library = lambda lib=libs[name]: lib
                    got = fused_conv.conv3x3_bn_relu(xs, ws, a, b, True,
                                                     flip).float()
                    err = ((got - ref).abs().max()
                           / ref.abs().max()).item()
                    ok &= err <= TOL
                    turn = iter(range(10 ** 9))
                    times[name].append(perf_probe.time_op(
                        lambda: fused_conv.conv3x3_bn_relu(
                            *ins[next(turn) % len(ins)], a, b, True, flip),
                        20, torch.device("cuda"), bound)[1])
                    if len(times[name]) == 1:
                        line.append(f"{name} err {err:.3g}")
            for name, t in times.items():
                sums[name]["dx" if flip else "fwd"] += min(t) * blocks
            print(f"b{n} {h}x{w} {cin}->{cout}{' flip' if flip else ''} "
                  f"x{blocks} (bound {bound:.4f} ms): " + "; ".join(
                      line + [f"{name} {t[0]:.4f}/{t[1]:.4f} ms"
                              for name, t in times.items()]), flush=True)
            del ins, xs, ws
            torch.cuda.empty_cache()
    finally:
        fused_conv._library = real
    for name, s in sums.items():
        print(f"{name}: UNet 9/16's 7 forwards {s['fwd']:.4f} ms, 6 dx "
              f"{s['dx']:.4f} ms (the lesser of the two rounds)", flush=True)
    return 0 if ok and len(libs) == len(names) else 1


if __name__ == "__main__":
    sys.exit(main())
