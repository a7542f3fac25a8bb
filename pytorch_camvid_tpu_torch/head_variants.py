"""Time variants of the heads' paths in ``csrc/conv3x3_bn_relu.cu`` side by
side on one card: the wgmma head tile (the 64->12 and 64->21 forwards) and
the packed path (the stem's forward, the heads' dx at Cin 12 and 21, and
the Cin 13-20 widths between them). Each variant is a textual edit of the
source, built with nvcc into ``_build/head_variants/`` and called through
its C entry point at 360x480, timed by CUDA events in two rounds, in turn
and in reverse order, beside cuDNN's bf16 call (``F.conv2d``; for a dx,
``convolution_backward`` with the real input).

    python -m pytorch_camvid_tpu_torch.head_variants [variant ...]

Variants (``VARIANTS``), each checked against the plain version at K1's
limit (2e-2 of max|plain|): ``kept`` (the source as it is);
``offsets_in_registers`` (the packed path's A offsets in registers at
every Cin, where the kept source puts them in a shared table past Cin
12); ``alignment_test`` (the head tile's stores test each channel pair's
alignment at run time, where the kept one builds the store loop for
Cout's parity at compile time); ``narrow_head`` (64->17..23 and Cin
17..21 on the narrow paths, as before the head tile took N = 24 and the
packed path K = 192). Needs a CUDA card and nvcc; exits 1 without a card.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

from pytorch_camvid_tpu_torch import bench
from pytorch_camvid_tpu_torch.dw_variants import _ms
from pytorch_camvid_tpu_torch.ops import conv_train, cuda_build, fused_conv

OUT = cuda_build.BUILD_DIR / "head_variants"
HW = (360, 480)
# (label, batch, Cin, Cout, flip): a flip call is the dx of the conv
# Cout -> Cin, its cotangent with Cin channels
CASES = (("stem fwd", 24, 3, 64, False),
         ("12-class head fwd", 24, 64, 12, False),
         ("12-class head dx", 24, 12, 64, True),
         ("VOC head fwd", 10, 64, 21, False),
         ("VOC head fwd", 24, 64, 21, False),
         ("VOC head dx", 10, 21, 64, True), ("VOC head dx", 24, 21, 64, True),
         ("Cin 13 dx", 24, 13, 64, True), ("Cin 15 dx", 24, 15, 64, True),
         ("Cin 17 dx", 24, 17, 64, True), ("Cin 19 dx", 24, 19, 64, True),
         ("Cin 20 dx", 24, 20, 64, True))
TOL = 2e-2
VARIANTS = {
    "kept": [],
    "offsets_in_registers": [
        ("  static constexpr bool TABLE = CIN > 12;",
         "  static constexpr bool TABLE = false;"),
        ("static_assert(Geo<21>::SMEM == 114176,",
         "static_assert(Geo<21>::SMEM == 113792,")],
    "alignment_test": [
        ("(EVEN || (reinterpret_cast<uintptr_t>(o) & 3) == 0)",
         "((reinterpret_cast<uintptr_t>(o) & 3) == 0)")],
    "narrow_head": [
        ("    if (Cout <= wg::HEAD_MAX_COUT && Cin <= wg::RES_MAX_CIN) "
         "return 1;",
         "    if (Cout <= 16 && Cin <= wg::RES_MAX_CIN) return 1;"),
        ("  return 9 * Cin <= packed::K_MAX && Cout % 8 == 0 ? 2 : 0;",
         "  return 9 * Cin <= 144 && Cout % 8 == 0 ? 2 : 0;")],
}


def _edited(edits) -> str:
    """The source with each (old, new) edit applied; raises if one does
    not apply."""
    src = fused_conv.SOURCE.read_text()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"variant edit does not apply: {old!r}")
        src = src.replace(old, new)
    return src


def _build(name: str):
    """(name, C entry point or None, nvcc's errors and ptxas's spills:
    each kernel instance that spills, by its template arguments, with its
    bytes)."""
    src = OUT / f"k4_{name}.cu"
    src.write_text(_edited(VARIANTS[name]))
    lib = src.with_suffix(".so")
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                        str(lib), str(src)], capture_output=True, text=True)
    log, entry = [], ""
    for ln in (r.stdout + r.stderr).splitlines():
        m = re.search(
            r"entry function '\S*?\d+(conv3x3_\w+?_kernel)I(\w+?)EEv", ln)
        if m:   # e.g. conv3x3_bn_relu_packed_kernel<21>
            entry = m.group(1) + "<" + ", ".join(
                re.findall(r"L[ib](\d+)E", m.group(2) + "E")) + ">"
        m = re.search(r"(\d+) bytes spill stores", ln)
        if "error" in ln or (m and int(m.group(1))):
            log.append(f"{entry} {m.group(1)} B" if m else ln.strip()[:160])
    if r.returncode:
        return name, None, log
    fn = fused_conv.bind(ctypes.CDLL(str(lib))).conv3x3_bn_relu_bf16
    return name, fn, log


def main(argv=None) -> int:
    names = list(argv if argv is not None else sys.argv[1:]) or list(
        VARIANTS)
    if not torch.cuda.is_available():
        print("head_variants: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(cuda_build.CSRC / "sm90_common.cuh", OUT)
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build, names))
    fns = {}
    for name, fn, log in built:
        print(f"build {name}: {'ok' if fn else 'FAILED'}; spills: "
              + (" | ".join(log) or "none"), flush=True)
        if fn:
            fns[name] = fn
    if not fns:
        return 1
    print(bench.card(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    h, w = HW
    ok = True
    for label, n, cin, cout, flip in CASES:
        x = torch.randn(n, h, w, cin, generator=gen, device="cuda"
                        ).bfloat16()
        wt = torch.randn(*((3, 3, cout, cin) if flip else (3, 3, cin, cout)),
                         generator=gen, device="cuda").bfloat16()
        a = torch.ones(cout, device="cuda")
        b = torch.zeros(cout, device="cuda")
        out = torch.empty(n, h, w, cout, dtype=torch.bfloat16, device="cuda")
        ref = fused_conv.conv3x3_bn_relu_plain(x, wt, a, b, relu=False,
                                               flip=flip).float()
        calls = {name: (lambda fn=fn: fn(
                     x.data_ptr(), wt.data_ptr(), a.data_ptr(), b.data_ptr(),
                     out.data_ptr(), n, h, w, cin, cout, 0, int(flip),
                     torch.cuda.current_stream().cuda_stream,
                     ctypes.byref(ctypes.c_int())))
                 for name, fn in fns.items()}
        line = []
        for name, call in calls.items():
            rc = call()
            torch.cuda.synchronize()
            err = ((out.float() - ref).abs().max() / ref.abs().max()).item()
            ok &= rc == 0 and err <= TOL
            line.append(f"{name} rc {rc} err {err:.3g}")
        times = {name: [_ms(call)] for name, call in calls.items()}
        for name, call in reversed(list(calls.items())):
            times[name].append(_ms(call))
        line += [f"{name} {t[0]:.4f}/{t[1]:.4f} ms"
                 for name, t in times.items()]
        if flip:   # the dx as autograd runs it, on the conv's real input
            xin = torch.randn(n, h, w, cout, generator=gen, device="cuda"
                              ).bfloat16()
            lib = lambda: conv_train.conv3x3_dgrad_library(x, wt, xin)
        else:
            xc, wc = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
            lib = lambda: F.conv2d(xc, wc, padding=1)
        line.append(f"cuDNN bf16 {_ms(lib):.4f} ms")
        print(f"{label} b{n} {cin}->{cout}: " + "; ".join(line), flush=True)
        del x, wt, out, ref
        torch.cuda.empty_cache()
    return 0 if ok and len(fns) == len(names) else 1


if __name__ == "__main__":
    sys.exit(main())
