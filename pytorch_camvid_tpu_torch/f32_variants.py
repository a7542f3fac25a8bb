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

Variants (``VARIANTS``): ``kept`` (the source as it is; it must pass the
rule); ``running_accumulator`` (the first design: the three split
products of each k8 step go straight into the running accumulator, so the
tensor core's truncated sums are taken at the accumulator's magnitude
instead of one step's); and the faults chip_faults.py plants
(``FAULTS``): ``single_pass`` (single-pass TF32, the hi*hi product only),
``lo_hi_dropped`` (without the lo*hi product) and ``atomic_splits`` (the
dW's splits added with atomics into a zeroed dW in launch order instead
of the ordered second pass). All but ``kept`` are diagnostic, not held to
the rule. Needs a CUDA card and nvcc; exits 1 without a card, or when a
build fails or ``kept`` breaks the rule.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from pytorch_camvid_tpu_torch import bench
from pytorch_camvid_tpu_torch.ops import conv_train, cuda_build, fused_conv

OUT = cuda_build.BUILD_DIR / "f32_variants"
# (N, H, W, Cin, Cout): the stem, UNet's widest block, a 512-channel block
# at 22x30 and a ragged 45x61 tile, at b2 for the errors
SHAPES = ((2, 360, 480, 3, 64), (2, 360, 480, 64, 64),
          (2, 22, 30, 512, 512), (2, 45, 61, 64, 64))
TIMED = ((10, 360, 480, 64, 64), (10, 45, 60, 512, 512))
# chip_smoke's phase 14 rule: err(t) = max|t - f64|; a kernel passes where
# err(kernel) <= max(ERR_FACTOR * err(plain f32), ERR_FLOOR * max|f64|)
ERR_FACTOR, ERR_FLOOR = 4.0, 2e-6
_SUM = """  mma_tf32_z(s, al, bh0, bh1);
  mma_tf32(s, ah, bl0, bl1);
  mma_tf32(s, ah, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += s[i];
"""
_RUNNING_SUM = """  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
"""
_SINGLE_SUM = """  mma_tf32_z(s, ah, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += s[i];
"""
_NO_LO_HI_SUM = """  mma_tf32_z(s, ah, bl0, bl1);
  mma_tf32(s, ah, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += s[i];
"""
_ATOMIC = [
    ("  float* d = dst + static_cast<int64_t>(blockIdx.z) * M * Cout;",
     "  float* d = dst;"),
    ("          d[static_cast<int64_t>(r) * Cout + c] = "
     "acc[mt][nt][2 * half + e];",
     "          atomicAdd(&d[static_cast<int64_t>(r) * Cout + c],\n"
     "                    acc[mt][nt][2 * half + e]);"),
    ("  float* dst = splits > 1 ? static_cast<float*>(ws) : of;",
     "  float* dst = of;\n"
     "  cudaMemsetAsync(of, 0, elems * sizeof(float), st);"),
    ("  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);",
     "  return static_cast<int>(e);   // no ordered second pass")]
VARIANTS = {"kept": [], "running_accumulator": [(_SUM, _RUNNING_SUM)],
            "single_pass": [(_SUM, _SINGLE_SUM)],
            "lo_hi_dropped": [(_SUM, _NO_LO_HI_SUM)],
            "atomic_splits": _ATOMIC}
FAULTS = ("single_pass", "lo_hi_dropped", "atomic_splits")


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
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                        str(lib), str(src)], capture_output=True, text=True)
    log = [ln.strip()[:120] for ln in (r.stdout + r.stderr).splitlines()
           if "error" in ln or "registers" in ln or "spill" in ln
           or "Compiling entry" in ln]
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
    """The variant's forward, dx and dW on (x, w, g): each returns its
    output after one launch (or raises on a CUDA error)."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = conv_train.wgrad_f32_splits(n, h, wd, cin, cout, sms)
    ones = {c: (torch.ones(c, device="cuda"), torch.zeros(c, device="cuda"))
            for c in (cin, cout)}
    ws = torch.empty(splits, 3, 3, cin, cout, device="cuda")

    def conv(t, cout_, flip):
        out = torch.empty(t.shape[:3] + (cout_,), device="cuda")
        a, b = ones[cout_]
        err = lib.conv3x3_bn_relu_f32(
            t.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, h, wd, t.shape[3], cout_, 0, int(flip),
            stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return out

    def wgrad():
        out = torch.empty(3, 3, cin, cout, device="cuda")
        err = lib.conv3x3_wgrad_f32(
            x.data_ptr(), g.data_ptr(), out.data_ptr(), ws.data_ptr(), n, h,
            wd, cin, cout, splits, stream)
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


def main(argv=None) -> int:
    names = list(argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    if not torch.cuda.is_available():
        print("f32_variants: no CUDA device", file=sys.stderr)
        return 1
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
                    f"{k} {t[0]:.3f}/{t[1]:.3f} ms"
                    for k, t in times.items()))
        print(f"{n}x{h}x{w} {cin}->{cout}: " + "; ".join(line), flush=True)
        del x, wt, g, calls
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
