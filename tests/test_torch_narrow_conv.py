"""K4's narrow path (``csrc/conv3x3_bn_relu.cu`` namespace ``narrow``): its
rule at the odd widths and heads that reach it, its shared-memory plan
against the source's, a numpy model of its data movement against the plain
version, and the plain version against the JAX package's Pallas kernel
(interpret mode) at the narrow path's shapes.

The kernel runs only on the card (chip_smoke.py holds it to the plain
version there). The model here repeats its index arithmetic: x's rows
copied as the 16-byte chunks that hold them to a row stride of W x Cin mod
8, the columns outside the image zeroed, A gathered at the table's offsets
of packed k, the weights in their K-major layout (tap-reversed and
transposed under flip), N split in channel tiles, each output run staged
at out's alignment and written chunk by chunk; what it never writes or
reads stays NaN, so a wrong offset shows."""

import ctypes
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pytorch_camvid_tpu.ops import pallas_conv as jax_pc
from pytorch_camvid_tpu_torch import bench
from pytorch_camvid_tpu_torch.models import segnet as segnet_model
from pytorch_camvid_tpu_torch.models import unet as unet_model
from pytorch_camvid_tpu_torch.ops import fused_conv

SRC = fused_conv.SOURCE.read_text()


def _inputs(n, h, w, cin, cout, flip=False, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    shape = (3, 3, cout, cin) if flip else (3, 3, cin, cout)
    wt = (rng.normal(size=shape) / np.sqrt(9 * cin)).astype(np.float32)
    a = rng.uniform(0.5, 1.5, size=cout).astype(np.float32)
    b = rng.normal(scale=0.1, size=cout).astype(np.float32)
    return x, wt, a, b


def _odd_width_pairs(net, width):
    spec = (unet_model.scaled_spec(3, 12, width) if net == "unet"
            else segnet_model.scaled_spec(3, 12, width))
    shapes = bench.block_shapes(net, (360, 480), spec)
    fwd = {(ci, co) for _, _, ci, co in shapes}
    dx = {(co, ci) for _, _, ci, co in shapes[1:]}
    return fwd, dx


# UNet at 9/16 (36, 72, 144, 288, 576 channels): its 36-channel blocks and
# their dx take the narrow path, the rest wgmma; SegNet at 5/8 (40, 80,
# 160, 320): none narrow, its stem and the head's dx on the packed path
@pytest.mark.parametrize("net,width,narrow_fwd,narrow_dx", [
    ("unet", 0.5625, {(3, 36), (36, 36), (36, 72), (72, 36), (36, 12)},
     {(36, 36), (72, 36), (36, 72), (12, 36)}),
    ("segnet", 0.625, set(), set())])
def test_conv_path_at_the_odd_widths(net, width, narrow_fwd, narrow_dx):
    fwd, dx = _odd_width_pairs(net, width)
    path = fused_conv.conv_path
    assert {pr for pr in fwd if path(*pr) == "narrow"} == narrow_fwd
    assert {pr for pr in dx if path(*pr) == "narrow"} == narrow_dx
    assert all(path(*pr) in ("wgmma", "packed") for pr in (fwd | dx)
               if pr not in narrow_fwd | narrow_dx)
    for cin, cout in narrow_fwd | narrow_dx:
        assert fused_conv.narrow_fwd_plan(cin, cout) is not None


# the head 64 -> classes and its dx: 12 and 21 on the head tile (their dx
# packed), 24 on the head tile (its dx wgmma), 28 and 150 narrow both ways
@pytest.mark.parametrize("classes,fwd,dx", [
    (12, "wgmma", "packed"), (21, "wgmma", "packed"), (24, "wgmma", "wgmma"),
    (28, "narrow", "narrow"), (150, "narrow", "narrow")])
def test_conv_path_of_the_heads(classes, fwd, dx):
    assert fused_conv.conv_path(64, classes) == fwd
    assert fused_conv.conv_path(classes, 64) == dx
    if "narrow" in (fwd, dx):
        plan = fused_conv.narrow_fwd_plan(64, classes)
        assert plan["bn"] * plan["tiles_n"] >= classes
        # 150 classes: two channel tiles of 80; its dx two of 32
        if classes == 150:
            assert (plan["bn"], plan["tiles_n"]) == (80, 2)
            dxp = fused_conv.narrow_fwd_plan(150, 64)
            assert (dxp["bn"], dxp["tiles_n"]) == (32, 2)


def test_narrow_plan_is_the_sources():
    """``narrow_fwd_plan``'s bytes are the figures the source asserts at
    compile time (``static_assert(plan(Cin, Cout).smem == bytes``), its
    constants the source's, and every (N tile, MT) it picks has an
    instance in the source's switch."""
    held = {(int(a), int(b)): int(c) for a, b, c in re.findall(
        r"static_assert\(plan\((\d+), (\d+)\)\.smem == (\d+)", SRC)}
    assert {(3, 36), (36, 36), (72, 36), (36, 72), (36, 12), (12, 36),
            (64, 150), (150, 64)} == set(held)
    for (cin, cout), nbytes in held.items():
        assert fused_conv.narrow_fwd_plan(cin, cout)["bytes"] == nbytes
    ns = SRC[SRC.index("namespace narrow {"):]
    for name, value in (("MAX_N", fused_conv.NARROW_MAX_N),
                        ("MAX_N_MT2", fused_conv.NARROW_MAX_N_MT2),
                        ("MAX_STAGES", fused_conv.NARROW_MAX_STAGES),
                        ("SMEM_MAX", fused_conv.SMEM_MAX),
                        ("SMEM_SM", fused_conv.SMEM_SM)):
        assert re.search(rf"constexpr int {name} = (\d+);", ns).group(
            1) == str(value), name
    bns = re.search(r"constexpr int BNS\[\] = \{([\d, ]+)\};", ns).group(1)
    assert tuple(int(v) for v in bns.split(",")) == fused_conv.NARROW_BNS
    cases = {(int(a), int(b)) for a, b in
             re.findall(r"NARROW_CASE\((\d+), (\d+)\)", ns)}
    picked = {(p["bn"], p["mt"]) for cin in range(1, 335)
              for cout in (1, 3, 12, 21, 28, 36, 64, 72, 100, 150, 200, 333)
              if (p := fused_conv.narrow_fwd_plan(cin, cout))}
    assert picked <= cases and len(cases) == 13


@pytest.mark.parametrize("cout", [3, 12, 36, 72, 150, 400])
def test_narrow_plan_fits_a_block_up_to_cin_320(cout):
    """Every Cin up to 320 has a plan: its bytes fit a block (and, at
    ``blocks_per_sm``, the SM), its N tiles hold Cout, K = 9 x Cin padded
    to whole pairs of 2-step groups (< 64 over); past Cin ~330 none does,
    and the first, mma.sync design takes the call."""
    for cin in range(1, 321):
        p = fused_conv.narrow_fwd_plan(cin, cout)
        assert p is not None, cin
        assert p["bytes"] <= fused_conv.SMEM_MAX
        assert p["blocks_per_sm"] * (p["bytes"] + 1024) <= fused_conv.SMEM_SM
        assert 1 <= p["stages"] <= fused_conv.NARROW_MAX_STAGES
        assert p["bn"] in fused_conv.NARROW_BNS
        assert p["bn"] * p["tiles_n"] >= cout > p["bn"] * (p["tiles_n"] - 1)
        assert p["mt"] == 1 or p["bn"] <= fused_conv.NARROW_MAX_N_MT2
        assert p["kp"] % 64 == 0 and 0 <= p["kp"] - 9 * cin < 64
    assert fused_conv.narrow_fwd_plan(401, cout) is None


def _bank_conflicts(cin, il):
    worst = 0
    for half in range(2):
        words = [((2 * (lane >> 2) + half if il else (lane >> 2) + 8 * half)
                  * cin + 2 * (lane & 3)) >> 1 for lane in range(32)]
        for bank in range(32):
            worst = max(worst, len({w for w in words if w % 32 == bank}))
    return worst


def narrow_model(x, w, a, b, relu=True, flip=False):
    """The narrow kernel's data movement in numpy (float64 arithmetic):
    ``out`` as the kernel would write it, NaN where it writes nothing."""
    n, H, W, cin = x.shape
    cout = a.shape[0]
    p = fused_conv.narrow_fwd_plan(cin, cout)
    bn, mt, tiles_n, kp = p["bn"], p["mt"], p["tiles_n"], p["kp"]
    TH, TW, PH, PW = 8 * mt, 16, 8 * mt + 2, 18
    L, K = PW * cin, 9 * cin
    RS = L + 14 + (W * cin - L - 14) % 8
    assert L + 14 <= RS <= L + 21 and (RS - W * cin) % 8 == 0
    xf = x.reshape(-1).astype(np.float64)
    wf = w.reshape(-1).astype(np.float64)
    out = np.full(n * H * W * cout, np.nan)
    # W'[k][co], packed k = tap x Cin + ci, zero past K (the kernel's
    # K-major tile, decoded)
    kk = np.arange(kp)[:, None]
    co = np.arange(cout)[None, :]
    tap, ci = kk // cin, kk % cin
    idx = (((8 - tap) * cout + co) * cin + ci) if flip else kk * cout + co
    wk = np.where(kk < K, wf[np.minimum(idx, wf.size - 1)], 0.0)
    # the table: byte offsets / 2 of packed k from the lane's pixel
    off = np.where(np.arange(kp) < K,
                   (np.arange(kp) // cin // 3) * RS
                   + (np.arange(kp) // cin % 3) * cin
                   + np.arange(kp) % cin, -1)
    cpr = (L + 14) // 8
    for img in range(n):
        for h0 in range(0, H, TH):
            for w0 in range(0, W, TW):
                g0 = ((img * H + h0 - 1) * W + w0 - 1) * cin
                B = g0 % 8
                stage = np.full(PH * (L + 21) + 16, np.nan)
                for r in range(PH):
                    gr = g0 + r * W * cin
                    sr = gr % 8
                    h = h0 + r - 1
                    for q in range(cpr):
                        a0 = gr - sr + 8 * q
                        if a0 >= gr + L:
                            continue
                        dst = B + r * RS - sr + 8 * q
                        assert dst % 8 == 0 and dst >= 0
                        if 0 <= h < H and 0 <= a0 < xf.size:
                            # past x: whatever x's storage holds there
                            # (``whole_chunks``), never gathered
                            chunk = np.full(8, np.nan)
                            part = xf[a0:a0 + 8]
                            chunk[:part.size] = part
                            stage[dst:dst + 8] = chunk
                        else:
                            stage[dst:dst + 8] = 0.0
                if w0 == 0 or w0 + TW + 1 > W:
                    lo = cin if w0 == 0 else 0
                    hi = min(W - w0 + 1, PW) * cin
                    for r in range(PH):
                        if 0 <= h0 + r - 1 < H:
                            base = B + r * RS
                            stage[base:base + lo] = 0.0
                            stage[base + hi:base + L] = 0.0
                rows = np.arange(TH)[:, None]
                cols = np.arange(TW)[None, :]
                pix = (B + rows * RS + cols * cin).reshape(-1)
                A = np.where(off[None, :] >= 0,
                             stage[pix[:, None] + np.maximum(off, 0)[None]],
                             0.0)
                assert not np.isnan(A[:, :K]).any()
                for n0 in range(0, tiles_n * bn, bn):
                    bnc = min(bn, cout - n0)
                    y = A @ wk[:, n0:n0 + bnc] * a[n0:n0 + bnc] \
                        + b[n0:n0 + bnc]
                    if relu:
                        y = np.maximum(y, 0.0)
                    y = y.reshape(TH, TW, bnc)
                    ops = p["ops"]
                    for rr in range(TH):
                        hh = h0 + rr
                        if hh >= H:
                            continue
                        npx = min(TW, W - w0)
                        go = ((img * H + hh) * W + w0) * cout + n0
                        sb0 = go % 8
                        os_ = np.full(16 * ops + 8, np.nan)
                        for px in range(TW):
                            e = sb0 + px * ops
                            os_[e:e + bnc] = y[rr, px]
                        runs = ([(sb0, go, npx * cout)] if tiles_n == 1 else
                                [(sb0 + px * ops, go + px * cout, bnc)
                                 for px in range(npx)])
                        for s0, gs, ln in runs:
                            c0 = gs - gs % 8
                            for ca in range(c0, gs + ln, 8):
                                sq = s0 + ca - gs
                                for u in range(8):
                                    if gs <= ca + u < gs + ln:
                                        out[ca + u] = os_[sq + u]
    return out.reshape(n, H, W, cout)


# ragged tiles at both image edges, odd and even Cin (16-bit and paired
# gathers), N 16 / 24 / 40 / 80 at MT 2 and 1, a 150-class head's two
# channel tiles and its dx's, flip, a row run of 16 x 36 channels ending
# off a 16-byte boundary
@pytest.mark.parametrize("shape", [
    (1, 9, 21, 36, 36, False), (2, 11, 17, 3, 36, False),
    (1, 9, 19, 36, 12, False), (1, 10, 20, 12, 36, True),
    (1, 9, 17, 64, 150, False), (1, 9, 17, 150, 64, True),
    (1, 7, 9, 5, 3, False), (1, 18, 33, 72, 36, False),
    (1, 9, 17, 36, 72, True), (1, 5, 35, 64, 28, False)],
    ids=lambda s: "x".join(map(str, s)))
def test_narrow_model_matches_the_plain_version(shape):
    *dims, flip = shape
    x, w, a, b = _inputs(*dims, flip=flip, seed=3)
    want = fused_conv.conv3x3_bn_relu_plain(
        torch.from_numpy(x).double(), torch.from_numpy(w).double(),
        torch.from_numpy(a).double(), torch.from_numpy(b).double(), True,
        flip).numpy()
    got = narrow_model(x, w, a.astype(np.float64), b.astype(np.float64),
                       True, flip)
    assert not np.isnan(got).any()
    # the plain version's epilogue runs in f32: its rounding
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pixel_order_spreads_the_gather_over_the_banks():
    """The source's choice of A rows per lane (``conflicts``): at Cin 36
    (UNet 9/16) pixels 2 g8 and 2 g8 + 1 take one wavefront a load where
    g8 and g8 + 8 take two; at 72 g8 already takes one."""
    assert "interleaved(Cin)};" in SRC
    assert "t[c] = conflicts(c, true) < conflicts(c, false);" in SRC
    assert (_bank_conflicts(36, False), _bank_conflicts(36, True)) == (2, 1)
    assert (_bank_conflicts(72, False), _bank_conflicts(72, True)) == (1, 2)
    assert (_bank_conflicts(12, False), _bank_conflicts(12, True)) == (2, 1)


# UNet 9/16's narrow forwards and dx, the 150-class head's, at small maps:
# the port's wrapper (its plain version on the CPU) against JAX's Pallas K4
# in interpret mode (under flip on the reversed weights JAX's VJP builds)
@pytest.mark.parametrize("shape", [
    (1, 8, 12, 3, 36, False), (1, 8, 12, 36, 36, False),
    (1, 6, 10, 72, 36, False), (1, 8, 12, 36, 12, False),
    (1, 6, 9, 64, 150, False), (1, 8, 12, 12, 36, True),
    (1, 6, 10, 36, 72, True), (1, 6, 9, 150, 64, True)],
    ids=lambda s: "x".join(map(str, s)))
def test_narrow_shapes_match_pallas_interpret(shape):
    n, h, w, cin, cout, flip = shape
    assert fused_conv.conv_path(cin, cout) == "narrow"
    x, wt, a, b = _inputs(n, h, w, cin, cout, flip=flip, seed=4)
    w_jax = (np.ascontiguousarray(np.transpose(wt[::-1, ::-1], (0, 1, 3, 2)))
             if flip else wt)
    want = np.asarray(jax_pc.conv3x3_bn_relu_pallas(
        jnp.asarray(x), jnp.asarray(w_jax), jnp.asarray(a), jnp.asarray(b),
        interpret=True, relu=not flip))
    got = fused_conv.conv3x3_bn_relu(
        torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(a),
        torch.from_numpy(b), relu=not flip, flip=flip)
    assert got.shape == want.shape == (n, h, w, cout)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_narrow_path_needs_an_aligned_x():
    """The narrow path copies x's 16-byte chunks: ``_check`` refuses an x
    off a 16-byte boundary (``launch`` realigns a view with ``aligned16``
    first); the weights are read element by element, anywhere."""
    x, w, a, b = (torch.from_numpy(t) for t in _inputs(1, 6, 8, 36, 36))
    xb, wb = x.bfloat16(), w.bfloat16()
    assert fused_conv.conv_path(36, 36) == "narrow"
    fused_conv._check(xb, wb, a, b)
    odd = torch.empty(xb.numel() + 1, dtype=torch.bfloat16)[1:].view(
        xb.shape)
    with pytest.raises(ValueError, match="narrow path"):
        fused_conv._check(odd, wb, a, b)
    oddw = torch.empty(wb.numel() + 1, dtype=torch.bfloat16)[1:].view(
        wb.shape)
    fused_conv._check(xb, oddw, a, b)
    assert fused_conv.aligned16(odd).data_ptr() % 16 == 0


@pytest.mark.parametrize("cin,cout", [(36, 12), (350, 12)])
def test_mma_sync_kernel_and_plan_entries_need_the_card(cin, cout):
    """The wrapper's launch refuses a CPU tensor, at a shape with a tile
    and at one with none (the first design's, ``mma_sync``); the CPU
    route runs the plain version and counts nothing."""
    assert fused_conv.conv_path(cin, cout) == "narrow"
    assert (fused_conv.narrow_fwd_plan(cin, cout) is None) == (cin == 350)
    x, w, a, b = (torch.from_numpy(t) for t in _inputs(1, 5, 7, cin, cout))
    with pytest.raises(ValueError, match="no kernel|aligned|cuda"):
        fused_conv.launch(x.bfloat16(), w.bfloat16(), a, b, True, False)
    fused_conv.reset_launches()
    fused_conv.conv3x3_bn_relu(x, w, a, b)
    assert fused_conv.conv3x3_bn_relu.mma_sync_launches == 0
    assert fused_conv.conv3x3_bn_relu.path_launches["narrow"] == 0


def test_the_c_entry_reports_its_kernel():
    """``conv3x3_bn_relu_bf16`` takes a 14th argument, an int the entry
    sets to the kernel it launched (3: mma_sync, which only the narrow
    path's no-tile branch reaches); ``bind`` types it and ``launch``
    counts from it, not from its own copy of the plan. The timing-only
    entry of the first design is gone."""
    class Fn:
        argtypes = restype = None

    class Lib:
        conv3x3_bn_relu_bf16 = Fn()
        conv3x3_bn_relu_path = Fn()
        conv3x3_bn_relu_narrow_plan = Fn()

    lib = fused_conv.bind(Lib())
    args = lib.conv3x3_bn_relu_bf16.argtypes
    assert len(args) == 14 and args[-1] == ctypes.POINTER(ctypes.c_int)
    assert "int* route) {" in SRC and "*route = p.smem == 0 ? 3 : 0;" in SRC
    assert "conv3x3_bn_relu_bf16_mma_sync" not in SRC
    assert not hasattr(fused_conv, "launch_mma_sync")
    launch = SRC[SRC.index("cudaError_t run(", SRC.index(
        "namespace narrow {")):SRC.index("}  // namespace narrow")]
    assert "mma_sync::run(" in launch


def test_the_patch_copy_reads_only_x_storage():
    """x's last 16-byte chunk ends past x when N x H x W x Cin is no
    multiple of 8: ``whole_chunks`` copies such an x into a buffer that
    holds the chunk (``launch`` calls it on the narrow path; ``_check``
    refuses an x without it), and leaves an x whose storage holds it as
    it is. What lies past x is never gathered (``narrow_model`` puts NaN
    there)."""
    x, w, a, b = _inputs(1, 5, 7, 3, 36, seed=5)   # 105 elements
    assert x.size % 8
    got = narrow_model(x, w, a.astype(np.float64), b.astype(np.float64))
    assert not np.isnan(got).any()
    xb = torch.from_numpy(x).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    with pytest.raises(ValueError, match="last 16-byte chunk"):
        fused_conv._check(xb, wb, at, bt)
    held = fused_conv.whole_chunks(xb)
    assert held is not xb and torch.equal(held, xb)
    assert held.untyped_storage().nbytes() == 112 * 2
    fused_conv._check(held, wb, at, bt)
    # a batch of a larger map, or a map of whole chunks: no copy
    big = torch.randn(3, 5, 7, 3).bfloat16()
    assert fused_conv.whole_chunks(big[:2]).data_ptr() == big.data_ptr()
    even = torch.randn(1, 4, 8, 3).bfloat16()
    assert fused_conv.whole_chunks(even) is even


def test_chip_smoke_drives_the_narrow_path():
    """chip_smoke's narrow cases are UNet 9/16's seven narrow forward
    blocks at b8 and six dx at b24, whose byte bounds sum to 0.391 ms (the
    aim's quarter of it, 1.6 ms, is ``NARROW_AIM_MS``); its 9/16 training
    step counts 7 / 6 / 7 launches narrow; its edge shapes put a 150-class
    head, 36->12, 256->12 and 3->36 on the narrow path, with the dx of the
    first two."""
    import chip_smoke as smoke
    cases = smoke.narrow_cases()
    fwd = [c for c in cases if not c[5]]
    dx = [c for c in cases if c[5]]
    assert sum(c[6] for c in fwd) == 7 and sum(c[6] for c in dx) == 6
    assert {c[0] for c in fwd} == {smoke.BATCH}
    assert {c[0] for c in dx} == {smoke.ODD_TRAIN_BATCH}
    bound = sum(smoke.conv_bound(*c[:5])[0] * c[6] for c in fwd)
    assert abs(bound - 0.391) < 1e-3 and smoke.NARROW_AIM_MS == 1.6
    table = smoke.conv_train.step_path_launches(smoke.odd_width_shapes())
    assert (table["fwd"]["narrow"], table["dgrad"]["narrow"],
            table["wgrad"]["narrow"]) == (7, 6, 7)
    edge = {(ci, co) for *_, ci, co in smoke.EDGE_SHAPES}
    assert {(64, 150), (36, 12), (256, 12), (3, 36)} <= edge
    for ci, co in ((64, 150), (36, 12)):
        assert fused_conv.conv_path(co, ci) == "narrow"
    assert all(fused_conv.conv_path(ci, co) == "narrow"
               for ci, co in ((64, 150), (36, 12), (256, 12), (3, 36)))
    # the no-tile branch runs on the card: 350->12 and SegNet 43/64's
    # 344->172 (b8, at its 45x60 stage) on the first design, their dx
    # 12->350 and 172->344 on the new one
    assert [c[3:] for c in smoke.NARROW_NO_TILE] == [(350, 12), (344, 172)]
    for *_, ci, co in smoke.NARROW_NO_TILE:
        assert fused_conv.conv_path(ci, co) == fused_conv.conv_path(co, ci) \
            == "narrow"
        assert fused_conv.narrow_fwd_plan(ci, co) is None
        assert fused_conv.narrow_fwd_plan(co, ci) is not None
    segnet = smoke.bench.block_shapes("segnet", spec=__import__(
        "pytorch_camvid_tpu_torch.models.segnet",
        fromlist=["scaled_spec"]).scaled_spec(3, 12, 43 / 64))
    assert (45, 60, 344, 172) in segnet
    assert smoke.NARROW_NO_TILE[1][:3] == (smoke.BATCH, 45, 60)


@pytest.mark.parametrize("name", sorted(
    __import__("pytorch_camvid_tpu_torch.narrow_variants",
               fromlist=["VARIANTS"]).VARIANTS))
def test_narrow_variant_edits_apply_to_the_source(name):
    """Each design variant narrow_variants.py times is an edit that still
    applies to the kernel's source, inside the narrow namespace, and
    changes it (but "kept")."""
    from pytorch_camvid_tpu_torch import narrow_variants
    src = narrow_variants._edited(narrow_variants.VARIANTS[name])
    assert (src == SRC) == (name == "kept")
    ns = SRC[SRC.index("namespace narrow {"):
             SRC.index("}  // namespace narrow")]
    for old, _ in narrow_variants.VARIANTS[name]:
        assert ns.count(old) == 1


def test_narrow_variants_without_a_card_fails(capsys):
    from pytorch_camvid_tpu_torch import narrow_variants
    assert narrow_variants.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
