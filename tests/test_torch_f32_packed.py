"""The f32 packed route ("f32_packed", csrc/conv3x3_f32.cu namespace pk) on
the CPU: its rule at the models' blocks and at the edges, held to the
.cu's ``conv3x3_f32_route``; its shared-memory plans held to the .cu's
``static_assert``s; and numpy models of its two row maps (the forward's
raw patch stages, table of (kernel row, offset) entries and zero-padded K;
the dW's planes of (tap, channel) rows built from raw chunks, read at
each kernel row's patch-row offset, against the wide tile's K order)
feeding the same GEMM in float64, against the plain versions at 45x61
with Cin 3 and 21."""

import importlib.util
import re

import numpy as np
import pytest
import torch

from pytorch_camvid_tpu_torch import bench
from pytorch_camvid_tpu_torch.models import segnet as segnet_model
from pytorch_camvid_tpu_torch.models import unet as unet_model
from pytorch_camvid_tpu_torch.ops import conv_train, cuda_build, fused_conv

SRC = (cuda_build.CSRC / "conv3x3_f32.cu").read_text()
F32 = torch.float32


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_f32_packed", cuda_build._PKG.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- routes

def _cu_route(cin: int, cout: int, wgrad: bool) -> int:
    """``conv3x3_f32_route`` of the .cu, transcribed (the test below holds
    the source to this text): 2 packed where a side's channels are no
    multiple of 4 and 9 x them fit 192 (the forward: Cin; the dW: that
    side with the other's a multiple of 4 or packable too), else 1 wgmma;
    no third route."""
    k_max = 192
    xn, gn = cin % 4 != 0, cout % 4 != 0
    xp, gp = xn and 9 * cin <= k_max, gn and 9 * cout <= k_max
    if not wgrad:
        return 2 if xp else 1
    return 2 if (xp and not gn) or (gp and not xn) or (xp and gp) else 1


def _cu_narrow_side(cin: int, cout: int) -> int:
    """``conv3x3_wgrad_f32_packed_side`` of the .cu, transcribed: -1 off
    the packed dW, else 1 where g is read as it lies (with both sides
    narrow, the side with fewer channels; x on a tie), 0 where x is."""
    if _cu_route(cin, cout, True) != 2:
        return -1
    if cin % 4 and cout % 4:
        return int(cout < cin)
    return int(cout % 4 != 0)


def test_wrappers_route_as_the_source_rule():
    """The .cu's route and narrow-side functions are the rules transcribed
    in ``_cu_route`` and ``_cu_narrow_side``, and ``fused_conv.f32_route``
    / ``conv_train.wgrad_f32_route`` / ``conv_train.packed_narrow_side``
    (and the library-route names, ``F32_ROUTES`` by code) give their
    answers at every (Cin, Cout) up to 200."""
    body = SRC[SRC.index('extern "C" int conv3x3_f32_route'):]
    body = " ".join(body[:body.index("\n}\n")].split())
    assert ("const bool xn = Cin % 4 != 0, gn = Cout % 4 != 0; const bool xp"
            " = xn && 9 * Cin <= K_MAX, gp = gn && 9 * Cout <= K_MAX; if "
            "(!wgrad) return xp ? 2 : 1; return (xp && !gn) || (gp && !xn) "
            "|| (xp && gp) ? 2 : 1;") in body
    side = SRC[SRC.index('extern "C" int conv3x3_wgrad_f32_packed_side'):]
    side = " ".join(side[:side.index("\n}\n")].split())
    assert ("if (conv3x3_f32_route(Cin, Cout, 1) != 2) return -1; if (Cin % 4"
            " != 0 && Cout % 4 != 0) return Cout < Cin ? 1 : 0; return Cout "
            "% 4 != 0 ? 1 : 0;") in side
    assert re.search(r"constexpr int K_MAX = 192;",
                     SRC[SRC.index("namespace pk {"):])
    names = fused_conv.F32_ROUTES
    sides = {-1: None, 0: "x", 1: "g"}
    for cin in range(1, 201):
        for cout in range(1, 201):
            assert fused_conv.f32_route(cin, cout) == names[
                _cu_route(cin, cout, False)]
            route = conv_train.wgrad_f32_route(cin, cout)
            assert route == names[_cu_route(cin, cout, True)]
            assert sides[_cu_narrow_side(cin, cout)] == (
                conv_train.packed_narrow_side(cin, cout)
                if route == "f32_packed" else None)


@pytest.mark.parametrize("cin,route", [(3, "f32_packed"), (12, "f32"),
                                       (20, "f32"), (21, "f32_packed"),
                                       (23, "f32"), (150, "f32")])
def test_forward_route_at_the_edges(cin, route):
    """The forward by Cin: the stem (3) and VOC's dx (21, K 189) packed,
    12 and 20 (Cin % 4 == 0) on wgmma, 23 (K 207 > 192) and the 150-class
    head's dx on wgmma over a padded copy; Cout plays no part."""
    for cout in (3, 21, 64):
        assert fused_conv.f32_route(cin, cout) == route
        assert fused_conv.f32_pads_input(cin, cout) == (cin in (23, 150))


@pytest.mark.parametrize("cin,cout,route,pads",
                         [(3, 64, "f32_packed", (False, False)),
                          (64, 21, "f32_packed", (False, False)),
                          (3, 21, "f32_packed", (False, True)),
                          (23, 64, "f32", (True, False)),
                          (64, 64, "f32", (False, False)),
                          (64, 150, "f32", (False, True)),
                          (64, 23, "f32", (False, True)),
                          (5, 5, "f32_packed", (False, True)),
                          (10, 5, "f32_packed", (True, False)),
                          (6, 150, "f32", (True, True)),
                          (5, 23, "f32", (True, True))])
def test_wgrad_route_at_the_edges(cin, cout, route, pads):
    """The dW: the stem's 3 -> 64 and VOC's 64 -> 21 packed (one side
    narrow, the other's channels % 4 == 0); both sides narrow and packable
    (3 -> 21, UNet 5/64's 5 -> 5 and 10 -> 5) packed, the side with fewer
    channels as it lies and the other padded; a side past 9 x 21 channels
    (23 -> 64, the 150- and 23-class heads, 6 -> 150, 5 -> 23) on wgmma
    with each narrow side padded."""
    assert conv_train.wgrad_f32_route(cin, cout) == route
    assert conv_train.wgrad_f32_pads(cin, cout) == pads


NETS = {"unet": unet_model, "segnet": segnet_model}


@pytest.mark.parametrize("net", ["unet", "segnet"])
@pytest.mark.parametrize("classes", [12, 21, 23, 150])
@pytest.mark.parametrize("width", [1.0, 1 / 8, 3 / 32, 5 / 64])
def test_no_model_path_takes_the_narrow_route(net, classes, width):
    """At every block of UNet and SegNet, at widths 1, 1/8, 3/32 and 5/64
    with CamVid's 12 classes, VOC's 21, 23 and ADE20K's 150, every piece
    takes "f32" or "f32_packed": there is no "f32_narrow" to take. At
    full width the stem's forward and dW and (at 21) the head's dx and dW
    take "f32_packed", the step's launch table is chip_smoke's, and the
    23- and 150-class heads' dx and dW share one padded copy of g."""
    spec = NETS[net].scaled_spec(3, classes, width)
    shapes = bench.block_shapes(net, spec=spec)
    for i, (_, _, cin, cout) in enumerate(shapes):
        routes = {fused_conv.route(F32, cin, cout),
                  conv_train.wgrad_route(F32, cin, cout)}
        if i:
            routes.add(fused_conv.route(F32, cout, cin))
        assert routes <= {"f32", "f32_packed"}
        if width == 1.0:
            packed = i == 0 or (i == len(shapes) - 1 and classes == 21)
            assert ("f32_packed" in routes) == packed
    table = conv_train.step_path_launches(shapes, F32)
    assert "f32_narrow" not in fused_conv.ROUTES
    assert all(set(t) == set(fused_conv.ROUTES) for t in table.values())
    assert {p: sum(t.values()) for p, t in table.items()} == {
        "fwd": len(shapes), "dgrad": len(shapes) - 1, "wgrad": len(shapes)}
    if width == 1.0:
        assert table == _chip_smoke().path_table(net, classes, F32)
        head = classes == 21
        assert {p: t["f32_packed"] for p, t in table.items()} == {
            "fwd": 1, "dgrad": int(head), "wgrad": 1 + int(head)}
        assert conv_train.step_pad_copies(shapes) == int(classes in (23,
                                                                      150))


# ----------------------------------------------------------------- plans

def _asserted(expr: str) -> int:
    return int(re.search(re.escape(expr) + r" == (\d+)", SRC).group(1))


@pytest.mark.parametrize("cin", [3, 21])
def test_forward_plan_matches_the_source(cin):
    """``f32_packed_fwd_plan`` at the stem and VOC's dx: its bytes are the
    .cu's ``static_assert(fwd_smem(cin) == ...)``, K padded to whole step
    sums (32 at the stem, 192 at Cin 21: 3 zero columns), one block an
    SM."""
    plan = fused_conv.f32_packed_fwd_plan(cin)
    assert plan["bytes"] == _asserted(f"fwd_smem({cin})")
    assert plan["kp"] == {3: 32, 21: 192}[cin] and plan["k"] == 9 * cin
    assert plan["bytes"] <= conv_train.BLOCK_SMEM


@pytest.mark.parametrize("cin,cout", [(3, 64), (64, 21)])
def test_wgrad_plan_matches_the_source(cin, cout):
    """``wgrad_f32_packed_plan`` at the stem and VOC's head: its N tile
    and bytes are the .cu's ``static_assert(w_tile_n(cn) == n &&
    wgrad_smem(cn) == ...)`` (the stem's 9 rows a kernel row in 16, VOC's
    63 in 64), within a block's shared memory."""
    plan = conv_train.wgrad_f32_packed_plan(cin, cout)
    cn = plan["narrow"]
    assert cn == {(3, 64): 3, (64, 21): 21}[(cin, cout)]
    m = re.search(rf"w_tile_n\({cn}\) == (\d+) && wgrad_smem\({cn}\) == "
                  r"(\d+)", SRC)
    assert (plan["n"], plan["bytes"]) == (int(m.group(1)), int(m.group(2)))
    assert plan["bytes"] <= conv_train.BLOCK_SMEM


def test_plans_fit_every_narrow_width():
    """Every Cin the forward rule takes (Cin % 4 != 0, 9 x Cin <= 192) and
    every narrow side of the dW rule fits a block's 232,448 bytes, beside a
    wide side of 64 channels or, both sides narrow, of any other narrow
    width (the side with fewer channels the narrow one)."""
    narrow = [c for c in range(1, 22) if c % 4]
    for c in narrow:
        assert fused_conv.f32_packed_fwd_plan(c)["bytes"] <= \
            conv_train.BLOCK_SMEM
        for cin, cout in [(c, 64), (64, c)] + [(c, o) for o in narrow]:
            plan = conv_train.wgrad_f32_packed_plan(cin, cout)
            assert plan["bytes"] <= conv_train.BLOCK_SMEM
            assert plan["narrow"] == min(cin, cout)
            assert 3 * plan["narrow"] <= plan["n"]
    with pytest.raises(ValueError):
        fused_conv.f32_packed_fwd_plan(23)
    with pytest.raises(ValueError):
        conv_train.wgrad_f32_packed_plan(23, 64)


# ------------------------------------------------------ row-map models

def _raw_row(flat: np.ndarray, start: int, chunks: int, row_ok: bool,
             skipped: float):
    """One patch row as the kernels' 16-byte copies leave it: chunk q holds
    flat[(start & ~3) + 4 q ...] (zeros past the tensor's end within it);
    a chunk before or past the tensor, or any of a row outside the image,
    holds ``skipped``: zeros where the forward's copies fill them, NaN
    where the dW's skip them (a read of one shows)."""
    out = np.full(4 * chunks, skipped)
    base = start & ~3
    for q in range(chunks):
        g0 = base + 4 * q
        if not row_ok or g0 < 0 or g0 >= flat.size:
            continue
        n4 = min(4, flat.size - g0)
        out[4 * q:4 * q + 4] = 0.0
        out[4 * q:4 * q + n4] = flat[g0:g0 + n4]
    return out, start & 3


def model_packed_forward(x: np.ndarray, w: np.ndarray, flip: bool):
    """The packed forward's map: per 8 x 16 tile, the 10 patch rows as raw
    stages (the copies, then the columns outside the image zeroed), the
    table's (kernel row, dx Cin + c) entry of each slot of K (a slot past
    9 Cin reads zeros), each output pixel's A gathered at its patch-row
    misalignment, times the K-major weights zero-padded to whole step sums
    (flip: w (3,3,Cout,Cin) tap-reversed and transposed). float64."""
    n, h, wd, cin = x.shape
    cout = w.shape[2] if flip else w.shape[3]
    k = 9 * cin
    kp = 32 * -(-k // 32)
    wk = (w[::-1, ::-1].reshape(9, cout, cin).transpose(1, 0, 2) if flip
          else w.reshape(9, cin, cout).transpose(2, 0, 1)).reshape(cout, k)
    b = np.zeros((kp, cout))
    b[:k] = wk.T
    dy = np.full(kp, 3)
    off = np.zeros(kp, dtype=np.int64)
    taps, chans = np.divmod(np.arange(k), cin)
    dy[:k], off[:k] = taps // 3, (taps % 3) * cin + chans
    chunks = (18 * cin + 2) // 4 + 1
    flat = x.reshape(-1)
    out = np.full((n, h, wd, cout), np.nan)
    cols = np.arange(16)
    for img in range(n):
        for h0 in range(0, h, 8):
            for w0 in range(0, wd, 16):
                rows = []
                for pr in range(10):
                    hh = h0 + pr - 1
                    row, s = _raw_row(
                        flat, ((img * h + hh) * wd + w0 - 1) * cin, chunks,
                        0 <= hh < h, 0.0)
                    for e in range(18 * cin):   # the fix-up pass
                        if not 0 <= w0 + e // cin - 1 < wd:
                            row[s + e] = 0.0
                    rows.append((row, s))
                for r in range(8):
                    if h0 + r >= h:
                        continue
                    a = np.zeros((16, kp))
                    for d in range(3):
                        row, s = rows[r + d]
                        sel = dy == d
                        a[:, sel] = row[s + cols[:, None] * cin
                                        + off[sel][None, :]]
                    y = a @ b
                    keep = w0 + cols < wd
                    out[img, h0 + r, (w0 + cols)[keep]] = y[keep]
    return out


def model_packed_wgrad(x: np.ndarray, g: np.ndarray):
    """The packed dW's map: per 4 x 16 pixel tile, the narrow side's 6
    patch rows as raw chunks, each (patch row, channel) line's 18 values
    (zero outside the image) written as plane rows n = dx Cn + c of the
    three tap columns, in 16-byte rows of the pixels 8 cb + kh + dx + 2k;
    consumer warpgroup dy reads its rows at patch row (tile row + dy) as
    B, the wide tile (unshifted, K in the pixel order 0, 2, 4, 6, 1, 3, 5,
    7) as A; D's (wide channel, (dx, c)) go to dW[t][c][wide] (the stem,
    x narrow) or dW[8 - t][wide][c] (the head, g narrow). float64."""
    n, h, wd, cin = x.shape
    cout = g.shape[3]
    head = cout % 4 != 0
    wide, nar = (x, g) if head else (g, x)
    cw, cn = wide.shape[3], nar.shape[3]
    bn = 16 if 3 * cn <= 16 else 24 if 3 * cn <= 24 else 64
    chunks = (18 * cn + 2) // 4 + 1
    flat = nar.reshape(-1)
    d = np.zeros((3, cw, bn))
    korder = [0, 2, 4, 6, 1, 3, 5, 7]
    for img in range(n):
        for h0 in range(0, h, 4):
            for w0 in range(0, wd, 16):
                plane = np.zeros((6, 2, 2, bn, 4))
                for pr in range(6):
                    hh = h0 + pr - 1
                    row, s = _raw_row(
                        flat, ((img * h + hh) * wd + w0 - 1) * cn, chunks,
                        0 <= hh < h, np.nan)
                    for c in range(cn):
                        v = np.zeros(18)
                        for q in range(18):
                            if 0 <= hh < h and 0 <= w0 + q - 1 < wd:
                                v[q] = row[s + q * cn + c]
                        for dx in range(3):
                            for cb in range(2):
                                for kh in range(2):
                                    q0 = 8 * cb + kh + dx
                                    plane[pr, cb, kh, dx * cn + c] = \
                                        v[q0:q0 + 8:2]
                tile = np.zeros((4, 16, cw))
                hs, ws = min(4, h - h0), min(16, wd - w0)
                tile[:hs, :ws] = wide[img, h0:h0 + hs, w0:w0 + ws]
                for dy in range(3):
                    for j in range(8):
                        i, cb = j >> 1, j & 1
                        a = tile[i, [8 * cb + p for p in korder]].T
                        bm = plane[i + dy, cb].transpose(1, 0, 2).reshape(
                            bn, 8)
                        d[dy] += a @ bm.T
    dw = np.zeros((9, cin, cout))
    for dy in range(3):
        for nn in range(3 * cn):
            dx, c = divmod(nn, cn)
            t = 3 * dy + dx
            if head:
                dw[8 - t, :, c] = d[dy][:, nn]
            else:
                dw[t, c, :] = d[dy][:, nn]
    return dw.reshape(3, 3, cin, cout)


def _inputs(shape, seed):
    return np.random.default_rng(seed).normal(size=shape)


@pytest.mark.parametrize("n,cin,cout,flip", [(2, 3, 64, False),
                                             (1, 21, 64, True)])
def test_forward_row_map_is_the_plain_forward(n, cin, cout, flip):
    """The packed forward's map at 45x61 (ragged 8 x 16 tiles, the image's
    edges) equals the plain forward: the stem (Cin 3, K 27 of 32) and
    VOC's dx (Cin 21 into 64 with flip, K 189 of 192), in float64 within
    1e-12 of max|plain|; nothing reads an element no copy wrote."""
    x = _inputs((n, 45, 61, cin), 1)
    w = _inputs((3, 3, cout, cin) if flip else (3, 3, cin, cout), 2)
    got = model_packed_forward(x, w, flip)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    want = (conv_train.conv3x3_dgrad_plain(xt, wt) if flip
            else conv_train.conv3x3_train_plain(xt, wt)).numpy()
    assert not np.isnan(got).any()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("cin,cout", [(3, 64), (64, 21)])
def test_wgrad_row_map_is_the_plain_wgrad(cin, cout):
    """The packed dW's map at 45x61 (ragged 4 x 16 tiles) equals
    ``conv3x3_wgrad_plain``: the stem's 3 -> 64 (x narrow: 27 rows, 9 a
    kernel row in an N tile of 16) and VOC's 64 -> 21 (g narrow, summed at
    g's shift: 189 rows, 63 in 64), float64, within 1e-12 of max|plain|;
    nothing reads an element no copy wrote."""
    x = _inputs((2, 45, 61, cin), 3)
    g = _inputs((2, 45, 61, cout), 4)
    got = model_packed_wgrad(x, g)
    want = conv_train.conv3x3_wgrad_plain(torch.from_numpy(x),
                                          torch.from_numpy(g))
    want = want.double().numpy()
    assert not np.isnan(got).any()
    # the plain version runs in f32 (upcast inputs): its own rounding
    ref = torch.nn.grad.conv2d_weight(
        torch.from_numpy(x).permute(0, 3, 1, 2), (cout, cin, 3, 3),
        torch.from_numpy(g).permute(0, 3, 1, 2), padding=1).permute(
            2, 3, 1, 0).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_forward_table_pads_k_to_whole_step_sums():
    """At Cin 21 the table's 192 slots hold the 189 (tap, channel) columns
    once each, tap-major, and 3 zero slots at the end; at the stem 27 and
    5."""
    for cin, zero in ((21, 3), (3, 5)):
        kp = fused_conv.f32_packed_fwd_plan(cin)["kp"]
        assert kp - 9 * cin == zero
        assert fused_conv.f32_packed_fwd_plan(cin)["groups"] * 32 == kp
