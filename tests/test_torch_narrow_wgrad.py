"""K1's narrow dW (``csrc/conv3x3_wgrad.cu`` namespace ``narrow``): its
plan against the source's constants and ``static_assert``s and against a
block's shared memory, a numpy model of its data movement against the
plain version, the path rule at the odd widths, and the port's CPU dW
against the JAX package's Pallas ``_conv3x3_dw`` (interpret mode) at the
narrow path's shapes.

The kernel runs only on the card (chip_smoke.py holds it to the plain
version there). The model here repeats its index arithmetic: each tile's
rows of the M side (with the halo) and of the N side copied as the 16-byte
chunks that hold them to a row stride congruent to W x channels mod 8,
the values outside the image read as zero, the M side's (tap, channel)
rows packed tap-major into whole m64 tiles from three column-shifted
channel-major planes (pad rows from the zero plane), N rounded to 8 and
split into channel tiles, B in wgmma's K-major layout, the split-K pixel
ranges and their fixed-order sum; what it never writes or reads stays
NaN, so a wrong offset shows."""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pytorch_camvid_tpu.ops import pallas_conv_train as jax_pct

from pytorch_camvid_tpu_torch import bench, dw_variants
from pytorch_camvid_tpu_torch.models import segnet as segnet_model
from pytorch_camvid_tpu_torch.models import unet as unet_model
from pytorch_camvid_tpu_torch.ops import conv_train

SRC = conv_train.WGRAD_SOURCE.read_text()
NS = SRC[SRC.index("namespace narrow {"):SRC.index("}  // namespace narrow")]


def _interpret(fn):
    """Run fn with every pallas_call in interpret mode."""
    import jax.experimental.pallas as pl
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    pl.pallas_call = jax_pct.pl.pallas_call = patched
    try:
        return fn()
    finally:
        pl.pallas_call = jax_pct.pl.pallas_call = orig


def _inputs(n, h, w, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, h, w, cin)).astype(np.float32),
            rng.normal(size=(n, h, w, cout)).astype(np.float32))


# ------------------------------------------------------------------ plan

def test_narrow_wgrad_plan_is_the_sources():
    """``wgrad_narrow_plan``'s bytes are the figures the source asserts at
    compile time (``static_assert(plan(Cin, Cout).smem == bytes``), its
    constants the source's, and its instances the source's switch
    cases."""
    held = {(int(a), int(b)): int(c) for a, b, c in re.findall(
        r"static_assert\(plan\((\d+), (\d+)\)\.smem == (\d+)", NS)}
    assert {(3, 36), (36, 36), (72, 36), (36, 72), (36, 12), (64, 150),
            (64, 28), (350, 12), (72, 100), (340, 340)} == set(held)
    for (cin, cout), nbytes in held.items():
        p = conv_train.wgrad_narrow_plan(cin, cout)
        assert p["bytes"] == nbytes, (cin, cout)
    assert conv_train.wgrad_narrow_plan(72, 100)["tiles_m"] == 2
    assert conv_train.wgrad_narrow_plan(340, 340)["runs"]
    for name, value in (("MAX_CM", conv_train.NARROW_MAX_CM),
                        ("RAW", conv_train.NARROW_RAW),
                        ("MAX_STAGES", conv_train.NARROW_MAX_STAGES),
                        ("ACC_MAX", conv_train.NARROW_ACC_MAX),
                        ("SMEM_MAX", conv_train.BLOCK_SMEM)):
        assert re.search(rf"constexpr int {name} = (\d+);", NS).group(
            1) == str(value), name

    def ints(text):
        return tuple(int(v) for v in re.findall(r"\d+", text))

    assert ints(re.search(r"constexpr int THS\[\] = \{([\d, ]+)\};",
                          NS).group(1)) == conv_train.NARROW_THS
    assert ints(re.search(r"constexpr int MTWS\[\] = \{([\d, ]+)\};",
                          NS).group(1)) == conv_train.NARROW_MTWS
    inst = re.search(r"constexpr Inst INSTANCES\[\] = \{(.*?)\};", NS,
                     re.S).group(1)
    pairs = ints(inst)
    assert tuple(zip(pairs[::2], pairs[1::2])) == conv_train.NARROW_INSTANCES
    cases = tuple((int(a), int(b)) for a, b in
                  re.findall(r"NARROW_CASE\((\d+), (\d+)\)", NS))
    assert cases == conv_train.NARROW_INSTANCES


# every narrow (Cin, Cout) up to Cin 350 and Cout 160, in slices of Cout
@pytest.mark.parametrize("couts", [range(lo, min(lo + 20, 161))
                                   for lo in range(1, 161, 20)],
                         ids=lambda r: f"cout{r.start}-{r.stop - 1}")
def test_narrow_wgrad_plan_fits_a_block(couts):
    """The plan fits a block's 232,448 bytes with two ring stages or three
    at every narrow shape, picks an instance the source has, holds N in
    its channel tiles, M in channel tiles of at most 64 and its
    accumulators in a consumer thread's budget, packs 9 x cmt rows into
    its two warpgroups' m64 tiles with less than two tiles of pad, and
    copies whole rows (no shape this wide needs runs)."""
    for cout in couts:
        for cin in range(1, 351):
            if conv_train.wgrad_path(cin, cout) != "narrow":
                continue
            p = conv_train.wgrad_narrow_plan(cin, cout)
            assert p["side"] == ("x" if cin <= cout else "g")
            assert not p["runs"], (cin, cout)
            assert (p["cm"], p["cn"]) == ((cin, cout) if cin <= cout
                                          else (cout, cin))
            assert p["bytes"] <= conv_train.BLOCK_SMEM
            assert 2 <= p["stages"] <= conv_train.NARROW_MAX_STAGES
            assert p["th"] in conv_train.NARROW_THS
            assert (p["mtw"], p["bn"]) in conv_train.NARROW_INSTANCES
            assert p["mtw"] * p["bn"] // 2 <= conv_train.NARROW_ACC_MAX
            assert p["bn"] * (p["tiles_n"] - 1) < p["cn"] <= (
                p["bn"] * p["tiles_n"])
            assert p["cmt"] <= conv_train.NARROW_MAX_CM
            assert p["tiles_m"] == -(-p["cm"] // conv_train.NARROW_MAX_CM)
            assert p["cmt"] * (p["tiles_m"] - 1) < p["cm"] <= (
                p["cmt"] * p["tiles_m"])
            assert p["mt"] * 64 >= 9 * p["cmt"] > (p["mt"] - 1) * 64
            assert p["mt"] <= 2 * p["mtw"] < p["mt"] + 4
            assert p["stage_bytes"] == p["planes_bytes"] + (
                p["th"] * p["bn"] * 32)
            assert p["planes_bytes"] >= (3 * p["cmt"] + 1) * p["plane"]


# both sides wide: every narrow (Cin, Cout) of a grid up to 700 channels
@pytest.mark.parametrize("cins", [range(lo, lo + 100, 3)
                                  for lo in range(100, 700, 100)],
                         ids=lambda r: f"cin{r.start}-{r.stop - 1}")
def test_narrow_wgrad_plan_copies_runs_only_where_rows_do_not_fit(cins):
    """Past 64 channels a side the plan still fits a block, in M channel
    tiles; it copies pixel runs exactly where a tile's whole rows fit at no
    N tile and pixel row count (their least: two rows, the narrowest N
    tile), and its runs' raw buffers do not grow with the channels."""
    up = lambda v, m: -(-v // m) * m   # noqa: E731
    for cin in cins:
        for cout in range(100, 700, 7):
            if conv_train.wgrad_path(cin, cout) != "narrow":
                continue
            p = conv_train.wgrad_narrow_plan(cin, cout)
            assert p["bytes"] <= conv_train.BLOCK_SMEM, (cin, cout)
            assert p["tiles_m"] * conv_train.NARROW_MAX_CM >= p["cm"]
            bn = min(b for m, b in conv_train.NARROW_INSTANCES
                     if m == p["mtw"])
            plane = 32 * 4 + 16
            stage = up((3 * p["cmt"] + 1) * plane, 128) + 2 * bn * 32
            raw = (up(2 * (4 * (18 * p["cm"] + 21) + 16), 128)
                   + up(2 * (2 * (16 * p["cn"] + 21) + 16), 128))
            whole_fits = (conv_train.BLOCK_SMEM - conv_train.NARROW_RAW * raw
                          - 128) // stage >= 2
            assert p["runs"] == (not whole_fits), (cin, cout)
            if p["runs"]:
                assert p["raw_m"] == up(2 * ((p["th"] + 2) * (
                    18 * p["cmt"] + 378) + 16), 128)


def test_narrow_wgrad_plan_at_the_model_shapes():
    """UNet 9/16's seven narrow dW: tap-major M of the narrower side (3 ->
    64 rows at the stem, 324 -> 384 at 36 channels), N its other side to
    8 (36 -> 40, 72 -> 72) in one channel tile, pixel tiles of 8 rows; a
    150-class head's 64 -> 150 in four tiles of 40 at 4 rows; 350 -> 12
    in three tiles of 128; 72 -> 100 in two M tiles of 36 and two N tiles
    of 72; 340 -> 340 in six M tiles of 57 and nine N tiles of 40, as
    pixel runs."""
    want = {(3, 36): ("x", 1, 1, 40, 1, 8), (36, 36): ("x", 6, 3, 40, 1, 8),
            (72, 36): ("g", 6, 3, 72, 1, 8), (36, 72): ("x", 6, 3, 72, 1, 8),
            (36, 12): ("g", 2, 1, 40, 1, 8),
            (64, 150): ("x", 9, 5, 40, 4, 4),
            (64, 28): ("g", 4, 2, 64, 1, 8),
            (350, 12): ("g", 2, 1, 128, 3, 4),
            (72, 100): ("x", 6, 3, 72, 2, 4),
            (100, 72): ("g", 6, 3, 72, 2, 4),
            (340, 340): ("x", 9, 5, 40, 9, 4)}
    for (cin, cout), fig in want.items():
        p = conv_train.wgrad_narrow_plan(cin, cout)
        assert (p["side"], p["mt"], p["mtw"], p["bn"], p["tiles_n"],
                p["th"]) == fig, (cin, cout)
        assert (p["tiles_m"], p["cmt"], p["runs"]) == {
            (72, 100): (2, 36, False), (100, 72): (2, 36, False),
            (340, 340): (6, 57, True)}.get((cin, cout), (1, p["cm"], False))
    # the useful share of the MMAs issued at 36->36: 76%, where the first
    # design's 32 x 64 tile issued 32%
    p = conv_train.wgrad_narrow_plan(36, 36)
    assert round(36 * 36 * 9 / (p["mt"] * 64 * p["bn"]), 2) == 0.76
    assert conv_train.narrow_plan_key(p) == (0, 3, 40, 1, 1, 8, 0, 3,
                                             210176)


def test_narrow_wgrad_splits_fill_one_wave():
    """One narrow block is resident an SM: the split-K fills one whole wave
    of them over the N x M channel tiles, at most one split a pixel tile,
    one split where the tiles alone pass a wave."""
    assert conv_train.wgrad_splits(24 * 45 * 30, 1, 132, "narrow") == 132
    assert conv_train.wgrad_splits(24 * 45 * 30, 4, 132, "narrow") == 33
    assert conv_train.wgrad_splits(24 * 45 * 30, 3, 132, "narrow") == 44
    assert conv_train.wgrad_splits(24 * 45 * 30, 54, 132, "narrow") == 2
    assert conv_train.wgrad_splits(24 * 45 * 30, 200, 132, "narrow") == 1
    assert conv_train.wgrad_splits(7, 1, 132, "narrow") == 7


# ----------------------------------------------------------------- model

def _stride(of, length):
    """A raw stride of length + 14 to 21 elements congruent to ``of`` mod 8
    (the launcher's ``stride``)."""
    return length + 14 + (of - length - 14) % 8


def narrow_wgrad_model(x, g, splits):
    """The narrow dW kernel's data movement in numpy (float64 arithmetic):
    dW (3,3,Cin,Cout) as the kernel and the fixed-order split sum would
    write it; what no step writes or reads stays NaN."""
    n, H, W, cin = x.shape
    cout = g.shape[3]
    p = conv_train.wgrad_narrow_plan(cin, cout)
    side, cm, cn, th, bn = p["side"], p["cm"], p["cn"], p["th"], p["bn"]
    cmt, runs = p["cmt"], p["runs"]
    rows_m = 2 * p["mtw"] * 64   # both consumer warpgroups' M rows
    ms, ns = (x, g) if side == "x" else (g, x)
    fm, fn = (t.reshape(-1).astype(np.float64) for t in (ms, ns))
    ph = th + 2
    if runs:
        psm, psn = _stride(cm, cmt), _stride(cn, bn)
        rsm = _stride(W * cm, 17 * psm + cmt)
        rsn = _stride(W * cn, 15 * psn + bn)
    else:
        psm, psn = cm, cn
        rsm, rsn = _stride(W * cm, 18 * cm), _stride(W * cn, 16 * cn)
    assert (rsm - W * cm) % 8 == 0 and (rsn - W * cn) % 8 == 0
    assert (psm - cm) % 8 == 0 and (psn - cn) % 8 == 0
    tiles_h, tiles_w = -(-H // th), -(-W // 16)
    total = n * tiles_h * tiles_w
    ws = np.full((splits, 3, 3, cin, cout), np.nan)
    # each raw buffer holds what lands in it (``land``)
    assert 2 * (ph * rsm + 16) <= p["raw_m"]
    assert 2 * (th * rsn + 16) <= p["raw_n"]

    def land(raw, dst, flat, a):
        assert dst % 8 == 0 and 0 <= dst and dst + 8 <= raw.size
        # past the tensor: whatever its storage holds there (whole_chunks),
        # never read below
        chunk = np.full(8, np.nan)
        part = flat[a:a + 8]
        chunk[:part.size] = part
        raw[dst:dst + 8] = chunk

    def copy_rows(flat, corner, pitch, rows, npix, cs, c0, length, rs, ps,
                  h_first, size):
        """A raw buffer as the chunk copies leave it (NaN elsewhere), and
        the offset of its first element: whole rows of all ``cs``
        channels, or with runs each pixel's ``length`` channels from c0."""
        raw = np.full(size, np.nan)
        base = corner + c0 if runs else corner
        for r in range(rows):
            h = h_first + r
            if not 0 <= h < H:
                continue
            if runs:
                gr = base + r * pitch
                per = (length + 14) // 8
                for j in range(npix * per):
                    px, k = divmod(j, per)
                    e = gr + px * cs
                    a = e - e % 8 + 8 * k
                    if a < e + length and 0 <= a < flat.size:
                        land(raw, base % 8 + r * rs + px * ps - e % 8 + 8 * k,
                             flat, a)
                continue
            gr = corner + r * pitch
            a0 = gr - gr % 8
            for a in range(a0, gr + npix * cs, 8):
                if 0 <= a < flat.size:
                    land(raw, corner % 8 + r * rs - (gr - a0) + (a - a0),
                         flat, a)
        return raw, base % 8

    for tm in range(p["tiles_m"]):
        m0 = tm * cmt
        cmb = min(cmt, cm - m0)
        cbm = 0 if runs else m0   # a raw pixel's first channel
        for tn in range(p["tiles_n"]):
            n0 = tn * bn
            bnc = min(bn, cn - n0)
            cbn = 0 if runs else n0
            # the ring's stages: planes (3 cmt + 1, ph, 16) and B (th, bn,
            # 16), NaN but the zero plane and B's columns past the tile's
            # channels
            stages = []
            for _ in range(p["stages"]):
                planes = np.full((3 * cmt + 1, ph, 16), np.nan)
                planes[3 * cmt] = 0.0
                b_tile = np.full((th, bn, 16), np.nan)
                b_tile[:, bnc:] = 0.0
                stages.append((planes, b_tile))
            it = 0
            for sp in range(splits):
                t0, t1 = total * sp // splits, total * (sp + 1) // splits
                acc = np.zeros((rows_m, bn))
                for t in range(t0, t1):
                    w0 = t % tiles_w * 16
                    h0 = t // tiles_w % tiles_h * th
                    img = t // (tiles_w * tiles_h)
                    raw_m, bm = copy_rows(
                        fm, ((img * H + h0 - 1) * W + w0 - 1) * cm, W * cm,
                        ph, 18, cm, m0, cmb, rsm, psm, h0 - 1,
                        ph * rsm + 16)
                    raw_n, bnn = copy_rows(
                        fn, ((img * H + h0) * W + w0) * cn, W * cn, th, 16,
                        cn, n0, bnc, rsn, psn, h0, th * rsn + 16)
                    planes, b_tile = stages[it % len(stages)]
                    it += 1
                    # M lines (pr, c) of the tile: 18 values, zero outside
                    # the image
                    pr = np.arange(ph)[:, None, None]
                    c = np.arange(cmb)[None, :, None]
                    q = np.arange(18)[None, None, :]
                    ok = ((h0 + pr - 1 >= 0) & (h0 + pr - 1 < H)
                          & (w0 + q - 1 >= 0) & (w0 + q - 1 < W))
                    v = np.where(ok, raw_m[bm + pr * rsm + q * psm + cbm + c],
                                 0.0)
                    for dx in range(3):
                        planes[dx * cmb:(dx + 1) * cmb] = v[
                            :, :, dx:dx + 16].transpose(1, 0, 2)
                    # N lines (r, n) of the tile's channels: 16 values
                    r = np.arange(th)[:, None, None]
                    nn = np.arange(bnc)[None, :, None]
                    q = np.arange(16)[None, None, :]
                    ok = (h0 + r < H) & (w0 + q < W)
                    b_tile[:, :bnc] = np.where(
                        ok, raw_n[bnn + r * rsn + q * psn + cbn + nn], 0.0)
                    # A rows (tap, c) tap-major, pad rows from the zero
                    # plane
                    m = np.arange(rows_m)
                    tap, ch = m // cmb, m % cmb
                    pad = m >= 9 * cmb
                    plane = np.where(pad, 3 * cmt, (tap % 3) * cmb + ch)
                    dy = np.where(pad, 0, tap // 3)
                    for step in range(th):
                        a = planes[plane, dy + step]          # (rows_m, 16)
                        acc += a @ b_tile[step].T             # (rows_m, bn)
                m = np.arange(9 * cmb)[:, None]
                dy, dx, ch = m // cmb // 3, m // cmb % 3, m0 + m % cmb
                cols = n0 + np.arange(bnc)[None, :]
                d = acc[:9 * cmb, :bnc]
                if side == "x":
                    ws[sp, dy, dx, ch, cols] = d
                else:
                    ws[sp, 2 - dy, 2 - dx, cols, ch] = d
    out = ws[0].copy()
    for sp in range(1, splits):   # sum_splits_kernel's order
        out = out + ws[sp]
    return out


# ragged pixel tiles at both image edges (11 rows: a partial second row of
# tiles at 8 rows, a third at 4; 35 columns: a third tile of 3), UNet
# 9/16's narrow dW (x side: the stem, 36->36, 36->72; g side: 72->36,
# the head), a 150-class head (four channel tiles, 4-row tiles), 64->28,
# 350->12 (a wide N side in three tiles of 128), 72->100 and 100->72 (two
# M channel tiles), 340->340 and 393->239 (pixel runs; M tiles of 57 and
# of 60 and 59, N tiles of 40 and a last one of 20 or 33), split-K ranges
# of uneven length
@pytest.mark.parametrize("shape", [
    (2, 11, 35, 3, 36, 5), (1, 11, 35, 36, 36, 3), (1, 11, 35, 72, 36, 4),
    (1, 9, 21, 36, 72, 2), (2, 11, 35, 36, 12, 7), (1, 11, 35, 64, 150, 3),
    (1, 11, 35, 64, 28, 2), (1, 7, 19, 350, 12, 2), (1, 5, 17, 12, 350, 1),
    (1, 3, 5, 3, 12, 1), (1, 6, 19, 72, 100, 2), (1, 5, 17, 100, 72, 3),
    (1, 5, 18, 340, 340, 2), (1, 3, 17, 393, 239, 1)],
    ids=lambda s: "x".join(map(str, s)))
def test_narrow_wgrad_model_matches_the_plain_version(shape):
    *dims, splits = shape
    x, g = _inputs(*dims, seed=3)
    want = conv_train.conv3x3_wgrad_plain(
        torch.from_numpy(x).double(), torch.from_numpy(g).double()).numpy()
    got = narrow_wgrad_model(x, g, splits)
    assert not np.isnan(got).any()
    # the plain version sums in f32 (it upcasts its inputs to f32)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_narrow_wgrad_model_reads_only_the_tensors():
    """x's and g's last 16-byte chunks end past them when N x H x W x C is
    no multiple of 8: what lies there (NaN in the model) is never read;
    the wrapper gives the kernel storage that holds those chunks
    (``fused_conv.whole_chunks``) and ``_check_wgrad`` refuses one
    without."""
    x, g = _inputs(1, 5, 7, 3, 36, seed=5)   # 105 elements of x
    assert x.size % 8
    assert not np.isnan(narrow_wgrad_model(x, g, 2)).any()
    xb, gb = torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16()
    assert conv_train.wgrad_path(3, 36) == "narrow"
    with pytest.raises(ValueError, match="last 16-byte chunk"):
        conv_train._check_wgrad(xb, gb)
    held = conv_train.whole_chunks(xb), conv_train.whole_chunks(gb)
    assert held[0] is not xb and torch.equal(held[0], xb)
    with pytest.raises(ValueError, match="last 16-byte chunk"):
        conv_train._check_wgrad(held[0], gb)   # 1,260 elements of g
    conv_train._check_wgrad(*held)


# ----------------------------------------------------------- rule, JAX

def _odd_width_wgrad(net, width):
    spec = (unet_model.scaled_spec(3, 12, width) if net == "unet"
            else segnet_model.scaled_spec(3, 12, width))
    return [(ci, co) for *_, ci, co in bench.block_shapes(net, (360, 480),
                                                           spec)]


@pytest.mark.parametrize("net,width,narrow", [
    ("unet", 0.5625, 7), ("segnet", 0.625, 0), ("unet", 1.0, 0)])
def test_path_rule_at_the_odd_widths(net, width, narrow):
    """UNet 9/16's training step sends exactly 7 of its 23 dW to the narrow
    path (3->36, 36->36 x2, 72->36 x2, 36->72, 36->12), each with a tile;
    SegNet 5/8 and the full-width models none."""
    pairs = _odd_width_wgrad(net, width)
    on = [pr for pr in pairs if conv_train.wgrad_path(*pr) == "narrow"]
    assert len(on) == narrow
    assert all(conv_train.wgrad_narrow_plan(*pr) is not None for pr in on)
    if narrow:
        assert sorted(on) == sorted([(3, 36), (36, 36), (36, 36), (72, 36),
                                     (72, 36), (36, 72), (36, 12)])
        assert [c[3:] for c in bench.narrow_wgrad_cases(width, 24)] == [
            (3, 36, 1), (36, 36, 2), (36, 72, 1), (72, 36, 2), (36, 12, 1)]


# UNet 9/16's narrow dW and a 150-class head's, at small maps: the port's
# CPU dW (its plain version) against JAX's Pallas _conv3x3_dw in interpret
# mode
@pytest.mark.parametrize("shape", [
    (1, 6, 10, 3, 36), (1, 6, 10, 36, 36), (1, 4, 6, 72, 36),
    (1, 6, 10, 36, 72), (1, 6, 10, 36, 12), (1, 4, 6, 64, 150),
    (1, 4, 6, 64, 28)],
    ids=lambda s: "x".join(map(str, s)))
def test_narrow_wgrad_matches_pallas_interpret(shape):
    n, h, w, cin, cout = shape
    assert conv_train.wgrad_path(cin, cout) == "narrow"
    x, g = _inputs(n, h, w, cin, cout, seed=4)
    try:
        want = np.asarray(_interpret(lambda: jax_pct._conv3x3_dw(
            jnp.asarray(x), jnp.asarray(g))))
    except ValueError:
        # JAX's _pick_tiles_dw has no tile here: its XLA path, the
        # gradient of the conv (what conv3x3_pallas falls back to)
        def conv(wt):
            return jax.lax.conv_general_dilated(
                jnp.asarray(x), wt, (1, 1), ((1, 1), (1, 1)),
                dimension_numbers=("NHWC", "HWIO", "NHWC"))
        want = np.asarray(jax.vjp(conv, jnp.zeros((3, 3, cin, cout)))[1](
            jnp.asarray(g))[0])
    got = conv_train.conv3x3_wgrad(torch.from_numpy(x), torch.from_numpy(g))
    assert got.shape == want.shape == (3, 3, cin, cout)
    # f32 both sides: the sums over the pixels in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


def test_the_first_design_is_only_a_variant():
    """The dW library holds no kernel but the narrow one for the narrow
    rule's shapes: the first, mma.sync, design lives in
    ``csrc/wgrad_mma_sync.cuh``, which no port source includes and only
    dw_variants' ``narrow_first`` build does; the C entry keeps its eleven
    arguments and the plan entry fills nine ints; the wrapper's split rule
    has no other narrow kernel's."""
    import ctypes

    class Fn:
        argtypes = restype = None

    class Lib:
        conv3x3_wgrad_bf16 = Fn()
        conv3x3_wgrad_pixel_tiles = Fn()
        conv3x3_wgrad_out_tiles = Fn()
        conv3x3_wgrad_path = Fn()
        conv3x3_wgrad_narrow_plan = Fn()

    lib = conv_train.bind_wgrad(Lib())
    assert len(lib.conv3x3_wgrad_bf16.argtypes) == 11
    assert len(lib.conv3x3_wgrad_narrow_plan.argtypes) == 3
    assert "out[8] = p.smem;" in SRC
    assert "mma_sync" not in SRC and "route" not in SRC.split(
        'extern "C"', 1)[1]
    header = conv_train.WGRAD_SOURCE.parent / "wgrad_mma_sync.cuh"
    assert "namespace mma_sync {" in header.read_text()
    for src in conv_train.WGRAD_SOURCE.parent.glob("*.cu"):
        assert "wgrad_mma_sync.cuh" not in src.read_text(), src
    assert '#include "wgrad_mma_sync.cuh"' in dw_variants.edited_source(
        "narrow_first")
    assert not hasattr(conv_train, "_BLOCKS_PER_SM")
    assert dw_variants._first_splits(24 * 45 * 30, 2, 132, "narrow") == 528
    conv_train.reset_launches()
    assert not hasattr(conv_train.conv3x3_wgrad, "mma_sync_launches")


def test_the_kernel_uses_wgmma_and_no_scalar_global_loads():
    """The narrow dW issues wgmma (``wgmma_rs_kmajor``), copies x and g
    only as 16-byte cp.async chunks (no element load from either tensor),
    and calls no library convolution."""
    kernel = NS[NS.index("conv3x3_wgrad_narrow_kernel("):
                NS.index("template <int MTW, int BN, bool TILED>\n"
                         "cudaError_t launch(")]
    assert "sm90::wgmma_rs_kmajor<BN>" in kernel
    assert "sm90::cp_async16(" in kernel
    assert "__ldg" not in kernel and "ms[" not in kernel
    assert "ns[" not in kernel and "x[" not in kernel and "g[" not in kernel
    assert "cudnn" not in SRC.lower() and "at::" not in SRC


@pytest.mark.parametrize("name", sorted(dw_variants.NARROW_VARIANTS))
def test_narrow_dw_variant_edits_apply(name):
    """Each narrow dW variant dw_variants.py times is an edit that applies
    once, inside the narrow namespace (route (a), stage counts,
    diagnostics; the first design's also at the namespace's banner, where
    it includes its header, and in the output tiles' entry), changes the
    source (but "narrow_kept") and drops the plan's static_asserts where it
    edits; the split runs name a built variant."""
    src = dw_variants.edited_source(name)
    assert (src == SRC) == (name == "narrow_kept")
    for old, _ in dw_variants.NARROW_VARIANTS[name]:
        first = old[0] if isinstance(old, tuple) else old
        assert SRC.count(first) == 1, first
        assert NS.count(first) == 1 or name == "narrow_first", first
    if name != "narrow_kept":
        assert "static_assert(plan(" not in src
    assert all(s in dw_variants.NARROW_VARIANTS
               for s, _ in dw_variants.NARROW_SPLIT_RUNS.values())


@pytest.mark.parametrize("name", sorted(
    __import__("chip_faults").NARROW_DW_FAULTS))
def test_narrow_dw_fault_edits_apply(name):
    """Each planted fault of the narrow dW (chip_faults.py) edits its
    source once, inside the narrow namespace, and changes it; it is built
    on the card by ``chip_faults.narrow_dw_fault`` and caught there by
    ``narrow_wgrad_checks``."""
    import chip_faults
    module, edits = chip_faults.NARROW_DW_FAULTS[name]
    assert module.SOURCE == conv_train.WGRAD_SOURCE
    assert module.bind is conv_train.bind_wgrad
    for old, new in edits:
        assert SRC.count(old) == 1 and NS.count(old) == 1 and old != new
    edited = chip_faults.edited_source(name)
    assert edited != SRC and all(new in edited for _, new in edits)


def test_narrow_dw_faults_take_the_libraries_place(monkeypatch):
    """``narrow_dw_fault`` builds the three variants once and puts the
    named one in place of conv_train's dW library inside the block only;
    the narrow path's fault cases run them."""
    import chip_faults
    builds = []
    monkeypatch.setattr(chip_faults, "_NARROW_DW_LIBS", {})
    monkeypatch.setattr(chip_faults, "_build_fault", lambda n: (
        builds.append(n) or (n, f"lib {n}")))
    sound = conv_train._wgrad_library
    with chip_faults.narrow_dw_fault("tap_column_shift"):
        assert conv_train._wgrad_library() == "lib tap_column_shift"
    with chip_faults.narrow_dw_fault("split_ranges_overlap"):
        assert conv_train._wgrad_library() == "lib split_ranges_overlap"
    assert conv_train._wgrad_library is sound
    assert sorted(builds) == sorted(chip_faults.NARROW_DW_FAULTS)
    names = [what for path, what, _ in chip_faults.fault_cases()
             if path == "narrow" and "dW" in what]
    assert len(names) == 3
