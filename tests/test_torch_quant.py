"""The port's int8 quantization (``ops/quant.py``) and its int8 block
(``ops/fused_conv_int8.py``) against the JAX package's ``ops/quant.py``, on
the CPU: the same numpy inputs, made from a seed, through both.

Tolerances:
- ``fold_bn``: 1e-6 relative (``rsqrt`` may differ by an ulp between XLA
  and torch);
- ``quantize_block``: with BN variances whose ``rsqrt`` is exact (var +
  eps = 1), ``s_w``, ``s_x`` and ``b_eff`` within 1 f32 ulp and ``w_q``
  equal; with random variances XLA's and torch's ``rsqrt`` differ by up to
  2 ulps, so ``s_w`` within 4 ulps, ``b_eff`` within 1e-6 of max|b_eff|
  (its cancellation near zero multiplies ulps) and ``w_q`` equal but for
  values that land on a rounding boundary: at most 1 in 1000 weights, each
  by 1;
- ``conv2d_int8``: bit-equal (integer sums);
- ``quantized_block_apply`` from the same int8 params: f32 output within
  1e-6 of max|y|, bf16 within one bf16 ulp, int8 within 1 LSB on at most
  0.1% of the values (JAX's own bound for a changed rounding place,
  tests/test_quant.py).
On the CPU the block runs the kernel's plain version; the kernel's packed
weight layouts are checked here against numpy models of how the kernel
reads them.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pytorch_camvid_tpu.ops import quant as jq

from pytorch_camvid_tpu_torch.ops import fused_conv_int8 as fq
from pytorch_camvid_tpu_torch.ops import quant as tq
from pytorch_camvid_tpu_torch.ops.conv import BasicConv, ConvBNReLU


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _block(rng, cin, cout):
    """A block's params and BN state as numpy: HWIO w, non-trivial BN."""
    p = {"w": rng.normal(0, (2.0 / (9 * cin)) ** 0.5,
                         (3, 3, cin, cout)).astype(np.float32),
         "b": rng.normal(0, 0.1, cout).astype(np.float32),
         "scale": rng.uniform(0.5, 1.5, cout).astype(np.float32),
         "bias": rng.normal(0, 0.2, cout).astype(np.float32)}
    s = {"mean": rng.normal(0, 0.3, cout).astype(np.float32),
         "var": rng.uniform(0.5, 2.0, cout).astype(np.float32)}
    return p, s


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("cin,cout", [(3, 64), (64, 128), (256, 24)])
def test_fold_bn(cin, cout):
    p, s = _block(np.random.default_rng(cin), cin, cout)
    wj, bj = jq.fold_bn(p, s)
    wt, bt = tq.fold_bn(_t(p), _t(s))
    for got, want in ((wt, wj), (bt, bj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("exact_rsqrt", [True, False])
@pytest.mark.parametrize("cin,cout", [(3, 64), (64, 64), (128, 256)])
def test_quantize_block(cin, cout, exact_rsqrt):
    rng = np.random.default_rng(7 + cin)
    p, s = _block(rng, cin, cout)
    if exact_rsqrt:   # var + 1e-5 rounds to 1.0 in f32
        s["var"][:] = np.float32(1.0) - np.float32(1e-5)
    amax = np.float32(rng.uniform(1, 4))
    qj = _np(jq.quantize_block(p, s, jnp.asarray(amax)))
    qt = {k: v.numpy() for k, v in
          tq.quantize_block(_t(p), _t(s), torch.tensor(amax)).items()}
    assert set(qt) == set(qj) == {"w_q", "s_w", "s_x", "b_eff"}
    assert qt["w_q"].dtype == np.int8 and qt["w_q"].shape == (3, 3, cin,
                                                              cout)
    diff = np.abs(qt["w_q"].astype(int) - qj["w_q"].astype(int))
    np.testing.assert_array_max_ulp(qt["s_x"], qj["s_x"], maxulp=1)
    if exact_rsqrt:
        for k in ("s_w", "b_eff"):
            np.testing.assert_array_max_ulp(qt[k], qj[k], maxulp=1)
        assert not diff.any()
        return
    np.testing.assert_array_max_ulp(qt["s_w"], qj["s_w"], maxulp=4)
    np.testing.assert_allclose(qt["b_eff"], qj["b_eff"], rtol=0,
                               atol=1e-6 * np.abs(qj["b_eff"]).max())
    assert diff.max() <= 1
    assert (diff > 0).sum() <= max(1, diff.size // 1000), (diff > 0).sum()


def test_quantize_block_zero_channel_and_clip():
    """An all-zero output channel keeps s_w = 1e-12 and w_q = 0; an amax of
    0 gives s_x = 1e-12 / 127, as in JAX."""
    p, s = _block(np.random.default_rng(1), 8, 16)
    p["w"][..., 3] = 0
    s["var"][:] = np.float32(1.0) - np.float32(1e-5)   # exact rsqrt
    qj = _np(jq.quantize_block(p, s, jnp.float32(0)))
    qt = tq.quantize_block(_t(p), _t(s), torch.tensor(0.0))
    assert (qt["w_q"][..., 3] == 0).all()
    np.testing.assert_array_equal(qt["s_w"].numpy(), qj["s_w"])
    np.testing.assert_array_equal(qt["s_x"].numpy(), qj["s_x"])


@pytest.mark.parametrize("n,h,w,cin,cout", [(1, 7, 9, 3, 64),
                                            (2, 9, 5, 16, 24),
                                            (1, 11, 13, 64, 32)])
def test_conv2d_int8_bit_equal(n, h, w, cin, cout):
    rng = np.random.default_rng(h * w + cin)
    x = rng.integers(-127, 128, (n, h, w, cin), dtype=np.int8)
    wq = rng.integers(-127, 128, (3, 3, cin, cout), dtype=np.int8)
    want = np.asarray(jq.conv2d_int8(jnp.asarray(x), jnp.asarray(wq)))
    got = tq.conv2d_int8(torch.from_numpy(x), torch.from_numpy(wq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_conv2d_int8_extremes_exact():
    """All operands at +-127 with Cin 1024: sums of 9216 products, 1.5e8,
    past f32's 2**24, are still exact."""
    x = np.full((1, 3, 4, 1024), 127, np.int8)
    x[0, 1, 2, ::2] = -127
    wq = np.full((3, 3, 1024, 8), -127, np.int8)
    got = tq.conv2d_int8(torch.from_numpy(x), torch.from_numpy(wq)).numpy()
    want = np.asarray(jq.conv2d_int8(jnp.asarray(x), jnp.asarray(wq)))
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() > 2 ** 24


def _qparams(rng, cin, cout, s_out=False):
    p, s = _block(rng, cin, cout)
    q = _np(jq.quantize_block(p, s, jnp.float32(2.5)))
    if s_out:
        q["s_out"] = np.float32(0.05)
    return q


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("int8_in", [False, True])
def test_quantized_block_apply(mode, int8_in):
    rng = np.random.default_rng(3)
    cin, cout = 16, 32
    q = _qparams(rng, cin, cout, s_out=mode == "int8")
    if int8_in:
        x = rng.integers(-127, 128, (2, 9, 11, cin), dtype=np.int8)
    else:
        x = rng.normal(0, 1.0, (2, 9, 11, cin)).astype(np.float32)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.bfloat16}
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16,
           "int8": torch.bfloat16}
    xj = jnp.asarray(x) if int8_in else jnp.asarray(x).astype(jdt[mode])
    xt = torch.from_numpy(x) if int8_in else torch.from_numpy(x).to(
        tdt[mode])
    want = np.asarray(jq.quantized_block_apply(
        {k: jnp.asarray(v) for k, v in q.items()}, xj, jdt[mode])
        .astype(jnp.float32 if mode != "int8" else jnp.int8))
    qt = {k: torch.from_numpy(np.array(v)) for k, v in q.items()}
    got = tq.quantized_block_apply(qt, xt, tdt[mode])
    if mode == "int8":
        assert got.dtype == torch.int8
        d = np.abs(got.numpy().astype(int) - want.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d > 0).mean()
        return
    assert got.dtype == tdt[mode]
    got = got.float().numpy()
    if mode == "f32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    else:   # one bf16 ulp of the value
        np.testing.assert_array_less(np.abs(got - want),
                                     np.abs(want) * 2 ** -7 + 1e-30)


def test_plain_block_is_the_kernels_function():
    """``conv3x3_int8_block`` on CPU tensors is its plain version, in all
    three modes, with int8 out exactly when s_out is given."""
    rng = np.random.default_rng(5)
    q = {k: torch.from_numpy(np.array(v))
         for k, v in _qparams(rng, 3, 64, s_out=True).items()}
    x = torch.from_numpy(rng.integers(-127, 128, (1, 6, 7, 3),
                                      dtype=np.int8))
    args = (x, q["w_q"], q["s_w"], q["s_x"], q["b_eff"])
    for s_out, dt in ((q["s_out"], torch.int8), (None, torch.bfloat16),
                      (None, torch.float32)):
        got = fq.conv3x3_int8_block(*args, s_out, dt)
        want = fq.conv3x3_int8_block_plain(*args, s_out, dt)
        assert got.dtype == dt and torch.equal(got, want)
    y = fq.conv3x3_int8_block_plain(*args, None, torch.float32)
    assert torch.equal(fq.conv3x3_int8_block_plain(*args, q["s_out"],
                                                   torch.int8),
                       fq.quantize(y, q["s_out"]))


def test_requantize_divides():
    """The epilogue's requantize divides by s_out: a multiply by its
    reciprocal rounds some values near k + 1/2 to the other integer."""
    s = torch.tensor(0.0029, dtype=torch.float32)
    y = (torch.arange(127, dtype=torch.float32) + 0.5) * s
    y = torch.cat([torch.nextafter(y, torch.tensor(0.0)), y,
                   torch.nextafter(y, torch.tensor(1.0))])
    q = fq.quantize(y, s)
    by_recip = torch.clamp(torch.round(y * (1 / s)), -127, 127).to(
        torch.int8)
    want = np.clip(np.round(y.numpy() / np.float32(0.0029)), -127, 127)
    np.testing.assert_array_equal(q.numpy(), want.astype(np.int8))
    assert not torch.equal(q, by_recip)


ODD_CIN = [33, 36, 40, 72, 100]   # wgmma at Cin % 16 != 0


@pytest.mark.parametrize("cin", [1, 3, 4, 16, 31, 32, 48, 64, 96]
                         + ODD_CIN)
def test_int8_path_rule(cin):
    want = "packed" if cin < 32 else "wgmma"
    assert fq.int8_path(cin) == want
    assert fq.packed_k(cin) % 32 == 0 and fq.packed_k(cin) >= 9 * cin


@pytest.mark.parametrize("cin", [0, -4])
def test_int8_path_refuses_no_channels(cin):
    assert fq.int8_path(cin) == "none"
    with pytest.raises(ValueError, match="Cin > 0"):
        fq.pack_weights(torch.zeros((3, 3, max(cin, 0), 8),
                                    dtype=torch.int8))


@pytest.mark.parametrize("cin", ODD_CIN + [48, 128])
def test_pack_weights_pads_the_wgmma_layout(cin):
    """On the wgmma path the packed weights are (9, Cout, Cs), Cs = 16 *
    ceil(Cin / 16): below Cin bit-equal to the unpadded K-major layout
    (tap, Cout, Cin), zero columns past it."""
    cout = 24
    rng = np.random.default_rng(cin)
    wq = torch.from_numpy(rng.integers(-127, 128, (3, 3, cin, cout),
                                       dtype=np.int8))
    cs = -(-cin // 16) * 16
    wk = fq.pack_weights(wq)
    assert wk.dtype == torch.int8 and wk.is_contiguous()
    assert tuple(wk.shape) == (9, cout, cs)
    assert torch.equal(wk[..., :cin],
                       wq.reshape(9, cin, cout).transpose(1, 2))
    assert not wk[..., cin:].any()


@pytest.mark.parametrize("cin,cs", [(3, 3), (31, 31), (32, 32), (33, 48),
                                    (36, 48), (40, 48), (48, 48), (72, 80),
                                    (100, 112), (144, 144), (576, 576)])
def test_pixel_stride_and_block_layout(cin, cs):
    """The pixel stride the kernel reads (Cin on the packed path, Cin
    rounded up to 16 bytes on the wgmma path, where x's tensor map takes
    the block layout's pixel, row and image strides, each a multiple of 16
    bytes as TMA needs); the block layout's strides, an empty block input,
    and ``block_input`` copying a contiguous x into it once (values kept)
    and leaving an x already in it as it is."""
    n, h, w = 2, 5, 7
    assert fq.pixel_stride(cin) == cs
    if fq.int8_path(cin) == "wgmma":
        assert all(v % 16 == 0 for v in fq.block_strides(n, h, w, cin)[:3])
    assert fq.block_strides(n, h, w, cin) == (h * w * cs, w * cs, cs, 1)
    e = fq.empty_block_input((n, h, w, cin), "cpu")
    assert e.shape == (n, h, w, cin) and e.stride() == fq.block_strides(
        n, h, w, cin) and e.dtype == torch.int8
    x = torch.from_numpy(np.random.default_rng(cin).integers(
        -127, 128, (n, h, w, cin), dtype=np.int8))
    laid = fq.block_input(x)
    assert torch.equal(laid, x)
    assert laid.stride() == fq.block_strides(n, h, w, cin)
    assert (laid.data_ptr() == x.data_ptr()) == (cs == cin)
    assert fq.block_input(laid).data_ptr() == laid.data_ptr()


@pytest.mark.parametrize("c", [36, 40, 64, 3])
def test_quantize_writes_the_block_layout(c):
    """``quantize`` (and its op, ``camvid::quantize_int8``: opcheck)
    returns an (N,H,W,C) input in the int8 block's layout, its values
    ``quantize_plain``'s; 2-D stays contiguous."""
    x = torch.from_numpy(np.random.default_rng(c).normal(
        0, 1, (2, 3, 5, c)).astype(np.float32))
    s = torch.tensor(0.013)
    q = fq.quantize(x, s)
    assert torch.equal(q, fq.quantize_plain(x, s))
    assert q.stride() == fq.block_strides(*q.shape)
    op = torch.ops.camvid.quantize_int8
    torch.library.opcheck(op, (x, s))
    assert op(x, s).stride() == q.stride()
    flat = fq.quantize(x.reshape(-1, c), s)
    assert flat.is_contiguous() and torch.equal(flat, q.reshape(-1, c))


def test_odd_cin_block_on_the_padded_layout():
    """The block takes its x in the padded layout (the channels past Cin
    holding anything) and contiguous alike, with the same result."""
    rng = np.random.default_rng(40)
    q = _qparams(rng, 40, 48, s_out=True)
    qt = {k: torch.from_numpy(np.array(v)) for k, v in q.items()}
    x = torch.from_numpy(rng.integers(-127, 128, (1, 6, 7, 40),
                                      dtype=np.int8))
    buf = torch.full((1, 6, 7, 48), 99, dtype=torch.int8)
    buf[..., :40] = x
    args = (qt["w_q"], qt["s_w"], qt["s_x"], qt["b_eff"], qt["s_out"],
            torch.int8)
    want = fq.conv3x3_int8_block_plain(x, *args)
    assert torch.equal(fq.conv3x3_int8_block(buf[..., :40], *args), want)
    assert torch.equal(tq.quantized_block_apply(qt, buf[..., :40]), want)


def _shifted(x, dy, dx):
    """x (N,H,W,C) read at (h + dy - 1, w + dx - 1), zero outside."""
    n, h, w, c = x.shape
    p = np.zeros((n, h + 2, w + 2, c), np.int64)
    p[:, 1:-1, 1:-1] = x
    return p[:, dy: dy + h, dx: dx + w]


def _tma_swizzle(off, span):
    """The shared-memory byte at which TMA puts byte ``off`` of a box
    written with the ``span``-byte swizzle (128 or 64): the 16-byte chunk
    index XORed with the low bits of the 128-byte line's."""
    mask = 7 if span == 128 else 3
    return off ^ (((off >> 7) & mask) << 4)


def _kernel_swz(row, chunk, kc):
    """conv3x3_int8.cu's ``wg::swz<KC>``: the byte of 16-byte chunk
    ``chunk`` of box row ``row`` (a patch pixel) that ldmatrix reads."""
    if kc == 128:
        return row * 128 + (((chunk ^ row) & 7) << 4)
    return row * 64 + (((chunk ^ (row >> 1)) & 3) << 4)


@pytest.mark.parametrize("cin,cout", [(32, 24), (64, 8), (48, 16),
                                      (192, 40), (40, 16), (100, 8),
                                      (136, 24)])
def test_wgmma_layout_model(cin, cout):
    """A numpy model of the wgmma path's reads: per chunk of KC channels
    (64 up to Cin 64, else 128), TMA's swizzled box of the patch with zeros
    past Cin; each k32 step's A row read at the kernel's ldmatrix
    addresses (``swz<KC>``) of the tap's shifted pixel, against the (tap,
    chunk) slice of the packed weights; summed over taps, chunks and
    steps, it equals conv2d_int8."""
    rng = np.random.default_rng(cin + cout)
    h, w = 5, 6
    x = rng.integers(-127, 128, (1, h, w, cin), dtype=np.int8)
    wq = rng.integers(-127, 128, (3, 3, cin, cout), dtype=np.int8)
    wk = fq.pack_weights(torch.from_numpy(wq)).numpy()
    cs = fq.pixel_stride(cin)
    assert wk.shape == (9, cout, cs)
    kc = 64 if cin <= 64 else 128
    nch = -(-cin // kc)
    pw = w + 2
    # x's map reads Cin channels of each pixel (TMA's zeros past them, in
    # the halo too); the weights' map reads Cs, its zero columns included
    xp = np.zeros((h + 2, pw, nch * kc), np.int64)
    xp[1:-1, 1:-1, :cin] = x[0]
    wp = np.zeros((9, cout, nch * kc), np.int64)
    wp[..., :cs] = wk
    oy, ox = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    acc = np.zeros((h, w, cout), np.int64)
    for c in range(nch):
        box = xp[..., c * kc:(c + 1) * kc].reshape(-1)
        smem = np.zeros_like(box)
        smem[_tma_swizzle(np.arange(box.size), kc)] = box
        for t in range(9):
            row = (oy + t // 3) * pw + ox + t % 3
            for s in range(kc // 32):
                a = np.concatenate(
                    [smem[_kernel_swz(row, 2 * s + hf, kc)[..., None]
                          + np.arange(16)] for hf in range(2)], axis=-1)
                acc += a @ wp[t, :, c * kc + 32 * s:c * kc + 32 * s + 32].T
    want = tq.conv2d_int8(torch.from_numpy(x), torch.from_numpy(wq))
    np.testing.assert_array_equal(acc, want[0].numpy())


def _stage_off(mode, np_, p, c):
    """conv3x3_int8.cu's ``stage_off<MODE, NP>``: the byte of (pixel p,
    channel c) in a warp's staged output row."""
    if mode == 0:
        return p * 64 + ((((c >> 4) ^ (p >> 1)) & 3) << 4) + (c & 15)
    if mode == 1:
        return p * 128 + ((((c >> 3) ^ p) & 7) << 4) + ((c & 7) << 1)
    return ((c >> 5) * (np_ * 128) + p * 128
            + (((((c & 31) >> 2) ^ p) & 7) << 4) + ((c & 3) << 2))


@pytest.mark.parametrize("np_", [16, 32])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_output_staging_model(mode, np_):
    """The staged output row is the TMA store's box as TMA reads it: int8
    one box of 64-byte rows (64-byte swizzle), bf16 one of 128-byte rows
    and f32 two of 32 channels (128-byte swizzle); every (pixel, channel)
    has its own bytes, and the 8 pixels of an accumulator fragment (same
    channel) fall in 8 different 16-byte chunks' banks."""
    ob = (1, 2, 4)[mode]
    p, c = np.meshgrid(np.arange(np_), np.arange(64), indexing="ij")
    got = _stage_off(mode, np_, p, c)
    if mode < 2:
        span = 64 * ob
        want = _tma_swizzle(p * span + c * ob, span)
    else:
        want = (c >> 5) * np_ * 128 + _tma_swizzle(p * 128 + (c & 31) * 4,
                                                   128)
    np.testing.assert_array_equal(got, want)
    for c0 in range(0, 64, 2):
        banks = (_stage_off(mode, np_, np.arange(8), c0) // 4) % 32
        assert len(set(banks)) == 8


def _packed_patch(x, h0, w0, c4):
    """The packed kernel's patch of the tile at (h0, w0), built as the
    kernel builds it: each of the 10 rows, (32 + 2) x Cin bytes of NHWC x
    from byte grs, read in 16-byte chunks aligned in x (a chunk across the
    image's edge bytewise, rows outside the image not at all) and scattered
    to pixel d // Cin, channel d % Cin of a row of 34 x Cin4 bytes."""
    _, hh, ww, cin = x.shape
    flat = x.reshape(-1).astype(np.int64)
    rs = 34 * c4
    patch = np.zeros((10, rs), np.int64)
    for pr in range(10):
        hr = h0 + pr - 1
        if not 0 <= hr < hh:
            continue
        rowpix = hr * ww
        grs = (rowpix + w0 - 1) * cin
        e0 = (rowpix + max(w0 - 1, 0)) * cin
        e1 = (rowpix + min(w0 + 33, ww)) * cin
        for q in range(((grs & 15) + 34 * cin + 15) // 16):
            g0 = (grs & ~15) + 16 * q
            chunk = [flat[g] if e0 <= g < e1 else 0
                     for g in range(g0, g0 + 16)]
            for u, v in enumerate(chunk):
                d = g0 + u - grs
                if 0 <= d < 34 * cin:
                    patch[pr, d // cin * c4 + d % cin] = v
    return patch.reshape(-1)


@pytest.mark.parametrize("cin,cout", [(3, 64), (4, 12), (16, 8), (31, 21)])
def test_packed_layout_model(cin, cout):
    """A numpy model of the packed path: the patch as the kernel builds it
    (``_packed_patch``: pixels of Cin4 bytes, the pad channels zero) at a
    tile inside the image and one across its right and bottom edges; each
    pixel's A row gathered as 4-byte words at the per-lane offsets of
    packed k (k = tap * Cin4 + ci, any word past 9 * Cin4); its product
    with the packed (Cout, Kp) weights equals conv2d_int8."""
    rng = np.random.default_rng(cin + cout)
    h, w = 11, 45
    x = rng.integers(-127, 128, (1, h, w, cin), dtype=np.int8)
    wq = rng.integers(-127, 128, (3, 3, cin, cout), dtype=np.int8)
    wk = fq.pack_weights(torch.from_numpy(wq)).numpy().astype(np.int64)
    c4, kp = fq.packed_cin(cin), fq.packed_k(cin)
    assert wk.shape == (cout, kp) and not wk[:, 9 * c4:].any()
    assert not wk[:, :9 * c4].reshape(cout, 9, c4)[..., cin:].any()
    rs = 34 * c4

    def koff(k):
        if k >= 9 * c4:
            return 0
        tap, ci = divmod(k, c4)
        return (tap // 3) * rs + (tap % 3) * c4 + ci

    offs = np.array([koff(k) for k in range(0, kp, 4)])
    want = tq.conv2d_int8(torch.from_numpy(x), torch.from_numpy(wq))[0]
    for h0, w0 in ((0, 0), (8, 32)):
        patch = _packed_patch(x, h0, w0, c4)
        for r in range(min(8, h - h0)):
            for c in range(min(32, w - w0)):
                base = r * rs + c * c4
                a = patch[base + offs[:, None] + np.arange(4)].reshape(-1)
                np.testing.assert_array_equal(wk @ a,
                                              want[h0 + r, w0 + c].numpy())


def _width_three_quarter_shapes():
    """(H, W, Cin, Cout) of the int8 blocks of a width-3/4 UNet at 45x60
    (Cin 48, 96, 192, 384, 768), each once."""
    from pytorch_camvid_tpu_torch import bench
    from pytorch_camvid_tpu_torch.models import get_model
    spec = get_model("unet", 3, 12, width_mult=0.75).spec
    return sorted(set(bench.block_shapes("unet", (45, 60), spec)))


@pytest.mark.parametrize("h,w,cin,cout", _width_three_quarter_shapes())
def test_width_three_quarter_unet_blocks(h, w, cin, cout):
    """Every block of a width-3/4 UNet takes a kernel path (no Cin is
    refused), and its quantized block, int8 in and int8 out, matches JAX's
    ``quantized_block_apply`` (within 1 LSB on at most 0.1% of the values,
    as ``test_quantized_block_apply``)."""
    assert fq.int8_path(cin) != "none"
    rng = np.random.default_rng(h * w + cin + cout)
    q = _qparams(rng, cin, cout, s_out=True)
    x = rng.integers(-127, 128, (1, h, w, cin), dtype=np.int8)
    want = np.asarray(jq.quantized_block_apply(
        {k: jnp.asarray(v) for k, v in q.items()}, jnp.asarray(x),
        jnp.bfloat16).astype(jnp.int8))
    qt = {k: torch.from_numpy(np.array(v)) for k, v in q.items()}
    assert fq.pack_weights(qt["w_q"]).dtype == torch.int8
    got = tq.quantized_block_apply(qt, torch.from_numpy(x), torch.bfloat16)
    assert got.dtype == torch.int8
    d = np.abs(got.numpy().astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d > 0).mean()


def _qblock(cls=ConvBNReLU, cin=8, cout=16, s_out=False):
    blk = cls(cin, cout, torch.Generator().manual_seed(0)).eval()
    conv, bn = blk.conv_bn()
    q = tq.quantize_block({"w": conv.weight.detach().permute(2, 3, 1, 0),
                           "b": conv.bias.detach(),
                           "scale": bn.weight.detach(),
                           "bias": bn.bias.detach()},
                          {"mean": bn.running_mean, "var": bn.running_var},
                          torch.tensor(3.0))
    blk.set_quantized(q["w_q"], q["s_w"], q["s_x"], q["b_eff"],
                      torch.tensor(0.1) if s_out else None)
    return blk


@pytest.mark.parametrize("cls", [ConvBNReLU, BasicConv])
def test_quantized_block_refuses_train_mode(cls):
    blk = _qblock(cls)
    x = torch.randn(1, 5, 6, 8)
    assert blk(x).dtype == torch.float32
    blk.train()
    with pytest.raises(RuntimeError, match="serving-only"):
        blk(x)


def test_quantized_block_buffers_stay_out_of_the_state_dict():
    """The int8 buffers are non-persistent: the reference-named state_dict
    is the float block's, it loads with strict=True, and loading one makes
    the block float again."""
    blk = _qblock(s_out=True)
    float_blk = ConvBNReLU(8, 16)
    assert set(blk.state_dict()) == set(float_blk.state_dict())
    assert {n for n, _ in blk.named_buffers()} >= {"w_q", "s_w", "s_x",
                                                   "b_eff", "s_out", "w_k"}
    assert blk.w_k.shape == (16, fq.packed_k(8))
    blk.load_state_dict(float_blk.state_dict(), strict=True)
    assert not blk.quantized and not hasattr(blk, "w_q")


def test_int8_input_needs_the_compute_dtype():
    """A block that takes int8 and emits the compute dtype reads it from
    the model's forward (``computing_in``); alone it raises."""
    from pytorch_camvid_tpu_torch.ops.conv import computing_in
    blk = _qblock()
    x = torch.randint(-127, 128, (1, 4, 5, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="computing_in"):
        blk(x)
    with computing_in(torch.bfloat16):
        assert blk(x).dtype == torch.bfloat16
    assert _qblock(s_out=True)(x).dtype == torch.int8


def _kernel_requant(y, s, second_pass=True):
    """A numpy model of conv3x3_int8's requantize, in f32 as the kernel
    computes it: q0 = min(fl(y * fl(1/s)), 255) rounded half to even by
    adding 1.5 * 2^23, and where q0 lies within 2^-22 q0 of a half-integer
    below 127 the IEEE quotient's rounding instead (the second pass)."""
    f32 = np.float32
    magic = f32(1.5 * 2 ** 23)
    r = f32(1) / s
    q0 = np.minimum((y * r).astype(f32), f32(255))
    t = (q0 + magic).astype(f32)
    d = (q0 - (t - magic).astype(f32)).astype(f32)
    near = (np.abs((f32(0.5) - np.abs(d)).astype(f32)) <= q0 * f32(2.0 ** -22)
            ) & (q0 < f32(127))
    q = np.minimum(t.view(np.int32) - magic.view(np.int32), 127)
    if second_pass:
        q = np.where(near, np.clip(np.round(y / s), -127, 127), q)
    return q, near


@pytest.mark.parametrize("scale", [3.1e-7, 0.0029, 0.0417, 1.37])
def test_kernel_requantize_equals_the_division(scale):
    """At every value the kernel's two-step requantize gives the rounding
    of the IEEE quotient (the plain version's), on values at, just below
    and just above each k + 1/2 and on random ones; without its second
    pass (the reciprocal alone) it does not."""
    rng = np.random.default_rng(int(scale * 1e7))
    s = np.float32(scale)
    k = np.arange(-1, 131, dtype=np.float32)
    y = ((k + np.float32(0.5)) * s).astype(np.float32)
    y = np.concatenate([y, np.nextafter(y, np.float32(0)),
                        np.nextafter(y, np.float32(np.inf)),
                        (rng.uniform(0, 140, 200000) * s).astype(np.float32)])
    y = np.maximum(y, np.float32(0))   # after the ReLU
    want = fq.quantize(torch.from_numpy(y), torch.tensor(s)).numpy()
    got, near = _kernel_requant(y, s)
    np.testing.assert_array_equal(got.astype(np.int8), want)
    assert near.mean() < 0.02
    one_step, _ = _kernel_requant(y, s, second_pass=False)
    assert (one_step.astype(np.int8) != want).any()


def test_calibrate_refuses_a_quantized_model():
    """Calibration reads float blocks' inputs: on a model quantized already
    (a second ``quantize_int8``) it raises instead of recording nothing."""
    from pytorch_camvid_tpu_torch.models import get_model
    model = get_model("unet", 3, 12, width_mult=1 / 16,
                      generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn(1, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        tq.quantize_model(model, tq.calibrate(model, [x]), min_cout=0)
        with pytest.raises(ValueError, match="quantized already"):
            tq.calibrate(model, [x])


def test_kernel_wrappers_refuse_other_devices():
    """The int8 wrappers run their plain versions on CPU tensors only; a
    tensor on another device that is not CUDA raises (no fallback)."""
    rng = np.random.default_rng(9)
    q = {k: torch.from_numpy(np.array(v)).to("meta")
         for k, v in _qparams(rng, 8, 16, s_out=True).items()}
    x = torch.empty((1, 4, 5, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        fq.conv3x3_int8_block(x, q["w_q"], q["s_w"], q["s_x"], q["b_eff"],
                              q["s_out"], torch.int8)
    with pytest.raises(ValueError, match="no kernel for meta"):
        fq.quantize(torch.empty((2, 3), device="meta"), q["s_x"])
    xf = torch.randn(2, 3, 4, 5)
    s = torch.tensor(0.02)
    assert torch.equal(fq.quantize(xf, s), fq.quantize_plain(xf, s))
