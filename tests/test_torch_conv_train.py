"""The port's training conv (K1, pytorch_camvid_tpu_torch/ops/conv_train.py)
and train-mode conv+BN+ReLU block against the JAX package, on the CPU.

JAX runs ``conv3x3_pallas`` with its Pallas calls in interpret mode, as
tests/test_pallas_conv_train.py runs it. On CPU tensors the port's wrappers
run their plain versions inside the same ``autograd.Function`` that
launches the kernels on the card, so the dx weight's tap reversal (the
kernel's ``flip``), the dW layout and the dtype casts are what is checked
here, with the kernel path each call takes; the CUDA kernels are held
against these plain versions on the card by chip_smoke.py."""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pytorch_camvid_tpu.ops import pallas_conv_train as jax_pct
from pytorch_camvid_tpu.ops.conv import conv_bn_relu_apply
from pytorch_camvid_tpu.ops.pooling import max_pool_2x2 as jax_pool

from pytorch_camvid_tpu_torch import bench, dw_variants
from pytorch_camvid_tpu_torch.ops import conv_train, fused_conv
from pytorch_camvid_tpu_torch.ops.conv import ConvBNReLU
from pytorch_camvid_tpu_torch.ops.pooling import max_pool_2x2


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


# stem-like Cin=3, head-like Cout=12, odd H x W; the stem at Cout 64 (its
# forward and dW on the packed paths on the card); the head, Cin 64 into
# Cout 12 (its dx and dW on the packed paths)
SHAPES = [(2, 5, 7, 3, 8), (1, 9, 11, 8, 12), (2, 9, 15, 3, 64),
          (1, 9, 11, 64, 12)]


@pytest.mark.parametrize("plain", [False, True], ids=["autograd_fn", "plain"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_train_matches_pallas_vjp(shape, plain):
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(
        np.float32)
    t = rng.normal(size=(n, h, w, cout)).astype(np.float32)

    def loss(x, w):
        return jnp.sum(jax_pct.conv3x3_pallas(x, w) * t)

    (y, (dx, dw)) = _interpret(lambda: (
        jax_pct.conv3x3_pallas(jnp.asarray(x), jnp.asarray(wt)),
        jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wt))))

    xt = torch.from_numpy(x).requires_grad_()
    wtt = torch.from_numpy(wt).requires_grad_()
    yt = conv_train.conv3x3_train(xt, wtt, plain=plain)
    gx, gw = torch.autograd.grad((yt * torch.from_numpy(t)).sum(), (xt, wtt))
    # f32 on both sides; the sums of 9*Cin (y, dx) and N*H*W (dW)
    # products differ only in order: a few ulps of their scale
    for got, want in ((yt, y), (gx, dx), (gw, dw)):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())


def test_wgrad_and_dgrad_plain_versions_match_autograd():
    """The plain dx and dW that chip_smoke.py holds the kernels against,
    and dx's library yardstick, equal autograd's gradients of the plain
    forward."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 6, 9, 5)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 5, 4)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 6, 9, 4)).astype(np.float32))
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    dx, dw = torch.autograd.grad(conv_train.conv3x3_train_plain(xr, wr), (
        xr, wr), g)
    # the tap-reversed conv (the kernel's flip, here its plain version)
    # and conv2d_input/conv2d_weight are other summation orders of the same
    # f32 products
    ones, zeros = torch.ones(5), torch.zeros(5)
    flipped = fused_conv.conv3x3_bn_relu(g, w, ones, zeros, relu=False,
                                         flip=True)
    for got, want in ((conv_train.conv3x3_dgrad(g, w), dx),
                      (conv_train.conv3x3_dgrad_plain(g, w), dx),
                      (conv_train.conv3x3_dgrad_library(g, w, x), dx),
                      (flipped, dx),
                      (conv_train.conv3x3_wgrad(x, g), dw),
                      (conv_train.conv3x3_wgrad_plain(x, g), dw)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert fused_conv.flipped(w).shape == (3, 3, 4, 5)


def test_wgrad_splits_and_checks():
    """The split-K factor and the checks the CUDA path runs first."""
    # stem at batch 24, 360x480: 27x64 outputs in one tile -> 8*132 splits
    assert conv_train.wgrad_splits(24 * 45 * 30, 1, 132) == 1056
    # 1024x1024 at 22x30: 32x16 output tiles -> 3 splits; never more
    # splits than pixel tiles
    assert conv_train.wgrad_splits(24 * 3 * 2, 512, 132) == 3
    assert conv_train.wgrad_splits(2, 1, 132) == 2
    xb = torch.zeros(1, 4, 5, 8, dtype=torch.bfloat16)
    gb = torch.zeros(1, 4, 5, 12, dtype=torch.bfloat16)
    conv_train._check_wgrad(xb, gb)
    with pytest.raises(TypeError):
        conv_train._check_wgrad(xb.float(), gb)
    with pytest.raises(ValueError, match="share"):
        conv_train._check_wgrad(xb, gb[:, :3])
    with pytest.raises(ValueError, match="contiguous"):
        conv_train._check_wgrad(xb.transpose(1, 2), gb.transpose(1, 2))
    with pytest.raises(ValueError, match="no kernel"):
        conv_train.conv3x3_wgrad(xb.to("meta"), gb.to("meta"))
    # the packed path's narrow tensor is read in 16-byte vectors
    shifted = torch.zeros(xb.numel() + 1, dtype=torch.bfloat16)[1:].view(
        xb.shape)
    with pytest.raises(ValueError, match="aligned"):
        conv_train._check_wgrad(shifted, gb)


# (2, 9, 15, 64, 12): the head's dx, Cin 12 into Cout 64 (the packed path
# on the card); (1, 7, 10, 64, 15): its K_MAX boundary, 9 x 15 = 135
@pytest.mark.parametrize("shape", [(2, 5, 7, 8, 12), (1, 9, 11, 16, 8),
                                   (1, 6, 10, 12, 16), (2, 9, 15, 64, 12),
                                   (1, 7, 10, 64, 15)],
                         ids=lambda s: "x".join(map(str, s)))
def test_dgrad_cpu_branch_matches_pallas_vjp_dx(shape):
    """conv3x3_dgrad on a CPU tensor (its plain version; on the card the
    kernel reads w tap-reversed in place, no weight copy) against the dx of
    JAX's ``_vjp_bwd``, its Pallas calls in interpret mode."""
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(sum(shape) + 1)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(
        np.float32)
    g = rng.normal(size=(n, h, w, cout)).astype(np.float32)
    want, _ = _interpret(lambda: jax_pct._vjp_bwd(
        (jnp.asarray(x), jnp.asarray(wt)), jnp.asarray(g)))
    got = conv_train.conv3x3_dgrad(torch.from_numpy(g), torch.from_numpy(wt))
    want = np.asarray(want)
    assert got.shape == want.shape == (n, h, w, cin)
    # f32 both sides: the 9*Cout products of each output in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


def test_wgrad_splits_of_the_wgmma_path():
    """One block of the wgmma dW kernel is resident per SM: the split-K
    rounds down to whole waves of two blocks per SM, at most one split per
    pixel tile."""
    # 64->64 at 360x480, batch 24: one 64x64 output tile -> 264 splits
    assert conv_train.wgrad_splits(24 * 45 * 30, 1, 132, "wgmma") == 264
    # 256->256: 16 tiles -> 16 splits (17 would leave a third wave idle)
    assert conv_train.wgrad_splits(24 * 12 * 8, 16, 132, "wgmma") == 16
    # 1024->512 and 1024->1024: 128 and 256 tiles -> 2 and 1
    assert conv_train.wgrad_splits(24 * 6 * 4, 128, 132, "wgmma") == 2
    assert conv_train.wgrad_splits(24 * 3 * 2, 256, 132, "wgmma") == 1
    assert conv_train.wgrad_splits(5, 1, 132, "wgmma") == 5


@pytest.mark.parametrize("net", ["unet", "segnet"])
def test_kernel_path_of_every_block_shape(net):
    """Every block of both models takes the wgmma path, forward, dx and
    dW, except the stem's forward (Cin 3) and the head's dx (Cin 12), which
    take the packed path, and the stem's and the head's dW, which take the
    dW kernel's packed path; the head's forward (64->12) takes the wgmma
    path's N = 16 tile."""
    shapes = bench.block_shapes(net)
    for i, (_, _, cin, cout) in enumerate(shapes):
        stem, head = i == 0, i == len(shapes) - 1
        assert (cin, cout) == ((3, 64) if stem else (64, 12) if head
                               else (cin, cout))
        assert fused_conv.conv_path(cin, cout) == ("packed" if stem
                                                   else "wgmma")
        assert fused_conv.conv_path(cout, cin) == ("packed" if head
                                                   else "wgmma")
        assert conv_train.wgrad_path(cin, cout) == ("packed" if stem or head
                                                    else "wgmma")


@pytest.mark.parametrize("net,blocks", [("unet", 23), ("segnet", 26)])
def test_step_launches_on_each_path(net, blocks):
    """A training step's K1 launches per path (chip_smoke holds the card's
    counters to these): UNet 22 of 23 forwards, 21 of 22 dx and 21 of 23 dW
    on the wgmma path, the stem's forward, the head's dx and both of their
    dW on the packed paths, nothing on the narrow ones; SegNet 25 of 26, 24
    of 25 and 24 of 26. At float32 every launch takes the f32 kernels."""
    got = conv_train.step_path_launches(bench.block_shapes(net))
    b = blocks
    assert got == {
        "fwd": {"wgmma": b - 1, "packed": 1, "narrow": 0, "f32": 0},
        "dgrad": {"wgmma": b - 2, "packed": 1, "narrow": 0, "f32": 0},
        "wgrad": {"wgmma": b - 2, "packed": 2, "narrow": 0, "f32": 0}}
    got = conv_train.step_path_launches(bench.block_shapes(net),
                                        torch.float32)
    assert got == {
        "fwd": {"wgmma": 0, "packed": 0, "narrow": 0, "f32": b},
        "dgrad": {"wgmma": 0, "packed": 0, "narrow": 0, "f32": b - 1},
        "wgrad": {"wgmma": 0, "packed": 0, "narrow": 0, "f32": b}}


def test_path_rules_at_edges():
    """The path rules at the shapes chip_smoke adds: a part chunk, a
    partial N tile, the head's N = 16 tile (up to Cin 128), channel counts
    TMA cannot describe: packed where Cin % 8 != 0 fits K_MAX = 9 * 16 and
    Cout % 8 == 0, narrow for the rest. dW: packed where one side is
    narrow (9 x its channels <= 144) and the other a multiple of 8 (the
    stem, 12->64, 3->24, the head), narrow where neither is a multiple of 8
    or the narrow side is too wide (64->20, 3->12)."""
    cp, wp = fused_conv.conv_path, conv_train.wgrad_path
    assert cp(48, 32) == cp(64, 24) == cp(64, 16) == cp(128, 12) == "wgmma"
    assert cp(1024, 512) == cp(32, 48) == "wgmma"
    assert cp(3, 64) == cp(12, 64) == cp(3, 24) == cp(1, 8) == "packed"
    assert cp(15, 64) == cp(12, 16) == cp(3, 16) == cp(5, 128) == "packed"
    assert cp(256, 12) == cp(64, 20) == cp(3, 12) == cp(12, 20) == "narrow"
    assert cp(17, 64) == cp(20, 64) == cp(3, 60) == "narrow"
    assert wp(48, 32) == wp(64, 24) == wp(1024, 1024) == "wgmma"
    assert wp(3, 64) == wp(12, 64) == wp(3, 24) == wp(64, 12) == "packed"
    assert wp(15, 64) == wp(64, 15) == wp(1, 8) == wp(128, 5) == "packed"
    assert wp(64, 20) == wp(3, 12) == wp(17, 64) == wp(64, 17) == "narrow"
    assert wp(12, 20) == wp(20, 12) == "narrow"


def test_cpu_route_is_plain_and_not_counted():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(1, 4, 6, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 5)).astype(np.float32))
    conv_train.reset_launches()
    y = conv_train.conv3x3_fwd(x, w)
    torch.testing.assert_close(y, conv_train.conv3x3_train_plain(x, w),
                               rtol=0, atol=0)
    conv_train.conv3x3_dgrad(y, w)
    conv_train.conv3x3_wgrad(x, y)
    assert conv_train.launches() == {"fwd": 0, "dgrad": 0, "wgrad": 0}
    assert conv_train.path_launches() == {
        "fwd": {"wgmma": 0, "packed": 0, "narrow": 0, "f32": 0},
        "dgrad": {"wgmma": 0, "packed": 0, "narrow": 0, "f32": 0},
        "wgrad": {"wgmma": 0, "packed": 0, "narrow": 0, "f32": 0}}


# every narrow width of the packed dW rule (9 x C <= 144, C % 8 != 0), on
# either side: the stem's x (C, 64) and the head's g (64, C)
PACKED_WGRAD = [(c, 64) for c in range(1, 16) if c % 8] + [
    (64, c) for c in range(1, 16) if c % 8]


@pytest.mark.parametrize("cin,cout", PACKED_WGRAD,
                         ids=lambda v: str(v))
def test_wgrad_packed_plan_fits_every_narrow_width(cin, cout):
    """The packed dW kernel's shared-memory plan fits one block (232,448 B)
    at every narrow width of its rule, and its blocks per SM fit an SM
    (233,472 B, 1,024 reserved a block); M packs the 9 taps x the narrow
    channels into whole 64-row tiles with less than one tile of pad."""
    plan = conv_train.wgrad_packed_plan(cin, cout)
    narrow = cin if cin % 8 else cout
    assert plan["narrow"] == narrow and plan["n"] == 64
    assert 9 * narrow <= plan["m"] < 9 * narrow + 64 and plan["m"] % 64 == 0
    assert plan["bytes"] <= conv_train.BLOCK_SMEM == 232448
    assert (plan["blocks_per_sm"] * (plan["bytes"] + 1024)
            <= conv_train.SM_SMEM == 233472)
    assert plan["blocks_per_sm"] == (1 if plan["m"] == 192 else 2)
    assert plan["stages"] in (3, 4)
    # one wide box and the 3 shifted copies + a zero plane of the patch;
    # four raw buffers of the patch's 10 rows, each row's 18 x narrow
    # elements at any alignment in whole 16-byte chunks
    assert plan["stage_bytes"] >= 16384 + (3 * narrow + 1) * 336
    assert plan["raw_bytes"] >= 4 * 10 * (18 * narrow * 2 + 14)
    assert plan["bytes"] >= (1024 + plan["stages"] * plan["stage_bytes"]
                             + plan["raw_bytes"])


def test_wgrad_packed_plan_is_the_sources():
    """wgrad_packed_plan's bytes are the figures the CUDA source asserts at
    compile time (``static_assert(smem_bytes(Cn) == bytes``), the stem's,
    the head's and the three-tile width's; off the packed path it
    raises."""
    src = conv_train.WGRAD_SOURCE.read_text()
    held = re.findall(r"static_assert\(smem_bytes\((\d+)\) == (\d+)", src)
    assert [int(c) for c, _ in held] == [3, 12, 15]
    for cn, nbytes in held:
        assert conv_train.wgrad_packed_plan(int(cn), 64)["bytes"] == int(
            nbytes)
        assert conv_train.wgrad_packed_plan(64, int(cn))["bytes"] == int(
            nbytes)
    for cin, cout in ((64, 64), (64, 20), (3, 12)):
        with pytest.raises(ValueError, match="packed"):
            conv_train.wgrad_packed_plan(cin, cout)


def test_wgrad_splits_of_the_packed_path():
    """Two packed dW blocks are resident per SM: the split-K fills one
    whole wave of them over the wide side's 64-channel tiles, at most one
    split per pixel tile."""
    # the stem and the head at 360x480, batch 24: one wide tile -> 264
    assert conv_train.wgrad_splits(24 * 45 * 30, 1, 132, "packed") == 264
    # 5->128: two wide tiles -> 132; 3 pixel tiles -> 3
    assert conv_train.wgrad_splits(24 * 45 * 30, 2, 132, "packed") == 132
    assert conv_train.wgrad_splits(3, 1, 132, "packed") == 3


def _block_and_params(cin, cout, seed):
    rng = np.random.default_rng(seed)
    p = {"w": rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin),
         "b": rng.normal(scale=0.1, size=cout),
         "scale": rng.uniform(0.5, 1.5, cout),
         "bias": rng.normal(scale=0.1, size=cout)}
    s = {"mean": rng.normal(scale=0.1, size=cout),
         "var": rng.uniform(0.5, 2.0, cout)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    s = {k: v.astype(np.float32) for k, v in s.items()}
    blk = ConvBNReLU(cin, cout).train()
    conv, bn = blk.conv[0], blk.conv[1]
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(p["w"].transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.from_numpy(p["b"]))
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(s["mean"]))
        bn.running_var.copy_(torch.from_numpy(s["var"]))
    return blk, p, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_block_matches_jax_pallas_block(dtype):
    """ConvBNReLU in train mode against conv_bn_relu_apply(train=True,
    use_pallas=True): output, running stats, and the gradients of the
    input and of all four parameters."""
    n, h, w, cin, cout = 2, 7, 9, 8, 12
    blk, p, s = _block_and_params(cin, cout, seed=5)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    t = rng.normal(size=(n, h, w, cout)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def loss(params, x):
        y, ns = conv_bn_relu_apply(params, s, x, train=True,
                                   compute_dtype=jdt, use_pallas=True)
        return jnp.sum(y.astype(jnp.float32) * t), (y, ns)

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    (_, (want, want_s)), (gp, gx) = _interpret(lambda: jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x).astype(jdt)))

    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    got = blk(xt)
    conv, bn = blk.conv[0], blk.conv[1]
    grads = torch.autograd.grad((got.float() * torch.from_numpy(t)).sum(),
                                (xt, conv.weight, conv.bias, bn.weight,
                                 bn.bias))
    assert got.dtype == tdt
    # f32: summation order only. bf16: the conv output is rounded to bf16
    # on both sides, and a one-ulp difference there (2^-8 relative) moves
    # the normalized output by up to ~1e-2 of its scale
    tol = 2e-5 if dtype == "float32" else 2e-2

    def close(a, b, what, scale=None):
        a = a.detach().float().numpy()
        b = np.asarray(jnp.asarray(b, jnp.float32))
        sc = np.abs(b).max() if scale is None else scale
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * sc,
                                   err_msg=what)

    close(got, want, "output")
    close(bn.running_mean, want_s["mean"], "running mean")
    close(bn.running_var, want_s["var"], "running var")
    close(grads[0], gx, "dx")
    close(grads[1].permute(2, 3, 1, 0), gp["w"], "dW")
    # the conv bias feeds train-mode BN, so its exact gradient is zero and
    # both sides hold rounding noise: held at the scale of dW
    close(grads[2], gp["b"], "db", scale=np.abs(np.asarray(
        gp["w"], np.float32)).max())
    close(grads[3], gp["scale"], "dscale")
    close(grads[4], gp["bias"], "dbias")


def test_max_pool_tie_gradient_goes_to_first_element_like_jax():
    """With ties in a 2x2 window, torch's max_pool2d backward and JAX's
    reduce_window-max VJP both credit the first maximal element in
    row-major window order (top-left, then top-right, bottom-left) and
    give the others zero, in bf16 as in f32."""
    for dt in (np.float32, jnp.bfloat16):
        x = np.array([[1, 1, 2, 0, 5],
                      [1, 1, 2, 2, 5],
                      [0, 3, 4, 4, 5],
                      [3, 3, 4, 1, 5],
                      [7, 7, 7, 7, 7]], np.float32)
        x = np.broadcast_to(x[None, :, :, None], (1, 5, 5, 2)).astype(dt)
        g = np.arange(1, 9, dtype=np.float32).reshape(1, 2, 2, 2).astype(dt)
        _, vjp = jax.vjp(jax_pool, jnp.asarray(x))
        want = np.asarray(vjp(jnp.asarray(g))[0]).astype(np.float32)
        xt = torch.from_numpy(np.asarray(x, np.float32)).to(
            torch.float32 if dt is np.float32 else torch.bfloat16)
        xt.requires_grad_()
        yt = max_pool_2x2(xt)
        (got,) = torch.autograd.grad(yt, xt, torch.from_numpy(
            np.asarray(g, np.float32)).to(xt.dtype))
        np.testing.assert_array_equal(got.float().numpy(), want)
        # window (0,0) is all ones: only its top-left gets the gradient
        assert want[0, 0, 0, 0] == 1 and want[0, 0:2, 0:2, 0].sum() == 1
        # window (1,0) = [[0, 3], [3, 3]]: its top-right 3 comes first
        assert want[0, 2, 1, 0] == 5 and want[0, 3, 0:2, 0].sum() == 0


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cpu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_path_table_and_edge_shapes():
    """chip_smoke's per-path launch table is the rules' count of a step
    (it holds the card's counters to it), and its edge shapes put every
    forward path on the card, the packed one also past 2**31 output
    elements."""
    smoke = _chip_smoke()
    for net in ("unet", "segnet"):
        assert smoke.PATH_TABLE[net] == conv_train.step_path_launches(
            bench.block_shapes(net, smoke.HW))
        assert smoke.path_counts(net, 3)["fwd"] == {
            p: 3 * k for p, k in smoke.PATH_TABLE[net]["fwd"].items()}
    paths = {}
    for n, h, w, cin, cout in smoke.EDGE_SHAPES:
        paths.setdefault(fused_conv.conv_path(cin, cout), []).append(
            n * h * w * cout)
    assert set(paths) == {"wgmma", "packed", "narrow"}
    assert max(paths["packed"]) >= 2 ** 31
    dx = {fused_conv.conv_path(cout, cin)
          for *_, cin, cout in smoke.EDGE_SHAPES}
    assert "packed" in dx
    # dW at every path, the packed one past 2**31 elements of g
    wgrad = {}
    for n, h, w, cin, cout in smoke.EDGE_SHAPES:
        wgrad.setdefault(conv_train.wgrad_path(cin, cout), []).append(
            n * h * w * max(cin, cout))
    assert set(wgrad) == {"wgmma", "packed", "narrow"}
    assert max(wgrad["packed"]) >= 2 ** 31


@pytest.mark.parametrize("net", ["unet", "segnet"])
@pytest.mark.parametrize("classes", [12, 21])
def test_chip_smoke_path_table_by_class_count(net, classes):
    """chip_smoke's table for a ``classes``-class head is the rules' count
    over that model's blocks: CamVid's 12 put the head's forward on the
    wgmma path and its dx and dW on the packed ones, VOC's 21 all three on
    the narrow ones."""
    smoke = _chip_smoke()
    spec = bench.model_class(net).base_spec(3, classes)
    shapes = bench.block_shapes(net, smoke.HW, spec)
    assert len(shapes) == smoke.N_BLOCKS[net]
    assert smoke.path_table(net, classes) == \
        conv_train.step_path_launches(shapes)
    head = shapes[-1][2:]
    assert smoke.HEAD_PATHS[classes] == {
        "fwd": fused_conv.conv_path(*head),
        "dgrad": fused_conv.conv_path(*head[::-1]),
        "wgrad": conv_train.wgrad_path(*head)}
    assert smoke.path_counts(net, 2, classes)["wgrad"] == {
        p: 2 * k for p, k in smoke.path_table(net, classes)["wgrad"].items()}


@pytest.mark.parametrize("name", sorted(dw_variants.VARIANTS))
def test_dw_variant_edits_apply_to_the_source(name):
    """Each variant of the packed dW that dw_variants.py times is an edit
    that still applies to the kernel's source, and changes it (but
    "kept"); the split-K runs name a built variant."""
    src = dw_variants._edited(dw_variants.VARIANTS[name])
    assert (src == conv_train.WGRAD_SOURCE.read_text()) == (name == "kept")
    assert all(s in dw_variants.VARIANTS
               for s, _ in dw_variants.SPLIT_RUNS.values())


def test_dw_variants_without_a_card_fails(capsys):
    assert dw_variants.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
