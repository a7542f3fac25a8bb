"""The port's shallow conv (pytorch_camvid_tpu_torch/ops/fused_conv_pair.py,
K5) against the JAX package's H-pair kernel (ops/pallas_conv_pair.py) in
Pallas interpret mode, on the inputs of tests/test_pallas_conv_pair.py.

On the CPU the port's wrapper runs its plain version (the CUDA kernel is
held against that plain version on the card by chip_smoke.py). Inputs come
from numpy with fixed seeds and go to both packages."""

import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pytorch_camvid_tpu.ops import pallas_conv_pair as jax_pair
from pytorch_camvid_tpu_torch import k5_variants
from pytorch_camvid_tpu_torch.ops import fused_conv_pair


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("n,h,w,c,co,seed", [(2, 12, 30, 8, 8, 1),
                                             (1, 8, 15, 16, 8, 2),
                                             (2, 20, 24, 8, 16, 3),
                                             (2, 10, 13, 16, 16, 4),
                                             (1, 6, 11, 80, 48, 5)])
def test_pair_conv_matches_jax_f32(n, h, w, c, co, seed):
    x = _rand((n, h, w, c), seed)
    wt = _rand((3, 3, c, co), seed + 10, 0.1)
    b = _rand((co,), seed + 20)
    want = np.asarray(jax_pair.conv3x3_pair(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), interpret=True))
    got = fused_conv_pair.conv3x3_pair(torch.from_numpy(x),
                                       torch.from_numpy(wt),
                                       torch.from_numpy(b))
    assert got.shape == want.shape and got.dtype == torch.float32
    # f32 both sides; only the summation order differs (JAX's own limit)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("relu", [True, False])
def test_pair_conv_fused_affine_matches_jax(relu):
    n, h, w, c, co = 1, 10, 17, 8, 8
    x, wt = _rand((n, h, w, c), 4), _rand((3, 3, c, co), 5, 0.1)
    a, b = _rand((co,), 6), _rand((co,), 7)
    want = np.asarray(jax_pair.conv3x3_pair_bn_relu(
        *(jnp.asarray(t) for t in (x, wt, a, b)), interpret=True, relu=relu))
    got = fused_conv_pair.conv3x3_pair_bn_relu(
        *(torch.from_numpy(t) for t in (x, wt, a, b)), relu=relu)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)
    if relu:
        assert got.min() >= 0


def test_pair_conv_bf16_matches_jax():
    """bf16 at 2x60x60 64->64, the JAX test's scaled-down production shape.
    JAX accumulates in f32 and rounds once; the plain version's bf16 conv
    rounds before its f32 epilogue: two bf16 roundings (2**-8 each) of the
    output's scale, held at 3e-2 of max|ref| (JAX's own bf16 limit)."""
    n, h, w, c, co = 2, 60, 60, 64, 64
    x = jnp.asarray(_rand((n, h, w, c), 8)).astype(jnp.bfloat16)
    wt = jnp.asarray(_rand((3, 3, c, co), 9, 0.05)).astype(jnp.bfloat16)
    b = _rand((co,), 10)
    want = np.asarray(jax_pair.conv3x3_pair(x, wt, jnp.asarray(b),
                                            interpret=True), np.float32)
    got = fused_conv_pair.conv3x3_pair(
        torch.from_numpy(np.asarray(x, np.float32)).bfloat16(),
        torch.from_numpy(np.asarray(wt, np.float32)).bfloat16(),
        torch.from_numpy(b))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 3e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("fn", ["conv3x3_pair_bn_relu", "conv3x3_pair"])
def test_odd_h_raises(fn):
    x = torch.zeros(1, 7, 8, 16)
    w = torch.zeros(3, 3, 16, 16)
    args = (torch.ones(16), torch.zeros(16)) if fn != "conv3x3_pair" else (
        torch.zeros(16),)
    with pytest.raises(ValueError, match="even H"):
        getattr(fused_conv_pair, fn)(x, w, *args)


def test_meta_tensor_raises():
    x, w = torch.zeros(1, 8, 8, 16), torch.zeros(3, 3, 16, 16)
    a, b = torch.ones(16), torch.zeros(16)
    with pytest.raises(ValueError, match="no kernel"):
        fused_conv_pair.conv3x3_pair_bn_relu(
            *(t.to("meta") for t in (x, w, a, b)))


def test_cpu_route_is_plain_and_not_counted():
    rng = np.random.default_rng(11)
    x, w = rng.normal(size=(1, 6, 9, 16)), rng.normal(size=(3, 3, 16, 32))
    a, b = rng.uniform(0.5, 1.5, 32), rng.normal(size=32)
    x, w, a, b = (torch.from_numpy(t.astype(np.float32)) for t in (x, w, a, b))
    before = fused_conv_pair.conv3x3_pair_bn_relu.launches
    got = fused_conv_pair.conv3x3_pair_bn_relu(x, w, a, b)
    want = fused_conv_pair.conv3x3_pair_bn_relu_plain(x, w, a, b)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fused_conv_pair.conv3x3_pair_bn_relu.launches == before


def test_kernel_checks_reject_what_the_kernel_does_not_take():
    """The validation the CUDA path runs before every launch."""
    def inputs(cin=64, cout=64):
        return (torch.zeros(1, 8, 12, cin, dtype=torch.bfloat16),
                torch.zeros(3, 3, cin, cout, dtype=torch.bfloat16),
                torch.ones(cout), torch.zeros(cout))
    for cin, cout in ((64, 64), (128, 64), (48, 32), (16, 16)):
        fused_conv_pair._check(*inputs(cin, cout))   # accepted
    x, w, a, b = inputs()
    with pytest.raises(TypeError):
        fused_conv_pair._check(x.float(), w, a, b)
    with pytest.raises(TypeError):
        fused_conv_pair._check(x, w, a.double(), b)
    for cin, cout in ((8, 64), (144, 64), (24, 64), (64, 80), (64, 12)):
        with pytest.raises(ValueError, match="multiple of 16"):
            fused_conv_pair._check(*inputs(cin, cout))
    with pytest.raises(ValueError, match="HWIO"):
        fused_conv_pair._check(x, w.permute(3, 2, 0, 1), a, b)
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv_pair._check(x.permute(0, 2, 1, 3), w, a, b)
    # a contiguous view 2 bytes into its storage: not 16-byte aligned
    shifted = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:].view(
        x.shape)
    with pytest.raises(ValueError, match="aligned"):
        fused_conv_pair._check(shifted, w, a, b)


@pytest.mark.parametrize("cin", range(16, fused_conv_pair.MAX_CIN + 1, 16))
def test_tile_plan_fits_a_block_at_every_cin(cin):
    """The kernel's shared-memory plan fits one Hopper block at every Cin
    of the contract: two patch stages per consumer warpgroup, 32 channels
    each up to Cin 64 and 16 above, beside all of the resident weights."""
    plan = fused_conv_pair.tile_plan(cin)
    assert plan["bytes"] <= fused_conv_pair.SMEM_LIMIT == 232448
    assert plan["kc"] == (32 if cin <= 64 else 16) and plan["stages"] == 4
    weights = -(-cin // 64) * 9 * 64 * 64 * 2
    assert plan["bytes"] > weights + plan["stages"] * 6 * 66 * plan["kc"] * 2


def test_tile_plan_is_the_sources():
    """tile_plan's bytes are the figures the CUDA source asserts at compile
    time (``static_assert(smem_bytes<KC>(Cin) == bytes``)."""
    src = fused_conv_pair.SOURCE.read_text()
    held = re.findall(r"static_assert\(smem_bytes<(\d+)>\((\d+)\) == (\d+)",
                      src)
    assert len(held) == 2
    for kc, cin, nbytes in held:
        plan = fused_conv_pair.tile_plan(int(cin))
        assert (plan["kc"], plan["bytes"]) == (int(kc), int(nbytes))


@pytest.mark.parametrize("name", sorted(k5_variants.VARIANTS))
def test_k5_variant_edits_apply_to_the_source(name):
    """Each design variant that k5_variants.py times is an edit that still
    applies to the kernel's source, and changes it (but "kept")."""
    src = k5_variants._edited(k5_variants.VARIANTS[name])
    assert (src == fused_conv_pair.SOURCE.read_text()) == (name == "kept")


def test_k5_variants_without_a_card_fails(capsys):
    assert k5_variants.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def _f32_inputs(cin=64, cout=64, h=8):
    return (torch.zeros(1, h, 12, cin), torch.zeros(3, 3, cin, cout),
            torch.ones(cout), torch.zeros(cout))


@pytest.mark.parametrize("cin,cout", [(4, 4), (8, 8), (16, 8), (8, 16),
                                      (64, 64), (128, 64), (80, 48),
                                      (48, 32), (68, 60)])
def test_f32_kernel_checks_take_its_contract(cin, cout):
    """K5's f32 instance takes f32 x, w, a and b with Cin and Cout
    multiples of 4 (TMA's 16-byte rows of f32), Cin <= 128, Cout <= 64:
    JAX's test shapes, the port's and shallow64's."""
    fused_conv_pair._check(*_f32_inputs(cin, cout))


def test_f32_kernel_checks_reject_what_it_does_not_take():
    """Outside the f32 contract the CUDA route raises (it never falls back
    to K4 or to the plain version): Cin 6, Cout 72, Cin 132, odd H, f32 x
    with bf16 w, f64."""
    for cin, cout in ((6, 64), (64, 72), (132, 64), (64, 6), (2, 64)):
        with pytest.raises(ValueError, match="multiple of 4"):
            fused_conv_pair._check(*_f32_inputs(cin, cout))
    with pytest.raises(ValueError, match="even H"):
        fused_conv_pair._check_even_h(_f32_inputs(h=7)[0])
    x, w, a, b = _f32_inputs()
    with pytest.raises(TypeError, match="one dtype"):
        fused_conv_pair._check(x, w.bfloat16(), a, b)
    with pytest.raises(TypeError, match="one dtype"):
        fused_conv_pair._check(x.double(), w.double(), a, b)
    with pytest.raises(TypeError, match="f32 a and b"):
        fused_conv_pair._check(x, w, a.bfloat16(), b)
    shifted = torch.zeros(x.numel() + 1)[1:].view(x.shape)
    with pytest.raises(ValueError, match="aligned"):
        fused_conv_pair._check(shifted, w, a, b)


@pytest.mark.parametrize("cout", range(4, fused_conv_pair.MAX_COUT + 1, 4))
def test_f32_tile_plan_fits_a_block_at_every_cout(cout):
    """The f32 plan fits one Hopper block at every Cout of its contract
    (at any Cin: the weights stream): all of Cout in one tile N of 16, 32
    or 64 channels, two patch stages of 6 x 66 pixels x 32 channels and
    two weight stages of three taps, hi and lo."""
    plan = fused_conv_pair.tile_plan(128, torch.float32, cout)
    assert plan["bytes"] <= fused_conv_pair.SMEM_LIMIT
    assert plan["bn"] >= cout and plan["bn"] in (16, 32, 64)
    assert plan["kc"] == 32 and plan["stages"] == 2
    assert plan == fused_conv_pair.tile_plan(4, torch.float32, cout)
    weights = 2 * 3 * 2 * plan["bn"] * 32 * 4
    assert plan["bytes"] > weights + 2 * 6 * 66 * 32 * 4


def test_f32_tile_plan_is_the_sources():
    """tile_plan's f32 bytes are the figures the CUDA source asserts at
    compile time (``static_assert(Plan<BN>::SMEM == bytes``, the k5
    namespace of conv3x3_f32.cu), at each tile N."""
    src = fused_conv_pair.F32_SOURCE.read_text()
    held = re.findall(r"static_assert\(Plan<(\d+)>::SMEM == (\d+), "
                      r"\"f32 pair plan", src)
    assert sorted(int(bn) for bn, _ in held) == [16, 32, 64]
    for bn, nbytes in held:
        plan = fused_conv_pair.tile_plan(64, torch.float32, int(bn))
        assert (plan["bn"], plan["bytes"]) == (int(bn), int(nbytes))


def test_probe_shape_f32_pair_row_on_cpu():
    """``probe_shape(pair=True, dtype=torch.float32)``, as the JAX tool's
    ``dtype=``: its roofline counts 4 bytes an element and the split
    product's rate (a third of the H100's TF32 peak, 164.9 TFLOP/s); on
    the CPU no kernel is launched."""
    from pytorch_camvid_tpu_torch import bench, perf_probe
    before = fused_conv_pair.conv3x3_pair_bn_relu.launches
    row = perf_probe.probe_shape(2, 6, 10, 16, 32, k=1, pair=True,
                                 device="cpu", dtype=torch.float32)
    assert (row["impl"], row["dtype"], row["mode"]) == ("pair", "float32",
                                                        "fwd")
    flops = 2.0 * 9 * 2 * 6 * 10 * 16 * 32
    nbytes = 4 * (2 * 6 * 10 * (16 + 32) + 9 * 16 * 32)
    peak = bench.H100_TF32_PEAK / 3 / 1e12
    assert peak == pytest.approx(164.9)
    assert row["roofline_tflops"] == pytest.approx(
        min(peak, flops / nbytes * 3350.0 / 1000.0))
    big = perf_probe.roofline_tflops(24, 360, 480, 64, 64, 4, peak)
    assert big[0] == pytest.approx(peak)   # shallow64 is bound by the FLOPs
    assert fused_conv_pair.conv3x3_pair_bn_relu.launches == before
