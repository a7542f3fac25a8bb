"""The f32 kernels' plan on the CPU: the weight split of the wgmma forward
(``fused_conv.split_weights_plain``, the plain version of the .cu's
``split_weights_kernel``) against a numpy emulation of ``cvt.rna``, the
routes, N tiles, shared-memory plans and split-K of both f32 kernels held
to csrc/conv3x3_f32.cu's constants and ``static_assert``s, and the route
of every UNet, SegNet and VOC block at float32 against chip_smoke's
launch table."""

import importlib.util
import re

import numpy as np
import pytest
import torch

from pytorch_camvid_tpu_torch import bench
from pytorch_camvid_tpu_torch.ops import conv_train, cuda_build, fused_conv

SRC = (cuda_build.CSRC / "conv3x3_f32.cu").read_text()


def rna(v: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` on a uint32 view: the magnitude rounded to 10
    mantissa bits, ties away from zero."""
    u = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _weights(cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(3, 3, cin, cout)).astype(np.float32) * np.exp2(
        rng.integers(-20, 20, size=(3, 3, cin, cout))).astype(np.float32)


@pytest.mark.parametrize("cin,cout,flip", [(64, 12, False), (12, 64, True),
                                           (32, 24, False), (8, 8, True)])
def test_split_weights_plain_is_rna_split_k_major(cin, cout, flip):
    """(2, Cout, 9, Cin): hi = rna(v), lo = rna(v - hi) bit for bit
    against the numpy emulation, with the K-major layout [n][t][c] of w
    (3,3,Cin,Cout) or, with flip, of the tap-reversed transpose of w
    (3,3,Cout,Cin); hi and lo keep no bit below TF32's 10 mantissa bits,
    and hi + lo is v within 2^-22 of |v|."""
    w = _weights(cin, cout) if not flip else _weights(cout, cin)
    got = fused_conv.split_weights_plain(torch.from_numpy(w), flip).numpy()
    assert got.shape == (2, cout, 9, cin)
    if flip:   # B[(t, c)][n] = w[8 - t][n][c]
        v = w[::-1, ::-1].reshape(9, cout, cin).transpose(1, 0, 2)
    else:      # B[(t, c)][n] = w[t][c][n]
        v = w.reshape(9, cin, cout).transpose(2, 0, 1)
    v = np.ascontiguousarray(v)
    hi = rna(v)
    lo = rna(v - hi)
    assert np.array_equal(got[0].view(np.uint32), hi.view(np.uint32))
    assert np.array_equal(got[1].view(np.uint32), lo.view(np.uint32))
    assert not (got.view(np.uint32) & 0x1FFF).any()
    err = np.abs(got[0].astype(np.float64) + got[1] - v)
    assert (err <= 2.0 ** -22 * np.abs(v)).all()


def test_split_weights_flip_is_the_split_of_the_flipped_weights():
    """flip reads w (3,3,Cout,Cin) as ``fused_conv.flipped(w)``, the
    (3,3,Cin,Cout) weight of the conv it computes."""
    w = torch.from_numpy(_weights(24, 40, seed=3))
    assert torch.equal(fused_conv.split_weights_plain(w, flip=True),
                       fused_conv.split_weights_plain(
                           fused_conv.flipped(w).contiguous()))


def test_tf32_rna_bits_ties_away_from_zero():
    """At bit 13 a tie rounds away from zero, above it up, below it down;
    zeros and exact TF32 values pass through."""
    ulp = 2.0 ** -10   # TF32's at 1
    v = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + ulp / 2 + 2 ** -23, 0.0, -0.0, 3.0, 1 + ulp],
                     dtype=torch.float32)
    got = fused_conv.tf32_rna_bits(v)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 0.0, -0.0, 3.0,
                         1 + ulp], dtype=torch.float32)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=4096).astype(
        np.float32))
    assert np.array_equal(fused_conv.tf32_rna_bits(x).numpy(), rna(x.numpy()))


def _asserted(ns: str) -> dict:
    """{N: bytes} of the ``static_assert(Plan<N>::SMEM == bytes`` lines of
    namespace ``ns`` of the source."""
    part = SRC[SRC.index(f"namespace {ns} {{"):]
    part = part[:part.index(f"}}  // namespace {ns}")]
    return {int(n): int(b) for n, b in re.findall(
        r"static_assert\(Plan<(\d+)>::SMEM == (\d+)", part)}


def test_f32_forward_tile_n_and_plan_match_the_source():
    """The forward's N tile by Cout (16 for the 12-class head, 24 for VOC's
    21, 64, else 128) is the .cu's rule, and each N tile's shared-memory
    plan is the one its static_asserts hold, within a block's 232,448 B."""
    tile_n = fused_conv.f32_tile_n
    assert [tile_n(c) for c in (12, 16, 21, 24, 32, 64, 128, 512, 1024)] \
        == [16, 16, 24, 24, 64, 64, 128, 128, 128]
    rule = re.search(r"inline int tile_n\(int Cout\) \{\s*return ([^;]+);",
                     SRC[SRC.index("namespace fw {"):]).group(1)
    assert rule == ("Cout <= 16 ? 16 : Cout <= 24 ? 24 : Cout <= 64 ? 64 "
                    ": MAX_TILE_N")
    assert re.search(r"constexpr int MAX_TILE_N = 128;", SRC)
    plans = _asserted("fw")
    assert sorted(plans) == [16, 24, 64, 128]
    for bn, nbytes in plans.items():
        plan = fused_conv.f32_fwd_plan(bn)
        assert plan["bytes"] == nbytes <= conv_train.BLOCK_SMEM
        assert plan["patch_bytes"] % 1024 == 0
        assert plan["w_stage_bytes"] % 1024 == 0   # 128-byte swizzle bases


def test_f32_wgrad_tile_n_and_plan_match_the_source():
    """The dW's N tile (16 at Cout <= 16, else 64) and its shared-memory
    plan at each N are the .cu's, within a block's 232,448 B; one block
    an SM, so its three consumer warpgroups and the producer's 512
    threads hold 128 registers each."""
    assert [conv_train.wgrad_f32_tile_n(c) for c in (12, 16, 24, 64, 512)] \
        == [16, 16, 64, 64, 64]
    assert re.search(r"inline int tile_n\(int Cout\) \{ return Cout <= 16 "
                     r"\? 16 : 64; \}", SRC[SRC.index("namespace wgf {"):])
    plans = _asserted("wgf")
    assert sorted(plans) == [16, 64]
    for bn, nbytes in plans.items():
        plan = conv_train.wgrad_f32_plan(bn)
        assert plan["n"] == bn and plan["bytes"] == nbytes
        assert 2 * (plan["bytes"] + 1024) > conv_train.SM_SMEM or bn == 16
        assert plan["bytes"] <= conv_train.BLOCK_SMEM


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_f32_plan", cuda_build._PKG.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("net", ["unet", "segnet"])
@pytest.mark.parametrize("classes", [12, 21, 23, 150])
def test_f32_route_of_every_block(net, classes):
    """At float32 the stem's forward and dW (Cin 3) take the packed route,
    every body block's three pieces the wgmma one; the head's by its class
    count: 12 (CamVid) all three on wgmma (the forward's N tile 16, the
    dx's Cin 12, the dW's N tile 16), 21 (VOC) its forward on wgmma (N
    tile 24), its dx (Cin 21) and dW (Cout 21) on the packed route; 23 and
    150 all three on wgmma, the dx and dW over one padded copy of g a
    step. The count is chip_smoke's f32 launch table."""
    shapes = bench.block_shapes(net, spec=bench.model_class(net).base_spec(
        3, classes))
    f32 = torch.float32
    for i, (_, _, cin, cout) in enumerate(shapes):
        stem, head = i == 0, i == len(shapes) - 1
        want = "f32_packed" if stem else "f32"
        assert fused_conv.route(f32, cin, cout) == want
        assert conv_train.wgrad_route(f32, cin, cout) == (
            "f32_packed" if stem or (head and classes == 21) else "f32")
        if not stem:
            assert fused_conv.route(f32, cout, cin) == (
                "f32_packed" if head and classes == 21 else "f32")
    head = shapes[-1][2:]
    assert fused_conv.f32_tile_n(head[1]) == {12: 16, 21: 24, 23: 24,
                                              150: 128}[classes]
    assert conv_train.step_pad_copies(shapes) == int(classes in (23, 150))
    smoke = _chip_smoke()
    assert smoke.path_table(net, classes, f32) == \
        conv_train.step_path_launches(shapes, f32)
    assert sum(smoke.path_table(net, classes, f32)["wgrad"].values()) == \
        len(shapes)


@pytest.mark.parametrize("net", ["unet", "segnet"])
@pytest.mark.parametrize("batch", [2, 10, 24])
def test_wgrad_f32_splits_fill_waves_at_every_block(net, batch):
    """On both routes the dW's splits, at most one a pixel tile, leave the
    last wave of blocks (one an SM, 132 SMs) at least 90% full, or run one
    split a pixel tile; so at a 150-class head and at UNet 5/64's
    odd-width blocks (both sides narrow: the packed route, one side
    padded)."""
    shapes = bench.block_shapes(net) + [(360, 480, 64, 150)]
    shapes += bench.block_shapes(net, spec=importlib.import_module(
        f"pytorch_camvid_tpu_torch.models.{net}").scaled_spec(3, 12, 5 / 64))
    for h, w, cin, cout in shapes:
        s = conv_train.wgrad_f32_splits(batch, h, w, cin, cout, 132)
        blocks = conv_train.wgrad_f32_out_tiles(cin, cout)
        tiles = conv_train.wgrad_f32_pixel_tiles(batch, h, w)
        assert 1 <= s <= tiles
        last = s * blocks % 132
        waves = 1 if conv_train.wgrad_f32_route(cin, cout) == "f32_packed" \
            else 2
        assert last == 0 or last >= 0.9 * 132 or s == tiles or \
            s == max(1, waves * 132 // blocks), (h, w, cin, cout, s)
