"""The port's fused conv3x3+BN+ReLU (pytorch_camvid_tpu_torch/ops/
fused_conv.py) against the JAX package's Pallas kernel in interpret mode.

On the CPU the port's wrapper runs its plain version (the CUDA kernel is
checked against that plain version on the card by chip_smoke.py). Inputs
come from numpy with a fixed seed and go to both packages in f32."""

import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pytorch_camvid_tpu.ops import pallas_conv as jax_pc
from pytorch_camvid_tpu_torch import head_variants
from pytorch_camvid_tpu_torch.ops import fused_conv


def _inputs(n, h, w, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)
          ).astype(np.float32)
    a = rng.uniform(0.5, 1.5, size=cout).astype(np.float32)
    b = rng.normal(scale=0.1, size=cout).astype(np.float32)
    return x, wt, a, b


# (2, 9, 15, 3, 64): the stem (the packed path on the card), ragged;
# (1, 7, 33, 15, 16): the packed path at 9 x 15 = 135 over two 32-column
# tiles; (1, 6, 9, 64, 20): the wgmma head tile at N = 24, a partial
# tile; (1, 9, 11, 64, 21): VOC's 64->21 head, the same tile
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(1, 8, 12, 3, 16), (2, 9, 15, 16, 12),
                                   (1, 7, 10, 32, 32), (2, 9, 15, 3, 64),
                                   (1, 7, 33, 15, 16), (1, 6, 9, 64, 20),
                                   (1, 9, 11, 64, 21)])
def test_conv3x3_bn_relu_matches_pallas_interpret(shape, relu):
    x, wt, a, b = _inputs(*shape)
    want = np.asarray(jax_pc.conv3x3_bn_relu_pallas(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(a), jnp.asarray(b),
        interpret=True, relu=relu))
    got = fused_conv.conv3x3_bn_relu(
        torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(a),
        torch.from_numpy(b), relu=relu)
    assert got.shape == want.shape and got.dtype == torch.float32
    # f32 both sides; only the summation order of the 9*Cin products
    # differs, a few ulps of the O(1) outputs
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if relu:
        assert got.min() >= 0


# (2, 9, 15, 12, 64): the head's dx, Cin 12 into Cout 64 (the packed path);
# (2, 9, 15, 21, 64): VOC's head's dx, Cin 21 (the packed path at K = 189)
@pytest.mark.parametrize("shape", [(1, 8, 12, 16, 24), (2, 9, 15, 12, 16),
                                   (2, 9, 15, 12, 64), (2, 9, 15, 21, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_flip_matches_pallas_on_the_reversed_weights(shape):
    """``flip=True`` (the training conv's dx: taps reversed, channel axes
    swapped, read in place on the card) against JAX's kernel on the
    reversed weights that JAX's VJP builds (pallas_conv_train.py:_vjp_bwd)."""
    n, h, w, cin, cout = shape
    x, wt, a, b = _inputs(n, h, w, cin, cout, seed=2)
    w_fwd = np.ascontiguousarray(wt.transpose(0, 1, 3, 2))  # (3,3,Cout,Cin)
    w_flip = np.transpose(w_fwd[::-1, ::-1], (0, 1, 3, 2))
    want = np.asarray(jax_pc.conv3x3_bn_relu_pallas(
        jnp.asarray(x), jnp.asarray(w_flip), jnp.asarray(a), jnp.asarray(b),
        interpret=True, relu=False))
    got = fused_conv.conv3x3_bn_relu(
        torch.from_numpy(x), torch.from_numpy(w_fwd), torch.from_numpy(a),
        torch.from_numpy(b), relu=False, flip=True)
    assert got.shape == want.shape == (n, h, w, cout)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fold_bn_affine_matches_jax():
    rng = np.random.default_rng(1)
    c = 24
    params = {"b": rng.normal(size=c), "scale": rng.uniform(0.5, 2, c),
              "bias": rng.normal(size=c)}
    state = {"mean": rng.normal(size=c), "var": rng.uniform(0.1, 3, c)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    want_a, want_b = jax_pc.fold_bn_affine(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in state.items()})
    got_a, got_b = fused_conv.fold_bn_affine(
        *(torch.from_numpy(d[k]) for d, k in (
            (params, "b"), (params, "scale"), (params, "bias"),
            (state, "mean"), (state, "var"))))
    assert got_a.dtype == got_b.dtype == torch.float32
    # f32 rsqrt on both sides: XLA's and torch's may differ by an ulp
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-6)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-6,
                               atol=1e-6)


def test_kernel_checks_reject_wrong_dtype_and_layout():
    """The validation the CUDA path runs before every launch."""
    x, wt, a, b = (torch.from_numpy(t) for t in _inputs(1, 6, 8, 16, 8))
    xb, wb = x.bfloat16(), wt.bfloat16()
    fused_conv._check(xb, wb, a, b)  # the accepted form
    with pytest.raises(TypeError):
        fused_conv._check(x, wb, a, b)            # f32 activations
    with pytest.raises(TypeError):
        fused_conv._check(xb, wb, a.double(), b)  # f64 affine
    with pytest.raises(ValueError, match="contiguous"):
        nchw = xb.permute(0, 3, 1, 2).contiguous()
        fused_conv._check(nchw.permute(0, 2, 3, 1), wb, a, b)
    with pytest.raises(ValueError, match="HWIO"):
        fused_conv._check(xb, wb.permute(3, 2, 0, 1), a, b)  # OIHW
    with pytest.raises(ValueError):
        fused_conv._check(xb, wb, a[:4], b)
    # flip takes the dx weights (3,3,Cout,Cin), not HWIO
    fused_conv._check(xb, wb.transpose(2, 3).contiguous(), a, b, flip=True)
    with pytest.raises(ValueError, match="with flip"):
        fused_conv._check(xb, wb, a, b, flip=True)
    # TMA needs 16-byte aligned tensors on the wgmma path (Cin 16, Cout 8)
    assert fused_conv.conv_path(16, 8) == "wgmma"
    odd = torch.empty(xb.numel() + 1, dtype=torch.bfloat16)[1:].view(
        xb.shape)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        fused_conv._check(odd, wb, a, b)
    # the packed path (Cin 3) reads x's rows in 16-byte vectors; it reads
    # the weights element by element, so they may lie anywhere
    x3, w3 = xb[..., :3].contiguous(), wb[:, :, :3].contiguous()
    assert fused_conv.conv_path(3, 8) == "packed"
    fused_conv._check(x3, w3, a, b)
    odd3 = torch.empty(x3.numel() + 1, dtype=torch.bfloat16)[1:].view(
        x3.shape)
    with pytest.raises(ValueError, match="aligned"):
        fused_conv._check(odd3, w3, a, b)
    oddw = torch.empty(w3.numel() + 1, dtype=torch.bfloat16)[1:].view(
        w3.shape)
    fused_conv._check(x3, oddw, a, b)
    # a device with neither the kernel nor the plain route
    with pytest.raises(ValueError, match="no kernel"):
        fused_conv.conv3x3_bn_relu(xb.to("meta"), wb.to("meta"),
                                   a.to("meta"), b.to("meta"))


def test_cpu_route_is_plain_and_not_counted():
    x, wt, a, b = (torch.from_numpy(t) for t in _inputs(1, 5, 7, 4, 6))
    before = (fused_conv.conv3x3_bn_relu.launches,
              dict(fused_conv.conv3x3_bn_relu.path_launches))
    got = fused_conv.conv3x3_bn_relu(x, wt, a, b)
    want = fused_conv.conv3x3_bn_relu_plain(x, wt, a, b)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (fused_conv.conv3x3_bn_relu.launches,
            fused_conv.conv3x3_bn_relu.path_launches) == before


def test_kernel_path_names_the_library_codes(monkeypatch):
    """``kernel_path`` reads the built library's path code: 0 narrow, 1
    wgmma, 2 packed, the order of ``PATHS`` (chip_smoke compares it with
    ``conv_path`` at every (Cin, Cout) it runs)."""

    class Lib:
        @staticmethod
        def conv3x3_bn_relu_path(cin, cout):
            return {"narrow": 0, "wgmma": 1, "packed": 2}[
                fused_conv.conv_path(cin, cout)]

    monkeypatch.setattr(fused_conv, "_library", lambda: Lib)
    for cin, cout in ((3, 64), (12, 64), (64, 12), (64, 64), (64, 20),
                      (256, 12), (17, 64), (64, 28), (21, 64)):
        assert fused_conv.kernel_path(cin, cout) == fused_conv.conv_path(
            cin, cout)
    assert fused_conv.PATHS == ("narrow", "wgmma", "packed")


def test_aligned16_copies_only_misaligned_batch_views():
    """The rule the CUDA wrappers apply before their checks: a batch slice
    whose offset is not a multiple of 16 bytes (the Cin = 3 stem at 45x61:
    45 * 61 * 3 * 2 = 16,470 bytes a sample) is copied to an aligned tensor
    with the same values; an aligned one is passed through. On the CPU the
    misaligned view runs the plain version as it is."""
    x = torch.randn(3, 45, 61, 3).to(torch.bfloat16)
    assert x.data_ptr() % 16 == 0
    assert fused_conv.aligned16(x) is x
    view = x[1:]
    assert view.is_contiguous() and view.data_ptr() % 16 == 6
    fixed = fused_conv.aligned16(view)
    assert fixed.data_ptr() % 16 == 0 and fixed.is_contiguous()
    assert torch.equal(fixed, view)
    w = torch.randn(3, 3, 3, 8).to(torch.bfloat16)
    a, b = torch.ones(8), torch.zeros(8)
    torch.testing.assert_close(
        fused_conv.conv3x3_bn_relu(view, w, a, b),
        fused_conv.conv3x3_bn_relu(fixed, w, a, b), rtol=0, atol=0)


SRC = fused_conv.SOURCE.read_text()


@pytest.mark.parametrize("cin", [3, 12, 21])
def test_packed_fwd_plan_is_the_sources(cin):
    """``packed_fwd_plan``'s bytes at the stem's Cin 3 and the heads' dx
    (Cin 12 and 21) are the figures the source asserts at compile time
    (``static_assert(Geo<CIN>::SMEM == bytes``), and ``K_MAX`` is the
    source's; two blocks fit an SM (233,472 B, 1,024 reserved a block) at
    every Cin the rule admits, each with an instance in the source's
    switch."""
    held = {int(c): int(b) for c, b in re.findall(
        r"static_assert\(Geo<(\d+)>::SMEM == (\d+)", SRC)}
    assert sorted(held) == [3, 12, 21]
    plan = fused_conv.packed_fwd_plan(cin)
    assert plan["bytes"] == held[cin]
    assert plan["k"] == 9 * cin <= plan["kp"] < 9 * cin + 16
    assert re.search(r"constexpr int K_MAX = (\d+);", SRC).group(1) == str(
        fused_conv.K_MAX)
    cases = {int(c) for c in re.findall(r"PACKED_CASE\((\d+)\)", SRC)}
    admitted = {c for c in range(1, 64)
                if fused_conv.conv_path(c, 64) == "packed"}
    assert cases == admitted == {c for c in range(1, 22) if c % 8}
    for c in admitted:
        p = fused_conv.packed_fwd_plan(c)
        assert 2 * (p["bytes"] + 1024) <= 233472
    with pytest.raises(ValueError, match="packed"):
        fused_conv.packed_fwd_plan(22)


@pytest.mark.parametrize("cout,n", [(12, 16), (16, 16), (17, 24), (21, 24),
                                    (24, 24)])
def test_head_tile_plan_is_the_sources(cout, n):
    """``head_tile_plan``: N = 16 up to 16 channels and 24 above, as the
    source's ``tile_n``; its bytes are the figures the source asserts at
    compile time (``static_assert(Tile<N, false>::SMEM == bytes``), within
    a block's 232,448 B; 4 x N / 2 accumulators a consumer thread; the
    head tile's limits are the source's."""
    held = {int(b_n): int(b) for b_n, b in re.findall(
        r"static_assert\(Tile<(\d+), false>::SMEM == (\d+)", SRC)}
    assert sorted(held) == [16, 24]
    plan = fused_conv.head_tile_plan(cout)
    assert plan["n"] == n and plan["bytes"] == held[n] <= 232448
    assert plan["accumulators"] == 2 * n
    assert re.search(r"return Cout <= 16 \? 16 : 24;", SRC)
    for name in ("HEAD_MAX_COUT", "RES_MAX_CIN"):
        assert re.search(rf"constexpr int {name} = (\d+);", SRC).group(
            1) == str(getattr(fused_conv, name))
    assert fused_conv.conv_path(64, cout) == "wgmma"
    with pytest.raises(ValueError, match="head tile"):
        fused_conv.head_tile_plan(28)


@pytest.mark.parametrize("name", sorted(head_variants.VARIANTS))
def test_head_variant_edits_apply_to_the_source(name):
    """Each variant of the head tile and the packed path that
    head_variants.py times is an edit that still applies to the kernel's
    source, and changes it (but "kept")."""
    src = head_variants._edited(head_variants.VARIANTS[name])
    assert (src == fused_conv.SOURCE.read_text()) == (name == "kept")


def test_head_variants_without_a_card_fails(capsys):
    assert head_variants.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
