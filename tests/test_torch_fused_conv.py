"""The port's fused conv3x3+BN+ReLU (pytorch_camvid_tpu_torch/ops/
fused_conv.py) against the JAX package's Pallas kernel in interpret mode.

On the CPU the port's wrapper runs its plain version (the CUDA kernel is
checked against that plain version on the card by chip_smoke.py). Inputs
come from numpy with a fixed seed and go to both packages in f32."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pytorch_camvid_tpu.ops import pallas_conv as jax_pc
from pytorch_camvid_tpu_torch.ops import fused_conv


def _inputs(n, h, w, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)
          ).astype(np.float32)
    a = rng.uniform(0.5, 1.5, size=cout).astype(np.float32)
    b = rng.normal(scale=0.1, size=cout).astype(np.float32)
    return x, wt, a, b


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(1, 8, 12, 3, 16), (2, 9, 15, 16, 12),
                                   (1, 7, 10, 32, 32)])
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
    # a device with neither the kernel nor the plain route
    with pytest.raises(ValueError, match="no kernel"):
        fused_conv.conv3x3_bn_relu(xb.to("meta"), wb.to("meta"),
                                   a.to("meta"), b.to("meta"))


def test_cpu_route_is_plain_and_not_counted():
    x, wt, a, b = (torch.from_numpy(t) for t in _inputs(1, 5, 7, 4, 6))
    before = fused_conv.conv3x3_bn_relu.launches
    got = fused_conv.conv3x3_bn_relu(x, wt, a, b)
    want = fused_conv.conv3x3_bn_relu_plain(x, wt, a, b)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fused_conv.conv3x3_bn_relu.launches == before
