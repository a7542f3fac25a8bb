"""The port's 2x2 max pool with indices, its unpool and the phase gather
(ops/pooling.py, ops/fused_pool.py) against the JAX package, on the CPU.

The same numpy inputs, f32, with planted ties (values on a coarse grid) and
odd sizes, go through JAX's XLA pair (pytorch_camvid_tpu/ops/pooling.py) and
its Pallas kernels in interpret mode (ops/pallas_pool.py: K3, and K2's MXU
and packed variants), and through the port, whose kernel wrappers run their
plain versions on CPU tensors. Selection is exact, so every comparison is
bit for bit. Also here: the port's NaN rule and its gradient at ties, where
JAX's own implementations differ (ROADMAP.md, Queue 3)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pytorch_camvid_tpu.ops import pallas_pool as pp
from pytorch_camvid_tpu.ops import pooling as jpool

from pytorch_camvid_tpu_torch.ops import fused_pool, pooling

SHAPES = [(2, 45, 61, 8), (2, 36, 44, 16), (1, 7, 5, 3)]
IDS = ["odd", "even", "tiny"]


def _tied(shape, seed=0):
    """Values on a grid of five, so most windows hold ties."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-2, 3, shape) * 0.5).astype(np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _interpret(monkeypatch):
    for name in ("max_pool_2x2_phase_packed", "max_pool_2x2_phase_mxu",
                 "max_unpool_2x2_phase_nat", "_unpool_phase_packed_grad",
                 "_unpool_phase_grad_mxu"):
        monkeypatch.setattr(pp, name, functools.partial(
            getattr(pp, name), interpret=True))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_flat_pool_and_unpool_equal_jax_xla_and_pallas(shape):
    """K3's functions: the port's wrappers (plain on the CPU) against JAX's
    XLA pair and its Pallas kernels in interpret mode."""
    x = _tied(shape)
    hw = shape[1:3]
    got_p, got_i = fused_pool.max_pool_2x2_argmax(torch.from_numpy(x))
    assert got_i.dtype == torch.int32
    want = [jpool.max_pool_2x2_with_argmax(jnp.asarray(x)),
            pp.max_pool_2x2_argmax_pallas(jnp.asarray(x), interpret=True)]
    for want_p, want_i in want:
        np.testing.assert_array_equal(_np(got_p), _np(want_p))
        np.testing.assert_array_equal(_np(got_i), _np(want_i))
    got_u = fused_pool.max_unpool_2x2(got_p, got_i, hw)
    assert tuple(got_u.shape) == shape
    xp, xi = jnp.asarray(_np(got_p)), jnp.asarray(_np(got_i))
    for want_u in (jpool.max_unpool_2x2(xp, xi, hw),
                   pp.max_unpool_2x2_pallas(xp, xi, hw, interpret=True)):
        np.testing.assert_array_equal(_np(got_u), _np(want_u))
    # the odd row and column are never selected: zero
    assert not got_u[:, 2 * (hw[0] // 2):].any()
    assert not got_u[:, :, 2 * (hw[1] // 2):].any()


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("sel", ["mxu", "packed"])
def test_phase_pool_unpool_and_gather_equal_jax_pallas(shape, sel):
    """K2's three functions against both TPU variants (bit-equal to each
    other), interpret mode, and the XLA phase pool."""
    x = _tied(shape, seed=1)
    hw = shape[1:3]
    pool = {"mxu": pp.max_pool_2x2_phase_mxu,
            "packed": pp.max_pool_2x2_phase_packed}[sel]
    unpool = {"mxu": pp.max_unpool_2x2_phase_nat,
              "packed": pp.max_unpool_2x2_phase_packed}[sel]
    gather = {"mxu": pp._unpool_phase_grad_mxu,
              "packed": pp._unpool_phase_packed_grad}[sel]
    got_p, got_k = fused_pool.max_pool_2x2_phase(torch.from_numpy(x))
    assert got_k.dtype == torch.int8
    for want_p, want_k in (pool(jnp.asarray(x), interpret=True),
                           jpool.max_pool_2x2_argmax_phase(jnp.asarray(x))):
        np.testing.assert_array_equal(_np(got_p), _np(want_p))
        np.testing.assert_array_equal(_np(got_k), _np(want_k))
    kp = jnp.asarray(_np(got_k))
    got_u = fused_pool.max_unpool_2x2_phase(got_p, got_k, hw)
    want_u = unpool(jnp.asarray(_np(got_p)), kp, hw, interpret=True)
    np.testing.assert_array_equal(_np(got_u), _np(want_u))
    g = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    got_g = fused_pool.gather_phase(torch.from_numpy(g), got_k)
    np.testing.assert_array_equal(
        _np(got_g), _np(gather(jnp.asarray(g), kp, interpret=True)))


def test_phase_and_flat_forms_agree():
    x = torch.from_numpy(_tied((2, 45, 61, 8), seed=3))
    p1, idx = pooling.max_pool_2x2_with_argmax(x)
    p2, k = pooling.max_pool_2x2_argmax_phase(x)
    assert torch.equal(p1, p2)
    assert torch.equal(pooling.phase_to_flat_index(k, 61), idx)
    np.testing.assert_array_equal(
        _np(pooling.phase_to_flat_index(k, 61)),
        _np(jpool.phase_to_flat_index(jnp.asarray(_np(k)), 61)))
    assert torch.equal(pooling.max_unpool_2x2(p1, idx, (45, 61)),
                       pooling.max_unpool_2x2_from_phase(p2, k, (45, 61)))


@pytest.mark.parametrize("shape", SHAPES[:2], ids=IDS[:2])
def test_train_pair_backward_equals_jax_custom_vjp(shape, monkeypatch):
    """The autograd pair against JAX's TPU training pair (custom VJPs on
    interpret-mode kernels): L = sum(pooled * r1) + sum(unpool(pooled) *
    r2), so dL/dx runs the pool's backward (the phase unpool) on r1 plus
    the unpool's backward (the phase gather) of r2. Ties everywhere: both
    credit the selected pixel alone."""
    _interpret(monkeypatch)
    rng = np.random.default_rng(4)
    x = _tied(shape, seed=4)
    hw = shape[1:3]
    pshape = (shape[0], hw[0] // 2, hw[1] // 2, shape[3])
    r1 = rng.normal(size=pshape).astype(np.float32)
    r2 = rng.normal(size=shape).astype(np.float32)

    def jax_loss(x):
        p, k = pp.pool_phase_packed_train(x)
        u = pp.unpool_phase_packed_train(p, k, hw)
        return jnp.sum(p * r1) + jnp.sum(u * r2)

    want = jax.grad(jax_loss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    p, k = fused_pool.pool_phase_train(xt)
    assert not k.requires_grad
    u = fused_pool.unpool_phase_train(p, k, hw)
    ((p * torch.from_numpy(r1)).sum()
     + (u * torch.from_numpy(r2)).sum()).backward()
    np.testing.assert_array_equal(_np(xt.grad), _np(want))
    # the dropped odd row and column get no gradient
    assert not xt.grad[:, 2 * (hw[0] // 2):].any()
    assert not xt.grad[:, :, 2 * (hw[1] // 2):].any()


def test_tie_gradient_credits_first_max_where_jax_xla_pair_splits(
        monkeypatch):
    """A window of four equal values: the port (its kernel pair and its
    plain path, autograd of F.max_pool2d) credits the whole gradient to
    (0,0), as JAX's Pallas training pair does; JAX's XLA pair, the CPU
    default, differentiates jnp.max over the four candidates and splits it
    into quarters. The port's training path follows the Pallas pair."""
    _interpret(monkeypatch)
    x = np.ones((1, 2, 2, 1), np.float32)
    want_xla = jax.grad(lambda v: jnp.sum(
        jpool.max_pool_2x2_with_argmax(v)[0]))(jnp.asarray(x))
    np.testing.assert_array_equal(_np(want_xla).ravel(), [0.25] * 4)
    want_pallas = jax.grad(lambda v: jnp.sum(
        pp.pool_phase_packed_train(v)[0]))(jnp.asarray(x))
    np.testing.assert_array_equal(_np(want_pallas).ravel(), [1, 0, 0, 0])
    for pool in (fused_pool.pool_phase_train,
                 pooling.max_pool_2x2_argmax_phase):
        xt = torch.from_numpy(x).requires_grad_()
        pool(xt)[0].sum().backward()
        np.testing.assert_array_equal(_np(xt.grad).ravel(), [1, 0, 0, 0])


def test_nan_wins_the_window_as_in_torch():
    """The port's NaN rule: a NaN takes the window (the last NaN in scan
    order if several), pooled is NaN and the index points at it, in both
    index forms; the unpool puts NaN at that pixel only. JAX's XLA pair
    agrees for one NaN (it takes the first of several); its Pallas kernels
    compare strictly and do not: K3 reports phase 3, K2 a phase of the
    NaN-free row."""
    x = np.arange(2 * 4 * 4, dtype=np.float32).reshape(1, 4, 4, 2)
    x[0, 1, 0, 0] = np.nan          # window (0, 0), phase 2, channel 0
    x[0, 2, 3, 1] = np.nan          # window (1, 1), phase 1 ...
    x[0, 3, 3, 1] = np.nan          # ... and phase 3: the last wins
    t = torch.from_numpy(x)
    for pooled, k in (pooling.max_pool_2x2_argmax_phase(t),
                      fused_pool.max_pool_2x2_phase(t)):
        assert torch.isnan(pooled[0, 0, 0, 0]) and k[0, 0, 0, 0] == 2
        assert torch.isnan(pooled[0, 1, 1, 1]) and k[0, 1, 1, 1] == 3
        assert not torch.isnan(pooled[0, :, :, 0]).flatten()[1:].any()
    pooled, idx = fused_pool.max_pool_2x2_argmax(t)
    assert idx[0, 0, 0, 0] == 1 * 4 + 0 and idx[0, 1, 1, 1] == 3 * 4 + 3
    u = fused_pool.max_unpool_2x2(pooled, idx, (4, 4))
    assert torch.isnan(u).sum() == 2
    assert torch.isnan(u[0, 1, 0, 0]) and torch.isnan(u[0, 3, 3, 1])

    one = x.copy()
    one[0, 3, 3, 1] = 7.0           # a single NaN per window
    j_p, j_i = jpool.max_pool_2x2_with_argmax(jnp.asarray(one))
    p, i = pooling.max_pool_2x2_with_argmax(torch.from_numpy(one))
    np.testing.assert_array_equal(_np(p), _np(j_p))     # NaN == NaN here
    np.testing.assert_array_equal(_np(i), _np(j_i))
    _, k3 = pp.max_pool_2x2_argmax_pallas(jnp.asarray(one), interpret=True)
    _, k2 = pp.max_pool_2x2_phase_packed(jnp.asarray(one), interpret=True)
    assert int(k3[0, 0, 0, 0]) == 1 * 4 + 1     # phase 3, not the NaN's 2
    assert int(k2[0, 0, 0, 0]) in (0, 1)


def test_wrappers_refuse_devices_without_a_kernel():
    """A CPU tensor takes the plain version; any other device than CUDA
    raises (there is no silent fallback), and nothing is counted."""
    fused_pool.reset_launches()
    x = torch.empty((1, 4, 4, 8), device="meta")
    k = torch.empty((1, 2, 2, 8), dtype=torch.int8, device="meta")
    for call in (lambda: fused_pool.max_pool_2x2_argmax(x),
                 lambda: fused_pool.max_pool_2x2_phase(x),
                 lambda: fused_pool.max_unpool_2x2_phase(x[:, :2, :2], k,
                                                         (4, 4)),
                 lambda: fused_pool.gather_phase(x, k)):
        with pytest.raises(ValueError, match="no kernel"):
            call()
    fused_pool.max_pool_2x2_argmax(torch.zeros((1, 4, 4, 8)))
    assert set(fused_pool.launches().values()) == {0}
