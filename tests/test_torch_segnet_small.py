"""The port's SegNet under 32 rows or columns against the JAX package, on the
CPU, in f32.

Five 2x2 pools floor 24 rows to 12, 6, 3, 1 and then 0: from 16 to 31 rows
or columns the fifth pool's output and the fifth unpool's input are empty,
and the decoder starts from the unpool's zeros. Under 16 the fourth pool
empties too, and the fifth stage's convs and batch-stat BN run on an empty
map: JAX's SegNet still returns finite logits, with NaN running stats for
those BN layers (the mean over no pixel) and NaN gradients for their
scales. The port does the same: its pools return the empty results and its
convs the empty maps (or dW's zeros) as no work. SegNet at width 1/16,
batch 2. JAX's eval model runs its XLA pair (``use_pallas=False``); its
training runs its default CPU pair, the XLA argmax pair (JAX's Pallas phase
pair refuses a map whose pooled tile is empty). The port's kernel wrappers
run their plain versions on CPU tensors; the empty cases' launchers are
held to their no-launch rule with the device check bypassed."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pytorch_camvid_tpu.models.segnet import apply_segnet
from pytorch_camvid_tpu.ops import loss as jloss
from pytorch_camvid_tpu.train.state import TrainState as JaxTrainState

from pytorch_camvid_tpu_torch.interop.weights import (
    jax_params_from_named, jax_variables_from_model,
    state_dict_from_jax_variables, train_state_from_jax)
from pytorch_camvid_tpu_torch.models.segnet import SegNet
from pytorch_camvid_tpu_torch.ops import fused_pool, pooling
from pytorch_camvid_tpu_torch.train.steps import loss_and_grads

import test_torch_segnet as ts

# the fifth pool empty (16 to 31 rows or columns), then the fifth stage on
# an empty map (under 16)
SIZES = [(24, 32), (32, 24), (20, 40)]
UNDER_16 = [(12, 40), (8, 8)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny ops: one intra-op thread (several test workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(v):
    model = SegNet(3, 12, width_mult=ts.WIDTH)
    model.load_state_dict(state_dict_from_jax_variables(v), strict=True)
    return model


@pytest.mark.parametrize("hw", SIZES + UNDER_16)
def test_eval_logits_match_jax(hw):
    v = ts._variables()
    x = np.random.default_rng(1).normal(size=(ts.BATCH,) + hw + (3,)
                                        ).astype(np.float32)
    want, _ = jax.jit(lambda v, x: apply_segnet(v, x, train=False,
                                                use_pallas=False))(
        jax.tree.map(jnp.asarray, v), jnp.asarray(x))
    want = np.asarray(want)
    model = _model(v).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        plain = model(torch.from_numpy(x), plain=True)
    assert got.shape == want.shape == (ts.BATCH,) + hw + (12,)
    assert np.isfinite(want).all()
    # test_torch_segnet.py's limit: f32 rounding of the folded BN
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert torch.equal(got, plain)


def _port_step(v, x, y, plain, dtype=torch.float32):
    """The port's train-mode logits (from a copy of the state), loss,
    gradients (JAX's layout) and BN stats after the step's forward."""
    state = train_state_from_jax(
        JaxTrainState(v["params"], v["state"], {}, 0, None),
        SegNet(3, 12, width_mult=ts.WIDTH).to(dtype))
    xt = torch.from_numpy(x).to(dtype)
    with torch.no_grad():
        logits = copy.deepcopy(state.model).train()(xt, plain)
    loss, grads = loss_and_grads(state.model, xt, torch.from_numpy(y),
                                 plain=plain)
    return (logits.double().numpy(), float(loss),
            jax_params_from_named(grads, ts.SPEC),
            jax_variables_from_model(state.model)["state"])


@pytest.mark.parametrize("plain", [False, True], ids=["kernel", "plain"])
@pytest.mark.parametrize("hw", SIZES + UNDER_16)
def test_train_step_matches_jax(hw, plain):
    """Train-mode logits, loss, gradients and BN stats from JAX's state,
    on the kernel route (K1 and K2's wrappers, their plain versions here)
    and on the plain one; NaN where JAX's are NaN (under 16: the fifth
    stage's moments over no pixel, and its BN scales' gradients)."""
    v = ts._variables(seed=3)
    x, y = ts._batch(hw=hw)

    def loss_fn(p, bn):
        logits, nb = apply_segnet({"params": p, "state": bn},
                                  jnp.asarray(x), train=True)
        return jloss.cross_entropy_loss(logits, jnp.asarray(y)), (nb, logits)

    (want_loss, (want_bn, want_logits)), want_g = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(v["params"], v["state"])
    logits, loss, got_g, got_bn = _port_step(v, x, y, plain)
    want_logits = np.asarray(want_logits)
    assert logits.shape == want_logits.shape == (ts.BATCH,) + hw + (12,)
    np.testing.assert_allclose(logits, want_logits, rtol=0,
                               atol=1e-4 * np.abs(want_logits).max())
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    want_g = ts._np(want_g)
    nan = [bool(np.isnan(a).any()) for a in jax.tree.leaves(want_g)]
    assert any(nan) == (min(hw) < 16)
    # Each gradient leaf within 1e-3 of its scale (test_torch_segnet.py's
    # limit; a conv bias before batch-stat BN, whose gradient is zero but
    # for rounding, at the scale of its block's dW), NaN where JAX's is
    # NaN. At these sizes the first decoder block after an empty unpool
    # sees zeros: its conv gives the bias alone and its BN normalizes a
    # constant, E[y^2] - E[y]^2 = 0 up to rounding times rsqrt(eps), so
    # some leaves behind it carry rounding noise in either framework. A
    # leaf that f32 rounding moves by more than 1e-4 of its scale in the
    # port's own float64 step is such noise, and is held to its NaN
    # pattern only; so is one where JAX's f32 step is that far from it.
    _, _, ref_g, _ = _port_step(v, x, y, plain, torch.float64)
    held = []
    for s, blks in got_g.items():
        for i, blk in enumerate(blks):
            for k, g in blk.items():
                want, ref = want_g[s][i], np.asarray(ref_g[s][i][k])
                scale = max(np.nan_to_num(np.abs(
                    want["w" if k == "b" else k])).max(), 1e-30)
                np.testing.assert_array_equal(np.isnan(g),
                                              np.isnan(want[k]))
                held.append(max(np.nan_to_num(np.abs(t - ref)).max()
                                for t in (g, want[k])) <= 1e-4 * scale)
                if not held[-1]:
                    continue
                np.testing.assert_allclose(
                    g, want[k], rtol=0, atol=1e-3 * scale,
                    err_msg=f"grad {s}[{i}].{k}")
    assert sum(held) >= 0.9 * len(held)   # measured: 97-102 of 104
    # BN stats within 1e-4 of each leaf's scale, NaN where JAX's are: the
    # deep stages normalize maps of 2 to 8 pixels, where f32 rounding grows
    # (measured: JAX's f32 stats up to 6e-5 from the port's f64 run at 8x8,
    # the port's own f32 stats up to 3.7e-5; both within 1.1e-6 at 36x44)
    ts._leaves_close(got_bn, ts._np(want_bn), 1e-4, "BN state")
    stale = [bool(np.isnan(a).any()) for a in jax.tree.leaves(got_bn)]
    assert any(stale) == (min(hw) < 16)


@pytest.mark.parametrize("hw", [(1, 3), (3, 1), (0, 4)])
@pytest.mark.parametrize("phase", [False, True])
def test_empty_pool_results_launch_nothing(monkeypatch, hw, phase):
    """The launchers of K3 and K2 (and K3's int8 instance) return an empty
    pool, the unpool of an empty map (zeros of its output size) and its
    gather without building or launching a kernel, and count nothing: the
    device check is bypassed on these CPU tensors and the library raises
    if it is reached."""
    def no_library():
        raise AssertionError("a kernel was launched")
    monkeypatch.setattr(fused_pool, "_library", no_library)
    monkeypatch.setattr(fused_pool, "_cuda_only", lambda *a, **k: None)
    monkeypatch.setattr(fused_pool, "_on_cuda", lambda *a, **k: True)
    fused_pool.reset_launches()
    pool = (fused_pool.launch_pool_phase if phase
            else fused_pool.launch_pool_argmax)
    unpool = (fused_pool.launch_unpool_phase if phase
              else fused_pool.launch_unpool)
    for dtype in (torch.float32, torch.bfloat16) + (
            () if phase else (torch.int8,)):
        x = torch.ones((2,) + hw + (8,), dtype=dtype)
        y, idx = pool(x)
        want_y, want_idx = (pooling.max_pool_2x2_argmax_phase(x) if phase
                            else pooling.max_pool_2x2_with_argmax(x))
        assert y.shape == want_y.shape == (2, hw[0] // 2, hw[1] // 2, 8)
        assert (y.dtype, idx.dtype) == (dtype, want_idx.dtype)
        out = unpool(y, idx, hw)
        assert out.dtype == dtype and out.shape == x.shape
        assert not out.any()
        assert fused_pool.gather_phase(x, idx.to(torch.int8)).shape == \
            y.shape
    assert fused_pool.launches() == dict.fromkeys(fused_pool.KERNELS, 0)


def test_empty_maps_keep_the_plain_pools_shapes():
    """The plain pools at a side under 2: empty results of the floored
    shape with the index dtypes, and zeros from the unpools."""
    x = torch.randn(2, 1, 5, 4)
    assert pooling.max_pool_2x2(x).shape == (2, 0, 2, 4)
    y, idx = pooling.max_pool_2x2_with_argmax(x)
    assert (y.shape, idx.dtype) == ((2, 0, 2, 4), torch.int32)
    y, k = pooling.max_pool_2x2_argmax_phase(x)
    assert (y.shape, k.dtype) == ((2, 0, 2, 4), torch.int8)
    out = pooling.max_unpool_2x2_from_phase(y, k, (1, 5))
    assert out.shape == x.shape and not out.any()
    assert pooling.max_unpool_2x2(y, idx, (1, 5)).shape == x.shape
