"""The port's int8-quantized UNet and SegNet against the JAX package's, on
the CPU: calibration, the fused-handoff marks, whole models served from
JAX's quantized tree, K3's int8 pair and the Predictor.

Models at width 1/16 (SegNet 1/8) with the same numpy variables in both
packages (BN with non-trivial running stats), 32x48 inputs, f32 compute
unless stated. ``min_cout=0`` quantizes the heads too, so every block runs
the int8 block. Tolerances:
- calibration amax: rtol 1e-5 (the float forwards differ in rounding);
- logits from JAX's own quantized tree (``quantized_from_jax``): both
  packages' int32 sums are exact, their epilogues the same f32 ops, so the
  logits agree within 1e-5 of max|logit| and the class maps on >= 0.999
  of the pixels (a 1-LSB int8 difference can tip a SegNet pool tie);
- each package quantizing from its own calibration: argmax agreement >=
  0.99 (amax within rtol 1e-5 moves s_x by ulps, which moves a few int8
  values by 1);
- the Predictor at bf16 compute, each package calibrating on the same
  frames: class maps agree on >= 0.97 of the pixels (bf16 convs round
  differently in XLA and in torch, and the int8 steps amplify it).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pytorch_camvid_tpu.models import get_model as jax_get_model
from pytorch_camvid_tpu.ops import pooling as jpool
from pytorch_camvid_tpu.ops import quant as jq
from pytorch_camvid_tpu.serving import Predictor as JaxPredictor

from pytorch_camvid_tpu_torch.interop.weights import (
    amax_from_jax, amax_to_jax, quantized_from_jax,
    state_dict_from_jax_variables)
from pytorch_camvid_tpu_torch.models import get_model, spec_from_state_dict
from pytorch_camvid_tpu_torch.ops import fused_pool, pooling
from pytorch_camvid_tpu_torch.ops import quant as tq
from pytorch_camvid_tpu_torch.serving import Predictor

WIDTH = {"unet": 1 / 16, "segnet": 1 / 8}
HW = (32, 48)


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _variables(net, seed=0):
    """JAX variables as numpy, from JAX's init at the test width, with
    non-trivial BN affine and running stats."""
    init_fn, _ = jax_get_model(net, 3, 12)
    v = jax.tree.map(np.asarray, init_fn(jax.random.PRNGKey(seed),
                                         width_mult=WIDTH[net]))
    rng = np.random.default_rng(seed)
    for stage in v["params"]:
        for p, s in zip(v["params"][stage], v["state"][stage]):
            n = p["scale"].shape[0]
            p["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            p["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
            s["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
            s["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return v


def _port(net, v):
    sd = state_dict_from_jax_variables(v)
    model = get_model(net, spec=spec_from_state_dict(net, sd))
    model.load_state_dict(sd, strict=True)
    return model.eval()


def _x(seed=1, n=1):
    return np.random.default_rng(seed).normal(
        0, 1, (n,) + HW + (3,)).astype(np.float32)


@pytest.fixture(scope="module", params=["unet", "segnet"])
def case(request):
    """(net, JAX variables, JAX apply_fn, input, JAX amax at f32)."""
    net = request.param
    v = _variables(net)
    _, apply_fn = jax_get_model(net, 3, 12)
    x = _x()
    amax = jq.calibrate(apply_fn, jax.tree.map(jnp.asarray, v),
                        [jnp.asarray(x)], compute_dtype=jnp.float32)
    return net, v, apply_fn, x, jax.tree.map(np.asarray, amax)


def test_calibrate(case):
    net, v, _, x, amax_j = case
    model = _port(net, v)
    with torch.no_grad():
        amax_t = tq.calibrate(model, [torch.from_numpy(x)])
    got = amax_to_jax(amax_t)
    assert set(got) == set(amax_j)
    for stage in got:
        np.testing.assert_allclose(np.array(got[stage]),
                                   np.array(amax_j[stage]), rtol=1e-5,
                                   err_msg=stage)
    back = amax_from_jax(got)
    assert all(torch.equal(a, b) for s in back
               for a, b in zip(back[s], amax_t[s]))


@pytest.mark.parametrize("min_cout", [0, 8, 64])
@pytest.mark.parametrize("fuse_pool", [True, False])
def test_handoff_marks(case, min_cout, fuse_pool):
    """The blocks quantized and the edges fused (``s_out``) are JAX's, and
    UNet's stage-final blocks emit the compute dtype."""
    net, v, _, _, amax_j = case
    qj = jq.quantize_variables(v, amax_j, min_cout=min_cout,
                               fuse_pool=fuse_pool)["params"]
    model = _port(net, v)
    tq.quantize_model(model, amax_from_jax(amax_j), min_cout=min_cout,
                      fuse_pool=fuse_pool)
    for stage, blocks in qj.items():
        port = model.stage_blocks(stage)
        assert [("w_q" in b, "s_out" in b) for b in blocks] == [
            (b.quantized, b.quantized and b.s_out is not None)
            for b in port], stage
        for b, p in zip(blocks, port):
            if "s_out" in b:
                np.testing.assert_array_max_ulp(p.s_out.numpy(),
                                                np.asarray(b["s_out"]), 1)
    if net == "unet":
        assert all(model.stage_blocks(stage)[-1].s_out is None
                   for stage, _ in model.spec
                   if model.stage_blocks(stage)[-1].quantized)
    else:
        marked = [s for s, _ in model.spec
                  if model.stage_blocks(s)[-1].quantized
                  and model.stage_blocks(s)[-1].s_out is not None]
        if min_cout == 0:
            assert len(marked) == (9 if fuse_pool else 0)


def _jax_logits(apply_fn, qv, x, dtype=jnp.float32):
    y, _ = apply_fn(jax.tree.map(jnp.asarray, qv), jnp.asarray(x),
                    train=False, compute_dtype=dtype)
    return np.asarray(y)


def test_models_from_jax_quantized_tree(case):
    net, v, apply_fn, x, amax_j = case
    qv = jq.quantize_variables(v, amax_j, min_cout=0)
    want = _jax_logits(apply_fn, qv, x)
    model = _port(net, v)
    quantized_from_jax(jax.tree.map(np.asarray, qv["params"]), model)
    assert len(tq.quantized_blocks(model)) == len(model.blocks())
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        plain = model(torch.from_numpy(x), plain=True)
    assert got.dtype == torch.float32 and torch.equal(got, plain)
    got = got.numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert err <= 1e-5 and agree >= 0.999, (err, agree)


def test_models_quantized_from_their_own_calibration(case):
    """Each package calibrates and quantizes on its own: the class maps
    agree."""
    net, v, apply_fn, x, amax_j = case
    want = _jax_logits(apply_fn, jq.quantize_variables(v, amax_j,
                                                       min_cout=0), x)
    model = _port(net, v)
    with torch.no_grad():
        tq.quantize_model(model, tq.calibrate(model, [torch.from_numpy(x)]),
                          min_cout=0)
        got = model(torch.from_numpy(x)).numpy()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99


def test_bf16_model_runs_int8_between_blocks():
    """At bf16 compute the int8 handoff keeps int8 inside the stages and
    the logits come out f32 and finite; UNet's stage outputs are bf16."""
    v = _variables("unet")
    model = _port("unet", v)
    x = torch.from_numpy(_x()).to(torch.bfloat16)
    seen = []
    with torch.no_grad():
        tq.quantize_model(model, tq.calibrate(model, [x]), min_cout=0)
        for stage, _ in model.spec:
            getattr(model, stage).register_forward_hook(
                lambda m, i, o, s=stage: seen.append((s, o.dtype)))
        y = model(x)
    assert y.dtype == torch.float32 and torch.isfinite(y).all()
    assert all(dt == torch.bfloat16 for _, dt in seen), seen


@pytest.mark.parametrize("hw,c", [((9, 13), 4), ((45, 61), 64),
                                  ((8, 8), 16)])
def test_k3_int8_pair_matches_jax_with_ties(hw, c):
    """K3's plain pair on int8 values in [-2, 2] (most windows tie): the
    pooled values and flat indices equal JAX's argmax pair, bit for bit;
    so does the unpool (fill 0)."""
    rng = np.random.default_rng(hw[0] * c)
    x = rng.integers(-2, 3, (2,) + hw + (c,), dtype=np.int8)
    pj, ij = jpool.max_pool_2x2_with_argmax(jnp.asarray(x))
    pt, it = pooling.max_pool_2x2_with_argmax(torch.from_numpy(x))
    assert pt.dtype == torch.int8 and it.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    uj = jpool.max_unpool_2x2(pj, ij, hw)
    ut = pooling.max_unpool_2x2(pt, it, hw)
    assert ut.dtype == torch.int8
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    kp, ki = fused_pool.max_pool_2x2_argmax(torch.from_numpy(x))
    assert torch.equal(kp, pt) and torch.equal(ki, it)
    assert torch.equal(fused_pool.max_unpool_2x2(kp, ki, hw), ut)


def test_predictor_quantize_int8_matches_jax():
    """``Predictor.quantize_int8`` on 3 frames of another size (resized on
    the device; the short last chunk tiled up to the batch of 2), bf16
    compute, then ``predict``: the class maps agree with JAX's."""
    net = "segnet"
    v = _variables(net, seed=4)
    frames = np.random.default_rng(5).integers(0, 256, (3, 40, 56, 3),
                                               dtype=np.uint8)
    jp = JaxPredictor(net, jax.tree.map(jnp.asarray, v), batch_size=2,
                      image_hw=HW)
    jp.quantize_int8(frames)
    want = jp.predict(frames)
    with Predictor(net, state_dict_from_jax_variables(v), batch_size=2,
                   image_hw=HW, device="cpu") as p:
        p.quantize_int8(frames)
        # min_cout 64: the blocks of 64 or more output channels
        assert len(tq.quantized_blocks(p.model)) == sum(
            co >= 64 for _, pairs in p.model.spec for _, co in pairs) > 0
        got = p.predict(frames)
    assert got.shape == want.shape == (3,) + HW
    assert (got == want).mean() >= 0.97, (got == want).mean()


def test_predictor_quantize_int8_needs_images():
    v = _variables("unet")
    with Predictor("unet", state_dict_from_jax_variables(v), batch_size=2,
                   image_hw=HW, device="cpu") as p:
        with pytest.raises(ValueError, match="calibration image"):
            p.quantize_int8(np.zeros((0,) + HW + (3,), np.uint8))
