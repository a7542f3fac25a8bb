"""The port's SegNet against the JAX package, on the CPU, in f32: eval
logits, weights carried both ways, one train step from JAX's TrainState,
the Predictor and the serving CLI.

SegNet at width 1/16, batch 2, odd sizes (45x62 pools 45 -> 22 -> 11 -> 5
-> 2 -> 1 and unpools back with zero padding; the train steps run 36x44,
which pools 9 -> 4 and 11 -> 5). JAX's eval model runs its XLA pair
(use_pallas=False); its training runs the TPU's Pallas phase pair
(PCT_POOL_IMPL=pallas_phase) in interpret mode, the pair the port follows.
The port's kernel wrappers run their plain versions on CPU tensors."""

import functools
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pytorch_camvid_tpu.interop import (state_dict_from_variables,
                                        variables_from_state_dict)
from pytorch_camvid_tpu.models.segnet import apply_segnet
from pytorch_camvid_tpu.ops import loss as jloss
from pytorch_camvid_tpu.ops import pallas_pool as pp
from pytorch_camvid_tpu.serving import Predictor as JaxPredictor
from pytorch_camvid_tpu.train import optim as joptim, schedules as jsched
from pytorch_camvid_tpu.train.state import TrainState as JaxTrainState
from pytorch_camvid_tpu.train.steps import make_train_step as jax_train_step

from pytorch_camvid_tpu_torch import bench
from pytorch_camvid_tpu_torch.config import settings
from pytorch_camvid_tpu_torch.data.normalize import to_tensor_normalize
from pytorch_camvid_tpu_torch.data.synthetic import synthetic_arrays
from pytorch_camvid_tpu_torch.interop.weights import (
    jax_params_from_named, jax_variables_from_model,
    state_dict_from_jax_variables, train_state_from_jax)
from pytorch_camvid_tpu_torch.models import get_model, spec_from_state_dict
from pytorch_camvid_tpu_torch.models.segnet import SegNet, scaled_spec
from pytorch_camvid_tpu_torch.serving import Predictor
from pytorch_camvid_tpu_torch.train import make_train_step, schedules, sgd
from pytorch_camvid_tpu_torch.train.steps import loss_and_grads

WIDTH, BATCH = 1 / 16, 2
HW = (45, 62)
# JAX's f32 SegNet gradients on the CPU drift from an f64 run of the port
# as the image grows: up to 2.5e-3 of a leaf's scale at 45x62 and 1.4e-2 at
# 90x124, where the port's own f32 run stays within 8e-5 of its f64 run
# (the bottleneck's batch-stat BN amplifies rounding). At 36x44 JAX stays
# within 3e-4, so the train steps are compared there.
TRAIN_HW = (36, 44)
SPEC = scaled_spec(3, 12, WIDTH)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _variables(seed=0, spec=SPEC):
    """JAX SegNet variables as numpy: torch-default-scaled convs,
    non-trivial BN affine and running stats."""
    rng = np.random.default_rng(seed)
    params, state = {}, {}
    for stage, pairs in spec:
        params[stage], state[stage] = [], []
        for cin, cout in pairs:
            bound = 1 / np.sqrt(9 * cin)
            params[stage].append({
                "w": rng.uniform(-bound, bound, (3, 3, cin, cout)),
                "b": rng.uniform(-bound, bound, cout),
                "scale": rng.uniform(0.5, 1.5, cout),
                "bias": rng.normal(scale=0.1, size=cout)})
            state[stage].append({"mean": rng.normal(scale=0.1, size=cout),
                                 "var": rng.uniform(0.5, 2.0, cout)})
    return jax.tree.map(lambda a: a.astype(np.float32),
                        {"params": params, "state": state})


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(n=BATCH, seed=1, hw=TRAIN_HW):
    images, labels = synthetic_arrays(n, hw, seed=seed)
    x = ((images.astype(np.float32) / 255.0 - 0.4) / 0.3).astype(np.float32)
    return x, labels.astype(np.int64)


def _pallas_phase(monkeypatch):
    """JAX's TPU training pair on the CPU: selected by PCT_POOL_IMPL, its
    kernels in interpret mode (as tests/test_segnet_pool_impl.py)."""
    monkeypatch.setenv("PCT_POOL_IMPL", "pallas_phase")
    for name in ("max_pool_2x2_phase_mxu", "max_unpool_2x2_phase_nat",
                 "_unpool_phase_grad_mxu"):
        monkeypatch.setattr(pp, name, functools.partial(
            getattr(pp, name), interpret=True))


def _leaves_close(got_tree, want_tree, rel, what):
    """Each leaf within ``rel`` of that leaf's max|want|."""
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got_tree),
                            jax.tree.leaves(want_tree)):
        w = np.asarray(w)
        np.testing.assert_allclose(
            np.asarray(g), w, rtol=0, atol=rel * max(np.abs(w).max(), 1e-30),
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def test_segnet_eval_logits_match_jax():
    v = _variables()
    x = np.random.default_rng(1).normal(size=(BATCH,) + HW + (3,)).astype(
        np.float32)
    want, _ = jax.jit(lambda v, x: apply_segnet(v, x, train=False,
                                                use_pallas=False))(
        jax.tree.map(jnp.asarray, v), jnp.asarray(x))
    want = np.asarray(want)
    model = SegNet(3, 12, width_mult=WIDTH)
    model.load_state_dict(state_dict_from_jax_variables(v), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
        plain = model(torch.from_numpy(x), plain=True)
    assert got.shape == want.shape and got.dtype == torch.float32
    # (conv + b - mean) * inv + beta in JAX, conv * A + B folded in the
    # port: f32 rounding only, over 26 blocks (the pools are exact)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert torch.equal(got, plain)


def test_reference_state_dict_loads_strictly_both_ways():
    v = _variables(seed=2)
    ref = state_dict_from_variables("segnet", v)   # the reference's names
    model = SegNet(3, 12, width_mult=WIDTH)
    model.load_state_dict({k: torch.from_numpy(np.array(a))
                           for k, a in ref.items()}, strict=True)
    sd = state_dict_from_jax_variables(v)
    assert set(sd) == set(ref) == set(model.state_dict())
    assert "encoder1.0.conv.weight" in sd and "decoder1.1.bn.running_var" \
        in sd
    for k, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), ref[k], err_msg=k)
        np.testing.assert_array_equal(sd[k].numpy(), ref[k], err_msg=k)
    back = variables_from_state_dict("segnet", model.state_dict(), v)
    for a, b in zip(jax.tree.leaves(v), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(jax.tree.leaves(jax_variables_from_model(model)),
                    jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)


def test_train_state_round_trip_through_interop():
    """A JAX SegNet TrainState -> port -> JAX layout gives back every leaf,
    optimizer moments included."""
    v = _variables(seed=10)
    rng = np.random.default_rng(11)
    m = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                     v["params"])
    st = train_state_from_jax(
        JaxTrainState(v["params"], v["state"], {"m": m}, 5, None),
        SegNet(3, 12, width_mult=WIDTH))
    assert st.step == 5
    for a, b in zip(jax.tree.leaves(jax_variables_from_model(st.model)),
                    jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(jax_params_from_named(
            st.opt_state["m"], SPEC)), jax.tree.leaves(m)):
        np.testing.assert_array_equal(a, b)


def test_full_width_segnet_and_its_flops():
    model = get_model("segnet", 3, 12)
    assert len(model.blocks()) == 26
    assert sum(p.numel() for p in model.parameters()) == 29_449_956
    assert model.head_names()["scale"] == "decoder1.1.bn.weight"
    assert bench.conv_fwd_flops("segnet", (360, 480)) == pytest.approx(
        212.77458432e9)
    assert bench.conv_fwd_flops("unet", (360, 480)) == pytest.approx(
        345.98043648e9)
    assert spec_from_state_dict("segnet", model.state_dict()) == model.spec


def test_one_train_step_from_jax_state_matches_jax(monkeypatch):
    """Train-mode forward (K1 convs, batch-stat BN, the K2 pool pair),
    loss and gradients from the same state, against JAX's TPU pair."""
    _pallas_phase(monkeypatch)
    v = _variables(seed=3)
    x, y = _batch()

    def loss_fn(p, bn):
        logits, nb = apply_segnet({"params": p, "state": bn},
                                  jnp.asarray(x), train=True)
        return jloss.cross_entropy_loss(logits, jnp.asarray(y)), nb

    (want_loss, want_bn), want_g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"], v["state"])
    state = train_state_from_jax(
        JaxTrainState(v["params"], v["state"], {}, 0, None),
        SegNet(3, 12, width_mult=WIDTH))
    got_loss, grads = loss_and_grads(state.model, torch.from_numpy(x),
                                     torch.from_numpy(y))
    got_g = jax_params_from_named(grads, SPEC)
    # f32 on both sides through 26 blocks forward and back: summation
    # order only (the pools select identically)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)

    def no_bias(tree):  # conv biases before train-mode BN: zero gradient
        return {s: [{k: a for k, a in b.items() if k != "b"} for b in blks]
                for s, blks in tree.items()}
    _leaves_close(no_bias(got_g), no_bias(_np(want_g)), 1e-3, "grad")
    for s, blks in got_g.items():  # conv biases at the scale of their dW
        for i, blk in enumerate(blks):
            np.testing.assert_allclose(
                blk["b"], np.asarray(want_g[s][i]["b"]), rtol=0,
                atol=1e-3 * np.abs(np.asarray(want_g[s][i]["w"])).max())
    _leaves_close(jax_variables_from_model(state.model)["state"],
                  _np(want_bn), 1e-5, "BN state")
    # the port's f32 gradients against its own f64 run (measured 3e-5)
    ref = train_state_from_jax(
        JaxTrainState(v["params"], v["state"], {}, 0, None),
        SegNet(3, 12, width_mult=WIDTH).double())
    _, grads64 = loss_and_grads(ref.model, torch.from_numpy(x).double(),
                                torch.from_numpy(y))
    _leaves_close(no_bias(got_g), no_bias(jax_params_from_named(
        grads64, SPEC)), 1e-3, "grad vs f64")


def test_sgd_step_and_head_grad_norms_match_jax(monkeypatch):
    """A whole train step: the update and the grad-norm metrics, which
    read SegNet's head (decoder1's last block, its BN under ``.bn``)."""
    _pallas_phase(monkeypatch)
    v = _variables(seed=4)
    x, y = _batch(seed=5)
    step = jax.jit(jax_train_step(apply_segnet, joptim.sgd(),
                                  jsched.constant_lr(0.05)))
    st0 = JaxTrainState.create(v, joptim.sgd())
    st1, wm = step(st0, (jnp.asarray(x), jnp.asarray(y)))
    got = train_state_from_jax(_np(st0), SegNet(3, 12, width_mult=WIDTH))
    got, gm = make_train_step(sgd(), schedules.constant_lr(0.05))(
        got, (torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]),
                               rtol=1e-5)
    for k in ("grad_norm_w", "grad_norm_b"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-4)
    # the update of each leaf within 1e-2 of its largest: at this seed the
    # port's f32 update differs from its own f64 run by up to 1.6e-3 of
    # that scale (a BN bias; the bottleneck amplifies rounding) and JAX's
    # f32 update from the port's f64 one by 4.7e-3
    before, after = _np(st0.params), _np(st1.params)
    mine = jax_params_from_named(got.params(), SPEC)
    for (path, g), b, a in zip(jax.tree_util.tree_leaves_with_path(mine),
                               jax.tree.leaves(before),
                               jax.tree.leaves(after)):
        if "'b'" in jax.tree_util.keystr(path):
            continue  # conv biases: rounding noise, as above
        np.testing.assert_allclose(
            g - b, a - b, rtol=0, atol=1e-2 * np.abs(a - b).max(),
            err_msg=jax.tree_util.keystr(path))


def test_predictor_matches_jax_predictor():
    """5 images at batch 2 (two full chunks and a padded one), f32."""
    v = _variables(seed=6)
    imgs = np.random.default_rng(7).integers(0, 256, (5,) + HW + (3,),
                                             dtype=np.uint8)
    want = JaxPredictor("segnet", jax.tree.map(jnp.asarray, v),
                        batch_size=2, image_hw=HW,
                        compute_dtype=jnp.float32).predict(imgs)
    with Predictor("segnet", state_dict_from_jax_variables(v), batch_size=2,
                   image_hw=HW, device="cpu",
                   compute_dtype=torch.float32) as p:
        got = p.predict(imgs)
        with torch.no_grad():
            logits = p.model(to_tensor_normalize(
                torch.from_numpy(imgs), settings.MEAN, settings.STD))
    assert got.shape == want.shape == (5,) + HW and got.dtype == np.uint8
    # classes agree wherever the decision is not a near tie
    top2 = torch.topk(logits, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1] > 1e-3).numpy()
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got[clear], want[clear])


def test_width_005_builds_loads_and_runs():
    """SegNet has no concat, so the JAX package's UNet-derived width check
    (which refuses 0.05) does not apply: every internal count scales to
    max(4, round(c * 0.05)). The Predictor rebuilds it from the
    state_dict's conv shapes alone."""
    model = get_model("segnet", 3, 12, width_mult=0.05,
                      generator=torch.Generator().manual_seed(0))
    assert model.spec[0][1] == [(3, 4), (4, 4)]          # 64 * 0.05 = 3.2
    assert model.spec[3][1][0] == (13, 26)                # 256, 512
    assert model.spec[-1][1][-1] == (4, 12)
    sd = model.state_dict()
    again = get_model("segnet", spec=spec_from_state_dict("segnet", sd))
    again.load_state_dict(sd, strict=True)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 36, 44, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(again.eval()(x), model.eval()(x))
    with Predictor("segnet", sd, batch_size=2, image_hw=(36, 44),
                   device="cpu", compute_dtype=torch.float32) as p:
        out = p.predict(np.zeros((3, 36, 44, 3), np.uint8))
    assert out.shape == (3, 36, 44) and out.max() < 12
    with pytest.raises(ValueError, match="classes"):
        Predictor("segnet", sd, num_classes=11, device="cpu")


def test_serve_cli_segnet(tmp_path):
    cv2 = pytest.importorskip("cv2")
    model = get_model("segnet", 3, 12, width_mult=WIDTH,
                      generator=torch.Generator().manual_seed(0))
    weight = str(tmp_path / "segnet.pth")
    torch.save(model.state_dict(), weight)
    src = tmp_path / "imgs"
    src.mkdir()
    rng = np.random.default_rng(9)
    for name in ("a", "b"):
        cv2.imwrite(str(src / f"{name}.png"),
                    rng.integers(0, 256, (60, 88, 3), dtype=np.uint8))
    out = tmp_path / "masks"
    r = subprocess.run(
        [sys.executable, "-m", "pytorch_camvid_tpu_torch.serve", "-net",
         "segnet", "-weight", weight, "-input", str(src), "-output",
         str(out), "-b", "2", "-device", "cpu"], cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "served 2 images" in r.stdout
    for name in ("a", "b"):
        m = cv2.imread(str(out / f"{name}_mask.png"), cv2.IMREAD_GRAYSCALE)
        assert m is not None and m.shape == (360, 480) and m.max() < 12
