"""The port's checkpoints (``train/checkpoint.py``) on the CPU: the JAX
package's ``.ckpt.npz`` read without jax, the port's own round trip, the
structure checks, the discovery rules against the JAX package's, and
``Predictor.from_checkpoint`` on every format. UNet at width 1/16."""

import functools
import os
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pytorch_camvid_tpu.models.unet import apply_unet
from pytorch_camvid_tpu.train import checkpoint as jckpt
from pytorch_camvid_tpu.train import optim as joptim, schedules as jsched
from pytorch_camvid_tpu.train.state import TrainState as JaxTrainState
from pytorch_camvid_tpu.train.steps import make_train_step as jax_train_step

from pytorch_camvid_tpu_torch.data.augment import (AugmentConfig,
                                                   make_train_augment)
from pytorch_camvid_tpu_torch.data.synthetic import synthetic_arrays
from pytorch_camvid_tpu_torch.interop.weights import train_state_from_jax
from pytorch_camvid_tpu_torch.models.segnet import SegNet
from pytorch_camvid_tpu_torch.models.unet import UNet, scaled_spec
from pytorch_camvid_tpu_torch.serving import Predictor
from pytorch_camvid_tpu_torch.train import (TrainState, adamw,
                                            make_train_step, onecycle_beta1,
                                            onecycle_lr, sgd)
from pytorch_camvid_tpu_torch.train import checkpoint as ckpt

WIDTH, HW = 1 / 16, (32, 48)
SPEC = scaled_spec(3, 12, WIDTH)
APPLY = functools.partial(apply_unet, use_pallas=False)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny ops: one intra-op thread. Several test workers share the cores,
    and spinning thread pools then stall small ops for seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_variables(seed=0):
    """JAX UNet variables (numpy, f32): torch-default-scaled convs and a
    non-trivial BN affine and running stats."""
    rng = np.random.default_rng(seed)
    params, state = {}, {}
    for stage, pairs in SPEC:
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


def _x(n=2, seed=1):
    images, labels = synthetic_arrays(n, HW, seed=seed)
    x = ((images.astype(np.float32) / 255.0 - 0.4) / 0.3).astype(np.float32)
    return x, labels.astype(np.int32)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """(path, numpy state) of a JAX TrainState after one AdamW step, saved
    by the JAX package's save_checkpoint."""
    opt = joptim.adamw()
    st = JaxTrainState.create(_jax_variables(), opt)
    step = jax.jit(jax_train_step(APPLY, opt, jsched.onecycle_lr(5e-3, 10),
                                  jsched.onecycle_beta1(10)))
    x, y = _x()
    st, _ = step(st, (jnp.asarray(x), jnp.asarray(y)))
    path = str(tmp_path_factory.mktemp("jax") / "1-best.ckpt.npz")
    jckpt.save_checkpoint(path, st, {"epoch": 1, "miou": 0.5,
                                     "net": "unet"})
    return path, jax.tree.map(np.asarray, st)


def _port_state(seed=0, model=None, opt=None):
    model = model or UNet(3, 12, width_mult=WIDTH,
                          generator=torch.Generator().manual_seed(seed))
    return TrainState.create(model, opt or adamw(), seed=seed)


def _assert_states_equal(got: TrainState, want: TrainState):
    sd_g, sd_w = got.model.state_dict(), want.model.state_dict()
    assert list(sd_g) == list(sd_w)
    for k in sd_w:
        assert torch.equal(sd_g[k], sd_w[k]), k
    assert sorted(got.opt_state) == sorted(want.opt_state)
    for key, tensors in want.opt_state.items():
        for n, t in tensors.items():
            assert torch.equal(got.opt_state[key][n], t), (key, n)
    assert got.step == want.step


def test_jax_checkpoint_loads_bit_for_bit(jax_checkpoint):
    path, jstate = jax_checkpoint
    want = train_state_from_jax(jstate, UNet(3, 12, width_mult=WIDTH))
    got, meta = ckpt.load_checkpoint(path, _port_state(seed=5))
    assert meta == {"epoch": 1, "miou": 0.5, "net": "unet"}
    assert got.step == 1
    _assert_states_equal(got, want)
    # the moments are those of a real step, not zeros
    assert all(t.abs().max() > 0 for t in got.opt_state["m"].values()
               if t.dim() > 1)
    # the JAX PRNG key has no torch counterpart: seeded as
    # train_state_from_jax seeds it
    assert torch.equal(got.generator.get_state(),
                       torch.Generator().manual_seed(0).get_state())

    # the eval forward against JAX's on the same weights
    x, _ = _x(seed=4)
    want_logits, _ = jax.jit(lambda v, a: APPLY(v, a, train=False))(
        {"params": jstate.params, "state": jstate.bn_state}, jnp.asarray(x))
    want_logits = np.asarray(want_logits)
    got.model.eval()
    with torch.no_grad():
        got_logits = got.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_logits, want_logits, rtol=0,
                               atol=1e-4 * np.abs(want_logits).max())

    # the weights alone, at the checkpoint's own width
    sd = ckpt.load_weights(path, "unet")
    for k, t in want.model.state_dict().items():
        assert torch.equal(sd[k], t.cpu()), k


def test_jax_checkpoint_into_a_wrong_template_raises(jax_checkpoint):
    path, _ = jax_checkpoint
    for state in (_port_state(model=UNet(3, 12, width_mult=1 / 8)),
                  _port_state(model=SegNet(3, 12, width_mult=WIDTH)),
                  _port_state(opt=sgd())):
        with pytest.raises(ValueError):
            ckpt.load_checkpoint(path, state)


def _stepped_state(seed=0, steps=2):
    """A port state after ``steps`` AdamW steps with the augmentation, so
    the moments, the step and the generator have all moved."""
    state = _port_state(seed)
    images, labels = synthetic_arrays(2, HW, seed=seed)
    step = make_train_step(adamw(), onecycle_lr(5e-3, 10),
                           onecycle_beta1(10),
                           augment_fn=make_train_augment(AugmentConfig(
                               mean=(0.4,) * 3, std=(0.3,) * 3)))
    for _ in range(steps):
        state, _ = step(state, (torch.from_numpy(images),
                                torch.from_numpy(labels)))
    return state


def test_round_trip_is_bit_for_bit_with_the_generator(tmp_path):
    saved = _stepped_state()
    path = ckpt.checkpoint_name(str(tmp_path / "run"), 3, "regular")
    meta = {"epoch": 3, "miou": 0.25, "net": "unet",
            "preempted_in_epoch": 4, "resume_batch_idx": 1}
    ckpt.save_checkpoint(path, saved, meta)
    assert os.listdir(tmp_path / "run") == ["3-regular.ckpt.npz"]

    got, got_meta = ckpt.load_checkpoint(path, _port_state(seed=9))
    assert got_meta == meta and got.step == 2
    _assert_states_equal(got, saved)
    assert torch.equal(got.generator.get_state(),
                       saved.generator.get_state())
    assert torch.equal(torch.rand(8, generator=got.generator),
                       torch.rand(8, generator=saved.generator))
    # the weights alone
    sd = ckpt.load_weights(path, "unet")
    for k, t in saved.model.state_dict().items():
        assert torch.equal(sd[k], t), k


def test_port_checkpoint_into_a_wrong_template_raises(tmp_path):
    path = str(tmp_path / "1-best.ckpt.npz")
    ckpt.save_checkpoint(path, _port_state())
    for state in (_port_state(model=UNet(3, 12, width_mult=1 / 8)),
                  _port_state(model=SegNet(3, 12, width_mult=WIDTH)),
                  _port_state(opt=sgd())):
        with pytest.raises(ValueError):
            ckpt.load_checkpoint(path, state)


@pytest.mark.parametrize("names", [
    ["a/3-regular.ckpt.npz", "b/5-best.ckpt.npz", "b/7-preempt.ckpt.npz"],
    ["a/2-best.pth", "a/notes.txt", "b/1-regular.ckpt.npz"],
    ["a/readme.ckpt.npz"]])
def test_discovery_rules_match_jax(tmp_path, names):
    for i, name in enumerate(names):
        p = tmp_path / name
        p.parent.mkdir(exist_ok=True)
        p.write_bytes(b"")
        t = time.time() - 100 + i
        os.utime(p, (t, t))
    root = str(tmp_path)
    assert ckpt.get_weight_path(root) == jckpt.get_weight_path(root)
    for name in names:
        try:
            want = jckpt.parse_epoch(name)
        except ValueError:
            with pytest.raises(ValueError):
                ckpt.parse_epoch(name)
        else:
            assert ckpt.parse_epoch(name) == want
    assert ckpt.checkpoint_name("c", 4, "preempt") == \
        jckpt.checkpoint_name("c", 4, "preempt")


def test_predictor_from_checkpoint_takes_every_format(tmp_path,
                                                      jax_checkpoint):
    state = _stepped_state()
    npz = str(tmp_path / "2-best.ckpt.npz")
    pth = str(tmp_path / "2-best.pth")
    ckpt.save_checkpoint(npz, state)
    torch.save(state.model.state_dict(), pth)
    images, _ = synthetic_arrays(3, HW, seed=7)
    kw = dict(batch_size=2, image_hw=HW, compute_dtype=torch.float32,
              device="cpu")
    maps = {}
    for path in (npz, pth, jax_checkpoint[0]):
        with Predictor.from_checkpoint("unet", path, **kw) as p:
            maps[path] = p.predict(images)
    np.testing.assert_array_equal(maps[npz], maps[pth])
    jax_model = train_state_from_jax(jax_checkpoint[1],
                                     UNet(3, 12, width_mult=WIDTH)).model
    with Predictor("unet", jax_model.state_dict(), **kw) as p:
        np.testing.assert_array_equal(maps[jax_checkpoint[0]],
                                      p.predict(images))
