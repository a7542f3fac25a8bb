"""The port's training slice against the JAX package, on the CPU, in f32.

UNet at width 1/16 on 45x60 (odd pools, so the decoder pads), batch 2. A
JAX ``TrainState`` drawn from numpy is carried into the port by
``interop/weights.py::train_state_from_jax``; both packages then take the
same steps on the same batch. The JAX model runs with ``use_pallas=False``;
the port runs its kernel path, whose wrappers take their plain versions on
CPU tensors. Also here: the augmentation on JAX's own draws, the device
loader's batches, schedules, loss and metrics."""

import functools
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pytorch_camvid_tpu.data import augment as jaug
from pytorch_camvid_tpu.data.pipeline import DeviceDataLoader as JaxLoader
from pytorch_camvid_tpu.models.unet import apply_unet
from pytorch_camvid_tpu.ops import loss as jloss, metrics as jmetrics
from pytorch_camvid_tpu.train import optim as joptim, schedules as jsched
from pytorch_camvid_tpu.train.state import TrainState as JaxTrainState
from pytorch_camvid_tpu.train.steps import (make_eval_step as jax_eval_step,
                                            make_train_step as jax_train_step)

from pytorch_camvid_tpu_torch.data import augment
from pytorch_camvid_tpu_torch.data.pipeline import DeviceDataLoader
from pytorch_camvid_tpu_torch.data.synthetic import synthetic_arrays
from pytorch_camvid_tpu_torch.interop.weights import (
    jax_params_from_named, jax_variables_from_model, named_from_jax_params,
    train_state_from_jax)
from pytorch_camvid_tpu_torch.models.unet import UNet, scaled_spec
from pytorch_camvid_tpu_torch.ops import loss, metrics
from pytorch_camvid_tpu_torch.train import (adamw, make_eval_step,
                                            make_train_step, schedules, sgd)
from pytorch_camvid_tpu_torch.train.steps import loss_and_grads

WIDTH, HW, BATCH = 1 / 16, (45, 60), 2
SPEC = scaled_spec(3, 12, WIDTH)
APPLY = functools.partial(apply_unet, use_pallas=False)


def _variables(seed=0):
    """JAX UNet variables as numpy (JAX's eager init is slow on the CPU):
    torch-default-scaled convs, non-trivial BN affine and running stats."""
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


def _batch(n=BATCH, seed=1):
    images, labels = synthetic_arrays(n, HW, seed=seed)
    x = ((images.astype(np.float32) / 255.0 - 0.4) / 0.3).astype(np.float32)
    return x, labels.astype(np.int64)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(jax_state):
    model = UNet(3, 12, width_mult=WIDTH)
    return train_state_from_jax(_np(jax_state), model)


def _leaves_close(got_tree, want_tree, rel, what):
    """Each leaf within ``rel`` of that leaf's max|want|."""
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got_tree),
                            jax.tree.leaves(want_tree)):
        w = np.asarray(w)
        np.testing.assert_allclose(
            np.asarray(g), w, rtol=0, atol=rel * max(np.abs(w).max(), 1e-30),
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _conv_bias_free(tree):
    """The params tree without conv biases: before train-mode BN their
    exact gradient is zero, so both packages hold rounding noise there."""
    return {s: [{k: v for k, v in b.items() if k != "b"} for b in blks]
            for s, blks in tree.items()}


def _port_stats(model):
    return jax_variables_from_model(model)["state"]


def test_one_step_loss_grads_and_bn_state_match_jax():
    v = _variables()
    x, y = _batch()

    def loss_fn(p, bn):
        logits, nb = APPLY({"params": p, "state": bn}, jnp.asarray(x),
                           train=True)
        return jloss.cross_entropy_loss(logits, jnp.asarray(y)), nb

    (want_loss, want_bn), want_g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"], v["state"])

    state = _port(JaxTrainState(v["params"], v["state"], {}, 0, None))
    got_loss, grads = loss_and_grads(state.model, torch.from_numpy(x),
                                     torch.from_numpy(y))
    got_g = jax_params_from_named(grads, SPEC)
    # f32 on both sides, through 23 blocks forward and back: summation
    # order only
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    _leaves_close(_conv_bias_free(got_g), _conv_bias_free(_np(want_g)),
                  1e-3, "grad")
    for s, blks in got_g.items():  # conv biases at the scale of their dW
        for i, blk in enumerate(blks):
            np.testing.assert_allclose(
                blk["b"], np.asarray(want_g[s][i]["b"]), rtol=0,
                atol=1e-3 * np.abs(np.asarray(want_g[s][i]["w"])).max())
    _leaves_close(_port_stats(state.model), _np(want_bn), 1e-5, "BN state")


def _jax_run(v, opt, lr, beta1=None, steps=1, grad_accum=1, n=BATCH):
    """JAX's states after each of ``steps`` steps (numpy) and metrics."""
    x, y = _batch(n)
    step = jax.jit(jax_train_step(APPLY, opt, lr, beta1,
                                  grad_accum=grad_accum))
    st = JaxTrainState.create(v, opt)
    states, out = [_np(st)], []
    for _ in range(steps):
        st, m = step(st, (jnp.asarray(x), jnp.asarray(y)))
        states.append(_np(st))
        out.append(m)
    return states, out


def _port_run(jax_state, opt, lr, beta1=None, steps=1, grad_accum=1,
              n=BATCH):
    """The port's ``steps`` steps from a JAX state (numpy leaves)."""
    x, y = _batch(n)
    st = _port(jax_state)
    step = make_train_step(opt, lr, beta1, grad_accum=grad_accum)
    out = []
    for _ in range(steps):
        st, m = step(st, (torch.from_numpy(x), torch.from_numpy(y)))
        out.append(m)
    return st, out


def _updates_close(got, before, after, rel, what):
    """The step's update of each leaf (conv biases aside: their gradient is
    rounding noise) within ``rel`` of the leaf's largest update."""
    for (path, g), b, a in zip(jax.tree_util.tree_leaves_with_path(got),
                               jax.tree.leaves(before),
                               jax.tree.leaves(after)):
        if "'b'" in jax.tree_util.keystr(path):
            continue
        np.testing.assert_allclose(
            np.asarray(g) - b, a - b, rtol=0, atol=rel * np.abs(a - b).max(),
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def test_sgd_nesterov_three_steps_match_jax():
    """Free-running, the 3-step loss curves agree. A UNet this small with
    batch-stat BN is chaotic at float-noise scale: JAX against itself, a
    1e-6 relative parameter change along the direction the two packages'
    roundings differ moves the next gradient by up to ~15% (lr 0.05), so
    the parameters are held step by step, each port step taken from JAX's
    state before it: the nesterov update with its first-step momentum
    buffer, and the BN state threaded through."""
    v = _variables(seed=2)
    states, wm = _jax_run(v, joptim.sgd(), jsched.constant_lr(1e-3),
                          steps=3)
    _, gm = _port_run(states[0], sgd(), schedules.constant_lr(1e-3),
                      steps=3)
    for a, b in zip(gm, wm):
        # free-running over 3 steps at lr 1e-3: measured 5e-7
        np.testing.assert_allclose(float(a["loss"]), float(b["loss"]),
                                   rtol=1e-5)
    states, wm = _jax_run(v, joptim.sgd(), jsched.constant_lr(0.05),
                          steps=3)
    for k in range(3):
        got, gm = _port_run(states[k], sgd(), schedules.constant_lr(0.05))
        assert got.step == int(states[k + 1].step) == k + 1
        # from the same state the gradients agree to ~1e-4 of their scale
        # (the one-step test above), and so do the updates and momentum
        _updates_close(jax_params_from_named(got.params(), SPEC),
                       states[k].params, states[k + 1].params, 1e-3,
                       f"step {k} update")
        _leaves_close(_conv_bias_free(jax_params_from_named(
            got.opt_state["buf"], SPEC)),
            _conv_bias_free(states[k + 1].opt_state["buf"]), 1e-3,
            f"step {k} momentum")
        _leaves_close(_port_stats(got.model), states[k + 1].bn_state, 1e-5,
                      f"step {k} BN state")
        np.testing.assert_allclose(float(gm[0]["grad_norm_w"]),
                                   float(wm[k]["grad_norm_w"]), rtol=1e-4)


def test_adamw_onecycle_one_step_matches_jax():
    v = _variables(seed=3)
    total = 10
    states, wm = _jax_run(v, joptim.adamw(),
                          jsched.onecycle_lr(5e-3, total),
                          jsched.onecycle_beta1(total))
    want = states[1]
    got, gm = _port_run(states[0], adamw(),
                        schedules.onecycle_lr(5e-3, total),
                        schedules.onecycle_beta1(total))
    np.testing.assert_allclose(gm[0]["lr"], float(wm[0]["lr"]), rtol=1e-6)
    np.testing.assert_allclose(gm[0]["beta1"], float(wm[0]["beta1"]),
                               rtol=1e-6)
    lr = float(wm[0]["lr"])
    # m = (1 - beta1) g and v = (1 - beta2) g^2: as tight as the gradients
    m_got = jax_params_from_named(got.opt_state["m"], SPEC)
    v_got = jax_params_from_named(got.opt_state["v"], SPEC)
    _leaves_close(_conv_bias_free(m_got),
                  _conv_bias_free(_np(want.opt_state["m"])), 1e-3, "m")
    _leaves_close(_conv_bias_free(v_got),
                  _conv_bias_free(_np(want.opt_state["v"])), 2e-3, "v")
    # AdamW's first step moves each entry by lr * g / (|g| + eps'), about
    # lr * sign(g): where |g| is near zero (the conv biases, noise) the two
    # packages may step in opposite directions, so parameters are held to
    # 2 lr everywhere and to 1e-3 lr where |g| > 1e-3 of the leaf's max
    p_got = jax_params_from_named(got.params(), SPEC)
    p_want = _np(want.params)
    g_want = _np(want.opt_state["m"])
    for (path, a), b, m in zip(jax.tree_util.tree_leaves_with_path(p_got),
                               jax.tree.leaves(p_want),
                               jax.tree.leaves(g_want)):
        d = np.abs(a - b)
        assert d.max() <= 2 * lr, jax.tree_util.keystr(path)
        big = np.abs(m) > 1e-3 * np.abs(m).max()
        if "'b'" not in jax.tree_util.keystr(path):
            assert d[big].max() <= 1e-3 * lr, jax.tree_util.keystr(path)


def test_grad_accum_two_microbatches_matches_jax():
    """BN normalizes each microbatch by its own stats and the running
    stats are threaded microbatch by microbatch, as JAX's scan does."""
    v = _variables(seed=4)
    states, wm = _jax_run(v, joptim.sgd(), jsched.constant_lr(0.05),
                          grad_accum=2, n=4)
    got, gm = _port_run(states[0], sgd(), schedules.constant_lr(0.05),
                        grad_accum=2, n=4)
    np.testing.assert_allclose(float(gm[0]["loss"]), float(wm[0]["loss"]),
                               rtol=1e-5)
    # the second microbatch's gradients alone already differ by up to
    # 1.3% of their scale between the packages at this seed (measured
    # with loss_and_grads at the same parameters), so the update is held
    # to 3e-2 of its scale; the running stats, threaded microbatch by
    # microbatch, are held tightly
    _updates_close(jax_params_from_named(got.params(), SPEC),
                   states[0].params, states[1].params, 3e-2, "update")
    _leaves_close(_port_stats(got.model), states[1].bn_state, 1e-5,
                  "BN state")


def test_eval_step_matches_jax():
    v = _variables(seed=5)
    x, y = _batch(seed=6)
    y[0, :3] = 255                         # pad sentinel, dropped by both
    want_loss, want_cm = jax.jit(jax_eval_step(
        APPLY, 12, ignore_index=11, loss_ignore_index=(11, 255)))(
        JaxTrainState(v["params"], v["state"], {}, 0, None),
        (jnp.asarray(x), jnp.asarray(y)))
    st = _port(JaxTrainState(v["params"], v["state"], {}, 0, None))
    got_loss, got_cm = make_eval_step(12, ignore_index=11,
                                      loss_ignore_index=(11, 255))(
        st, (torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    # the argmax of logits that agree to ~1e-6 (no near ties at this seed)
    np.testing.assert_array_equal(got_cm.numpy(), np.asarray(want_cm))
    assert got_cm.sum() == np.sum((y != 11) & (y != 255))


def test_eval_step_keeps_prepared_kernel_weights_until_a_train_step():
    """The eval step switches the model to eval mode only when it is
    training, so every block's prepared kernel arguments (BN folded, the
    kernel's weight layout) are the same tensor objects on a second eval
    batch; the next train step (train mode) drops them."""
    v = _variables(seed=8)
    x, y = _batch(seed=9)
    st = _port(JaxTrainState(v["params"], v["state"], {}, 0, None))
    ev = make_eval_step(12)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    blocks = [m for m in st.model.modules() if hasattr(m, "_kernel_args")]
    assert len(blocks) == 23 and st.model.training
    loss1, cm1 = ev(st, batch)
    first = [b._kernel_args for b in blocks]
    assert all(a is not None for a in first) and not st.model.training
    loss2, cm2 = ev(st, batch)
    assert all(b._kernel_args is a for b, a in zip(blocks, first))
    assert float(loss1) == float(loss2) and torch.equal(cm1, cm2)
    opt = sgd()
    st.opt_state = opt.init(st.params())
    st, _ = make_train_step(opt, schedules.constant_lr(1e-3))(st, batch)
    assert st.model.training
    assert all(b._kernel_args is None for b in blocks)


# ------------------------------------------------------------ augmentation

def _images(n=3, hw=(12, 17), seed=7):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n,) + hw + (3,), dtype=np.uint8),
            rng.integers(0, 12, (n,) + hw, dtype=np.uint8))


def _jax_draws(key, n, cfg):
    """The draws JAX's make_train_augment takes from ``key``, by the same
    splits (data/augment.py:515, rotation :131-149, scale :154-174, blur
    :285-287, flip :244, jitter :427-456)."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    d = {}
    if cfg.rotation_angle and cfg.rotation_p < 1.0:
        kr1, kr2 = jax.random.split(k1)
        apply = jax.random.uniform(kr1, (n,)) >= cfg.rotation_p
        angle = jax.random.uniform(kr2, (n,), minval=-cfg.rotation_angle,
                                   maxval=cfg.rotation_angle)
        d["rotation_apply"] = apply
        d["rotation_angle"] = jnp.where(apply, angle, 0.0)
    if cfg.random_scale:
        ks, ko = jax.random.split(k5)
        u1, u2 = jax.random.split(ko)
        d["scale_s"] = jax.random.uniform(ks, (n,), minval=cfg.scale_range[0],
                                          maxval=cfg.scale_range[1])
        d["scale_uy"] = jax.random.uniform(u1, (n,))
        d["scale_ux"] = jax.random.uniform(u2, (n,))
    kb1, kb2 = jax.random.split(k2)
    d["blur_apply"] = jax.random.uniform(kb1, (n,)) < cfg.blur_p
    d["blur_sigma"] = jax.random.uniform(kb2, (n,), minval=0.0, maxval=3.0)
    d["flip"] = jax.random.uniform(k3, (n,)) < cfg.hflip_p
    k0, kb, kc, ks, kh, kp = jax.random.split(k4, 6)
    apply = jax.random.uniform(k0, (n,)) >= cfg.jitter_p

    def factor(k, v):
        f = jax.random.uniform(k, (n,), minval=max(0.0, 1.0 - v),
                               maxval=1.0 + v)
        return jnp.where(apply, f, 1.0)

    ops = 0
    for name, k, v in (("brightness", kb, cfg.jitter_brightness),
                       ("contrast", kc, cfg.jitter_contrast),
                       ("saturation", ks, cfg.jitter_saturation)):
        if v:
            d[name] = factor(k, v)
            ops += 1
    if cfg.jitter_hue:
        f = jax.random.uniform(kh, (n,), minval=-cfg.jitter_hue,
                               maxval=cfg.jitter_hue)
        d["hue"] = jnp.where(apply, f, 0.0)
        ops += 1
    if ops > 1 and cfg.jitter_random_order:
        d["jitter_perm"] = jax.random.randint(kp, (n,), 0,
                                              math.factorial(ops))
    return {k: torch.from_numpy(np.array(a)) for k, a in d.items()}


@pytest.mark.parametrize("contrast", [0.0, 0.4], ids=["recipe", "contrast"])
def test_train_augment_on_jax_draws_equals_jax(contrast):
    """The whole recipe (blur, flip, jitter, normalize) on JAX's draws:
    the uint8-valued images before normalize are equal, so the normalized
    f32 images are equal too."""
    imgs, masks = _images(n=6)
    cfg = jaug.AugmentConfig(mean=(0.4, 0.41, 0.42), std=(0.3, 0.31, 0.32),
                             jitter_contrast=contrast)
    key = jax.random.PRNGKey(11)
    want_x, want_m = jaug.make_train_augment(cfg)(key, jnp.asarray(imgs),
                                                  jnp.asarray(masks))
    pcfg = augment.AugmentConfig(**cfg._asdict())
    got_x, got_m = augment.augment_with_draws(
        pcfg, torch.from_numpy(imgs), torch.from_numpy(masks),
        _jax_draws(key, 6, cfg))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))


def test_blur_brightness_contrast_flip_cores_equal_jax():
    imgs, masks = _images()
    x = imgs.astype(np.float32)
    n = len(imgs)
    key = jax.random.PRNGKey(3)
    # blur: JAX's draws for this key, then the port on the same draws
    want, _ = jaug.random_gaussian_blur(key, jnp.asarray(x),
                                        jnp.asarray(masks), 1.0)
    k1, k2 = jax.random.split(key)
    apply = torch.from_numpy(np.array(jax.random.uniform(k1, (n,)) < 1.0))
    sigma = torch.from_numpy(np.array(jax.random.uniform(
        k2, (n,), minval=0.0, maxval=3.0)))
    got = augment.gaussian_blur(torch.from_numpy(x), sigma, apply)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    f = np.array([0.6, 1.0, 1.3999], np.float32)
    for jfn, pfn in ((jaug._adjust_brightness, augment.adjust_brightness),
                     (jaug._adjust_contrast, augment.adjust_contrast)):
        np.testing.assert_array_equal(
            pfn(torch.from_numpy(x), torch.from_numpy(f)).numpy(),
            np.asarray(jfn(jnp.asarray(x), jnp.asarray(f))))
    wi, wm = jaug.random_hflip(key, jnp.asarray(imgs), jnp.asarray(masks))
    flip = torch.from_numpy(np.array(jax.random.uniform(key, (n,)) < 0.5))
    gi, gm = augment.hflip(torch.from_numpy(imgs), torch.from_numpy(masks),
                           flip)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


def test_augment_sampler_and_unported_options():
    imgs, masks = _images(n=64)
    cfg = augment.AugmentConfig()
    fn = augment.make_train_augment(cfg)
    g = torch.Generator().manual_seed(0)
    x, m = fn(g, torch.from_numpy(imgs), torch.from_numpy(masks))
    assert x.dtype == torch.float32 and m.dtype == torch.int64
    d = augment.sample_draws(torch.Generator().manual_seed(0), 4000, cfg,
                             "cpu")
    # 4000 draws: rates within ~5 standard errors of p
    assert abs(d["blur_apply"].float().mean() - 0.5) < 0.04
    assert abs(d["flip"].float().mean() - 0.5) < 0.04
    assert abs((d["brightness"] == 1).float().mean() - 0.4) < 0.04
    assert 0 <= d["blur_sigma"].min() and d["blur_sigma"].max() < 3
    b = d["brightness"][d["brightness"] != 1]
    assert 0.6 <= b.min() and b.max() < 1.4
    # the options once refused now run: each on a batch, finite values,
    # masks within the classes and the fills
    for opt in (dict(rotation_p=0.5), dict(random_scale=True),
                dict(jitter_saturation=0.4), dict(jitter_hue=0.1)):
        x, m = augment.make_train_augment(augment.AugmentConfig(**opt))(
            torch.Generator().manual_seed(1), torch.from_numpy(imgs),
            torch.from_numpy(masks))
        assert x.shape == imgs.shape and torch.isfinite(x).all(), opt
        assert m.shape == masks.shape and int(m.max()) <= 11, opt


def test_device_loader_batches_equal_jax():
    imgs, masks = _images(n=11, hw=(4, 5))
    want = JaxLoader(imgs, masks, 3, shuffle=True, seed=5, drop_last=True)
    got = DeviceDataLoader(imgs, masks, 3, shuffle=True, seed=5,
                           drop_last=True, device="cpu")
    assert len(got) == len(want) == 3
    for e in range(2):
        for (gi, gl), (wi, wl) in zip(got.epoch(e), want.epoch(e)):
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
            np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(got.epoch_indices(4),
                                  want.epoch_indices(4))
    # without drop_last the last batch is the ragged tail, as in JAX
    tail = DeviceDataLoader(imgs, masks, 4, device="cpu")
    assert [b[0].shape[0] for b in tail] == [4, 4, 3]


# ------------------------------------------------- schedules, loss, metrics

@pytest.mark.parametrize("name,args", [
    ("onecycle_lr", (5e-4, 37)), ("onecycle_beta1", (37,)),
    ("warmup_lr", (0.1, 9)), ("multistep_lr", (0.1, (3, 7), 0.2)),
    ("exponential_sweep_lr", (1e-7, 10.0, 37)), ("constant_lr", (3e-4,)),
    ("warmup_then_multistep", (0.1, 5, (2, 3), 4))])
def test_schedules_match_jax(name, args):
    want_fn = getattr(jsched, name)(*args)
    got_fn = getattr(schedules, name)(*args)
    steps = np.arange(40)
    want = np.asarray(jax.jit(jax.vmap(want_fn))(jnp.asarray(steps)))
    got = np.array([got_fn(int(s)) for s in steps], np.float32)
    # float32 on both sides; numpy's and XLA's cos and pow may differ by
    # a few ulps
    np.testing.assert_allclose(got, want, rtol=5e-6, atol=0)


def test_cross_entropy_weights_and_ignore_tuple_match_jax():
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(2, 5, 6, 12)).astype(np.float32)
    labels = rng.integers(0, 12, (2, 5, 6))
    labels[0, 0] = 255
    w = rng.uniform(0.5, 2.0, 12).astype(np.float32)
    for cw, ig in ((None, None), (w, 11), (w, (11, 255)), (None, (3, 255))):
        # labels out of [0, 12) occur only where they are ignored
        keep = ig is not None and 255 in np.atleast_1d(ig)
        labels_ = labels if keep else np.where(labels == 255, 0, labels)
        want = float(jloss.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(labels_),
            None if cw is None else jnp.asarray(cw), ig))
        got = float(loss.cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(labels_),
            None if cw is None else torch.from_numpy(cw), ig))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_confusion_matrix_and_derived_metrics_match_jax():
    rng = np.random.default_rng(9)
    preds = rng.integers(0, 5, (3, 7, 8))
    labels = rng.integers(0, 5, (3, 7, 8))
    labels[0, 0] = 255
    for ig in (None, 2):
        want = jmetrics.confusion_matrix(jnp.asarray(preds),
                                         jnp.asarray(labels), 5, ig)
        got = metrics.confusion_matrix(torch.from_numpy(preds),
                                       torch.from_numpy(labels), 5, ig)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for jfn, pfn in ((jmetrics.iou_from_confusion,
                      metrics.iou_from_confusion),
                     (jmetrics.accuracy_from_confusion,
                      metrics.accuracy_from_confusion),
                     (jmetrics.precision_recall_from_confusion,
                      metrics.precision_recall_from_confusion)):
        for a, b in zip(jax.tree.leaves(pfn(got)), jax.tree.leaves(jfn(want))):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6)


def test_train_state_round_trip_through_interop():
    """JAX TrainState -> port -> JAX layout gives back every leaf."""
    v = _variables(seed=10)
    rng = np.random.default_rng(11)
    m = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                     v["params"])
    jst = JaxTrainState(v["params"], v["state"], {"m": m, "v": m}, 7, None)
    st = train_state_from_jax(jst, UNet(3, 12, width_mult=WIDTH))
    assert st.step == 7 and set(st.opt_state) == {"m", "v"}
    back = jax_variables_from_model(st.model)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(jax_params_from_named(
            st.opt_state["m"], SPEC)), jax.tree.leaves(m)):
        np.testing.assert_array_equal(a, b)
    assert set(named_from_jax_params(m)) == set(st.params())
