"""The port's data-parallel steps on the CPU against the JAX package's.

Two ranks (gloo, a ``file://`` rendezvous under a temporary directory),
spawned once for the module by ``parallel/launch.py::spawn``, run the
rank programs of ``torch_rank_programs.py`` (which import no JAX); four
ranks run the 2x2 multislice mesh. UNet at width 1/16, 32x32, a global
batch of 4, one SGD step at lr 1e-3, as the JAX package's
``tests/test_parallel.py``. On the JAX side the same numpy variables and
batch go through ``jit_train_step`` and ``shard_map_train_step`` on a
2-device mesh of the 8 virtual CPU devices."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pytorch_camvid_tpu.models.unet import apply_unet
from pytorch_camvid_tpu.parallel import (jit_eval_step as jax_jit_eval,
                                         jit_train_step as jax_jit_train,
                                         make_mesh as jax_make_mesh,
                                         shard_batch as jax_shard_batch,
                                         shard_map_eval_step as jax_sm_eval,
                                         shard_map_train_step as jax_sm_train)
from pytorch_camvid_tpu.parallel.mesh import DATA_AXIS
from pytorch_camvid_tpu.train import optim as joptim, schedules as jsched
from pytorch_camvid_tpu.train.state import TrainState as JaxTrainState
from pytorch_camvid_tpu.train.steps import (make_eval_step as jax_eval_step,
                                            make_train_step as jax_train_step)

from pytorch_camvid_tpu_torch.data.synthetic import synthetic_arrays
from pytorch_camvid_tpu_torch.interop.weights import (
    jax_params_from_named, jax_variables_from_model)
from pytorch_camvid_tpu_torch.models import get_model
from pytorch_camvid_tpu_torch.models.unet import scaled_spec
from pytorch_camvid_tpu_torch.parallel import launch, make_mesh
from pytorch_camvid_tpu_torch.serving import Predictor

import torch_rank_programs as programs

HW, N = (32, 32), 4
SPEC = scaled_spec(3, 12, programs.WIDTH)
APPLY = functools.partial(apply_unet, use_pallas=False)


def _variables(seed=0):
    """JAX-layout UNet variables as numpy: torch-default-scaled convs,
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


V = _variables()
IMAGES, LABELS = synthetic_arrays(N, HW, seed=1)
X = ((IMAGES.astype(np.float32) / 255.0 - 0.4) / 0.3).astype(np.float32)
Y = LABELS.astype(np.int64)
# 255 on rank 0's rows only: three quarters of image 0, half of image 1
Y255 = Y.copy()
Y255[0, :24] = 255
Y255[1, :, :16] = 255
VAL_IMAGES, VAL_LABELS = synthetic_arrays(5, HW, seed=2)


def _case(kind, mode=None, x=X, y=Y, **kw):
    return dict(kind=kind, mode=mode, variables=V, x=x, y=y, **kw)


CASES = {
    "inferred": _case("train", "inferred"),
    "explicit": _case("train", "explicit"),
    "inferred_255": _case("train", "inferred", y=Y255, ignore_index=255),
    "explicit_255": _case("train", "explicit", y=Y255, ignore_index=255),
    "eval_inferred": _case("eval", "inferred"),
    "eval_explicit": _case("eval", "explicit"),
    "augment": _case("train", "inferred", x=IMAGES, y=LABELS, augment=True),
    "accum": _case("train", "inferred", grad_accum=2),
    "padded_eval": _case("padded_eval", x=VAL_IMAGES, y=VAL_LABELS,
                         batch=4),
}


@pytest.fixture(scope="module")
def ranks():
    """Each rank's results of every case (one spawn of two ranks)."""
    return launch.spawn(programs.run_cases, 2, CASES)


@functools.lru_cache(maxsize=None)
def one_rank(name):
    """The case on one rank without a process group: the global batch."""
    return programs.run_case(make_mesh(), CASES[name])


@functools.lru_cache(maxsize=None)
def jax_train(mode, ignore_index=None):
    """JAX's step on two devices: ``jit_train_step`` ("inferred") or
    ``shard_map_train_step`` ("explicit"); with ``ignore_index`` on the
    labels with 255 on rank 0's rows."""
    mesh = jax_make_mesh(2, devices=jax.devices()[:2])
    step = jax_train_step(APPLY, joptim.sgd(), jsched.constant_lr(1e-3),
                          ignore_index=ignore_index, log_grad_norms=False,
                          axis_name=DATA_AXIS if mode == "explicit" else None)
    wrap = jax_sm_train if mode == "explicit" else jax_jit_train
    labels = Y if ignore_index is None else Y255
    st, m = wrap(step, mesh)(JaxTrainState.create(V, joptim.sgd()),
                             jax_shard_batch((jnp.asarray(X),
                                              jnp.asarray(labels)), mesh))
    return jax.tree.map(np.asarray, st), float(m["loss"])


def _jax_tree(named):
    return jax_params_from_named({k: torch.from_numpy(v)
                                  for k, v in named.items()}, SPEC)


def _bn_tree(buffers):
    """The port's running stats in the JAX state tree's layout."""
    model = get_model("unet", 3, 12, width_mult=programs.WIDTH)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           buffers.items()}, strict=False)
    return jax_variables_from_model(model)["state"]


def _grads_close(got, want, rel=1e-4):
    """Each gradient within ``rel`` of its leaf's max|want|; a conv bias
    (exactly zero before train-mode BN: rounding noise on both sides) at
    the scale of its conv weight's gradient."""
    for k, g in want.items():
        scale = want[k[:-len("bias")] + "weight"] if k.endswith(
            ".0.bias") else g
        np.testing.assert_allclose(got[k], g, rtol=0,
                                   atol=rel * np.abs(scale).max(), err_msg=k)


def _assert_matches_jax(got, want_state, want_loss):
    np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
    for a, b in zip(jax.tree.leaves(_jax_tree(got["params"])),
                    jax.tree.leaves(want_state.params)):
        np.testing.assert_allclose(a, b, atol=1e-5)
    for a, b in zip(jax.tree.leaves(_bn_tree(got["buffers"])),
                    jax.tree.leaves(want_state.bn_state)):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_inferred_step_matches_jax_jit_train_step(ranks):
    want_state, want_loss = jax_train("inferred")
    for r in ranks:
        _assert_matches_jax(r["inferred"], want_state, want_loss)
    # the ranks end bit-equal
    assert ranks[0]["inferred"]["sha256"] == ranks[1]["inferred"]["sha256"]


def test_explicit_step_matches_jax_shard_map_train_step(ranks):
    want_state, want_loss = jax_train("explicit")
    for r in ranks:
        _assert_matches_jax(r["explicit"], want_state, want_loss)
    assert ranks[0]["explicit"]["sha256"] == ranks[1]["explicit"]["sha256"]


@pytest.mark.parametrize("mode", ["inferred", "explicit"])
def test_eval_steps_match_jax(ranks, mode):
    mesh = jax_make_mesh(2, devices=jax.devices()[:2])
    step = jax_eval_step(APPLY, 12, ignore_index=11,
                         axis_name=DATA_AXIS if mode == "explicit" else None)
    wrap = jax_sm_eval if mode == "explicit" else jax_jit_eval
    loss, cm = wrap(step, mesh)(JaxTrainState.create(V, joptim.sgd()),
                                jax_shard_batch((jnp.asarray(X),
                                                 jnp.asarray(Y)), mesh))
    for r in ranks:
        got = r[f"eval_{mode}"]
        np.testing.assert_array_equal(got["cm"], np.asarray(cm))
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)


def test_loss_denominator_with_uneven_ignore_labels(ranks):
    """255 falls on rank 0's rows only. Inferred: the global batch's loss
    and gradient (one rank's step on the whole batch, and JAX's
    ``jit_train_step``); explicit: the mean of the two ranks' means, as
    JAX's ``shard_map_train_step`` — a different number."""
    inferred, explicit = ranks[0]["inferred_255"], ranks[0]["explicit_255"]
    whole = one_rank("inferred_255")
    np.testing.assert_allclose(inferred["loss"], whole["loss"], rtol=1e-5)
    _grads_close(inferred["grads"], whole["grads"])
    for got, mode in ((inferred, "inferred"), (explicit, "explicit")):
        want_state, want_loss = jax_train(mode, 255)
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
        # the updates within 3e-2 of each leaf's largest, as
        # test_torch_train_step's grad_accum test holds them: with a
        # quarter of the pixels ignored, the two packages' gradients
        # differ by up to 0.7% of a leaf's scale (down1.0's BN bias, a
        # sum that cancels); the weighting of the ranks' pixels, which is
        # what this test is about, moves them by far more
        for path, a, b, v in zip(
                jax.tree_util.tree_leaves_with_path(want_state.params),
                jax.tree.leaves(_jax_tree(got["params"])),
                jax.tree.leaves(want_state.params),
                jax.tree.leaves(V["params"])):
            if "'b'" not in jax.tree_util.keystr(path):
                np.testing.assert_allclose(
                    a - v, b - v, rtol=0, atol=3e-2 * np.abs(b - v).max(),
                    err_msg=f"{mode} {jax.tree_util.keystr(path)}")
    assert abs(inferred["loss"] - explicit["loss"]) > 1e-3 * inferred["loss"]


def test_sync_bn_gradient_equals_global_batch_gradient(ranks):
    """With the moments synced, the summed gradient of two ranks is the
    one-rank gradient of the global batch, leaf by leaf; so are the
    running stats."""
    got, whole = ranks[1]["inferred"], one_rank("inferred")
    _grads_close(got["grads"], whole["grads"])
    for k, b in whole["buffers"].items():
        np.testing.assert_allclose(got["buffers"][k], b, atol=1e-6,
                                   err_msg=k)


def test_dp2_equals_dp1_with_augmentation(ranks):
    """Every rank draws for the global batch and keeps its rows, so two
    ranks augment as one rank does (the generators stay in step)."""
    got, whole = ranks[0]["augment"], one_rank("augment")
    np.testing.assert_allclose(got["loss"], whole["loss"], rtol=1e-5)
    for k, p in whole["params"].items():
        np.testing.assert_allclose(got["params"][k], p, atol=1e-5,
                                   err_msg=k)
    assert ranks[0]["augment"]["sha256"] == ranks[1]["augment"]["sha256"]


def test_multislice_2x2_equals_dp1():
    """Four ranks as 2 slices of 2: the sums run within a slice, then
    across; the step equals the one-rank step of the global batch."""
    names = ("inferred", "explicit")
    res = launch.spawn(programs.run_cases_multislice, 4,
                       {k: CASES[k] for k in names}, 2)
    for name in names:
        whole = one_rank("inferred")
        for r in res:
            np.testing.assert_allclose(r[name]["loss"], whole["loss"],
                                       rtol=1e-5)
            for k, p in whole["params"].items():
                np.testing.assert_allclose(r[name]["params"][k], p,
                                           atol=1e-5, err_msg=k)
        assert len({r[name]["sha256"] for r in res}) == 1


def test_grad_accum_with_dp_runs_finite(ranks):
    got = ranks[0]["accum"]
    assert np.isfinite(got["loss"])
    assert all(np.isfinite(p).all() for p in got["params"].values())
    assert ranks[0]["accum"]["sha256"] == ranks[1]["accum"]["sha256"]


def test_pad_to_batch_rows_are_dropped(ranks):
    """Five val images in batches of 4 on two ranks: the second batch is
    padded with three 255-labelled rows, which the loss and the confusion
    matrix drop, so the pass equals one rank's over the ragged batches."""
    whole = one_rank("padded_eval")
    for r in ranks:
        got = r["padded_eval"]
        assert got["n_batches"] == whole["n_batches"] == 2
        np.testing.assert_array_equal(got["cm"], whole["cm"])
        np.testing.assert_allclose(got["loss_sum"], whole["loss_sum"],
                                   rtol=1e-5)


@pytest.mark.parametrize("net", ["unet", "segnet"])
def test_predictor_replicas_equal_one_device(net):
    """``Predictor(devices=["cpu", "cpu"])``: two replicas, each batch of
    4 split 2 + 2 and joined in order, the same class maps as one."""
    torch.set_num_threads(1)
    model = get_model(net, 3, 12, width_mult=programs.WIDTH,
                      generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    images, _ = synthetic_arrays(6, (64, 64), seed=3)
    kw = dict(batch_size=4, image_hw=(64, 64), device="cpu",
              compute_dtype=torch.float32)
    with Predictor(net, sd, **kw) as one, \
            Predictor(net, sd, devices=["cpu", "cpu"], **kw) as two:
        assert len(two.replicas) == 2
        np.testing.assert_array_equal(two.predict(images),
                                      one.predict(images))
    with pytest.raises(ValueError, match="divide over the 3 replicas"):
        Predictor(net, sd, devices=["cpu"] * 3, **kw)


def test_chain_train_step_is_k_steps():
    """``jit_chain_train_step``: k steps gathered from the resident split
    in one call, bit-equal to k calls of the step on the same batches."""
    from pytorch_camvid_tpu_torch.parallel import (jit_chain_train_step,
                                                   jit_train_step)
    from pytorch_camvid_tpu_torch.train import make_train_step, sgd
    from pytorch_camvid_tpu_torch.train import schedules
    torch.set_num_threads(1)
    mesh = make_mesh()
    images, labels = torch.from_numpy(X), torch.from_numpy(Y)
    idx = np.array([[3, 1], [0, 2]])
    step = make_train_step(sgd(), schedules.constant_lr(1e-3),
                           log_grad_norms=False)
    got, ms = jit_chain_train_step(step, mesh)(programs.port_state(V),
                                               images, labels, idx)
    want = programs.port_state(V)
    losses = []
    for ix in idx:
        want, m = jit_train_step(step, mesh)(want, (images[ix], labels[ix]))
        losses.append(float(m["loss"]))
    assert ms["loss"].tolist() == losses and got.step == want.step == 2
    for (k, a), b in zip(got.params().items(), want.params().values()):
        assert torch.equal(a, b), k
