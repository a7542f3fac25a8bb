"""Stage rematerialization (``make_train_step(remat=True)``) in the port
against the JAX package's ``jax.checkpoint`` per stage, on the CPU.

UNet at 48x64 and SegNet at 32x32 (the sizes of JAX's own
``tests/test_train_step.py::test_remat_step_matches_plain``; against JAX,
SegNet runs 36x44 in f32 and 48x64 in bf16, see there), both at width
1/16, batch 2 (4 with ``grad_accum=2``), AdamW with OneCycle, f32 and
bf16.
JAX's UNet runs ``use_pallas=False``; its SegNet trains on the TPU's
Pallas phase pair (``PCT_POOL_IMPL=pallas_phase``) in interpret mode, the
pair the port follows. The port's kernel wrappers run their plain versions
on CPU tensors. Also: the port's remat step bit for bit against its own
step without remat, the bytes autograd keeps, and the eval weights."""

import copy
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pytorch_camvid_tpu.models.segnet import apply_segnet
from pytorch_camvid_tpu.models.unet import apply_unet
from pytorch_camvid_tpu.ops import pallas_pool as pp
from pytorch_camvid_tpu.train import optim as joptim, schedules as jsched
from pytorch_camvid_tpu.train.state import TrainState as JaxTrainState
from pytorch_camvid_tpu.train.steps import make_train_step as jax_train_step

from pytorch_camvid_tpu_torch.data.synthetic import synthetic_arrays
from pytorch_camvid_tpu_torch.interop.weights import (
    jax_params_from_named, jax_variables_from_model, train_state_from_jax)
from pytorch_camvid_tpu_torch.models.segnet import SegNet
from pytorch_camvid_tpu_torch.models.unet import UNet
from pytorch_camvid_tpu_torch.train import (adamw, make_eval_step,
                                            make_train_step, schedules)

WIDTH = 1 / 16
NETS = {"unet": (UNet, functools.partial(apply_unet, use_pallas=False),
                 (48, 64)),
        "segnet": (SegNet, apply_segnet, (32, 32))}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOTAL_STEPS = 10   # OneCycle's length; one step is taken


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny ops: one intra-op thread (spinning pools slow tier-1's
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pallas_phase(monkeypatch):
    """JAX's TPU training pair on the CPU: selected by PCT_POOL_IMPL, its
    kernels in interpret mode (as tests/test_torch_segnet.py)."""
    monkeypatch.setenv("PCT_POOL_IMPL", "pallas_phase")
    for name in ("max_pool_2x2_phase_mxu", "max_unpool_2x2_phase_nat",
                 "_unpool_phase_grad_mxu"):
        monkeypatch.setattr(pp, name, functools.partial(
            getattr(pp, name), interpret=True))


def _variables(net, seed=0):
    """JAX variables as numpy: torch-default-scaled convs, non-trivial BN
    affine and running stats."""
    rng = np.random.default_rng(seed)
    params, state = {}, {}
    for stage, pairs in NETS[net][0](3, 12, width_mult=WIDTH).spec:
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


def _batch(hw, n, seed=1):
    images, labels = synthetic_arrays(n, hw, seed=seed)
    x = ((images.astype(np.float32) / 255.0 - 0.4) / 0.3).astype(np.float32)
    return x, labels.astype(np.int64)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_step(net, jax_state, x, y, dtype, grad_accum=1, remat=True,
               plain=False):
    """The port's state after one AdamW + OneCycle step from a JAX state
    (numpy leaves), and its metrics."""
    st = train_state_from_jax(jax_state,
                              NETS[net][0](3, 12, width_mult=WIDTH))
    step = make_train_step(adamw(weight_decay=0.0),
                           schedules.onecycle_lr(1e-3, TOTAL_STEPS),
                           schedules.onecycle_beta1(TOTAL_STEPS),
                           compute_dtype=dtype, grad_accum=grad_accum,
                           plain=plain, remat=remat)
    return step(st, (torch.from_numpy(x), torch.from_numpy(y)))


def _no_conv_bias(tree):
    """A params tree without conv biases: they feed train-mode BN, so their
    exact gradient is zero and each package holds its own rounding noise
    there, which AdamW's first step turns into an update of either sign."""
    return {s: [{k: v for k, v in b.items() if k != "b"} for b in blks]
            for s, blks in tree.items()}


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.mark.parametrize("net,dtype,grad_accum,hw,seed", [
    ("unet", "float32", 2, (48, 64), 0), ("unet", "bfloat16", 1, (48, 64), 0),
    ("segnet", "float32", 1, (36, 44), 3),
    ("segnet", "bfloat16", 1, (48, 64), 0)])
def test_remat_step_matches_jax_remat_step(net, dtype, grad_accum, hw, seed,
                                           monkeypatch):
    """One remat train step from the same state and batch in both
    packages: loss, gradients (AdamW's first moment after one update from
    zero is (1 - beta1) g), parameters after the update and BN running
    stats. f32 is held to JAX's own remat-vs-plain test (loss rel 1e-6,
    params and BN state rtol 2e-6, atol 2e-7; the params where the
    gradient is not rounding noise) and the gradients to the f32
    train-step test's 1e-3 of each leaf's scale; bf16 at bf16's resolution
    (loss rel 1e-2, BN state 2e-2 of each leaf's scale; see below).
    SegNet's gradients are ill-conditioned at width 1/16 (ROADMAP Queue
    3): at 32x32 the two packages' f32 gradients differ by up to 0.21 of a
    leaf's scale, so f32 runs test_torch_segnet.py's train-step setup
    (36x44, its seed 3), where they agree to 3e-4; in bf16 at 32x32 its
    bottleneck's BN turns bf16 rounding into 2% of the loss, so bf16 runs
    48x64."""
    if net == "segnet":
        _pallas_phase(monkeypatch)
    tdt, jdt = DTYPES[dtype]
    x, y = _batch(hw, 2 * grad_accum)
    opt = joptim.adamw(weight_decay=0.0)
    st0 = JaxTrainState.create(_variables(net, seed), opt)
    step = jax.jit(jax_train_step(
        NETS[net][1], opt, jsched.onecycle_lr(1e-3, TOTAL_STEPS),
        jsched.onecycle_beta1(TOTAL_STEPS), compute_dtype=jdt,
        grad_accum=grad_accum, remat=True))
    st1, wm = step(st0, (jnp.asarray(x), jnp.asarray(y)))
    got, gm = _port_step(net, _np(st0), x, y, tdt, grad_accum)
    spec = got.model.spec
    got_bn = jax_variables_from_model(got.model)["state"]
    if dtype == "bfloat16":
        # JAX's jitted step fuses ops and so skips some of the bf16
        # roundings that the port (like JAX run op by op) makes: on UNet
        # here the loss of JAX's eager step is within 5e-5 of the port's,
        # its jitted step's 1.3e-3 away. So the loss and the running stats
        # are held at bf16's resolution (2^-8 a rounding); the per-leaf
        # gradients, which these roundings move by up to 1x at a leaf, are
        # not compared (the remat step's equal the step's without, bit for
        # bit, below)
        np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]),
                                   rtol=1e-2)
        for (path, g), w in zip(_leaves(got_bn),
                                jax.tree.leaves(_np(st1.bn_state))):
            np.testing.assert_allclose(
                g, w, rtol=0, atol=2e-2 * np.abs(w).max(),
                err_msg=jax.tree_util.keystr(path))
        return
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]),
                               rtol=1e-6)
    b1 = float(gm["beta1"])
    got_g = jax_params_from_named(
        {k: v / (1 - b1) for k, v in got.opt_state["m"].items()}, spec)
    want_g = jax.tree.map(lambda m: np.asarray(m) / (1 - b1),
                          _np(st1.opt_state["m"]))
    for (path, g), w in zip(_leaves(_no_conv_bias(got_g)),
                            jax.tree.leaves(_no_conv_bias(want_g))):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3 * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))
    # AdamW's first step moves each entry by about lr * sign(g): where |g|
    # is near zero (rounding noise, e.g. every conv bias) the packages may
    # step in opposite directions, so the parameters are held to 2 lr
    # everywhere and to JAX's limits where |g| > 1e-3 of the leaf's max,
    # where the gradients above agree in sign (as the AdamW test of
    # test_torch_train_step.py)
    lr = float(wm["lr"])
    mine = jax_params_from_named(got.params(), spec)
    for (path, g), w, m in zip(_leaves(mine),
                               jax.tree.leaves(_np(st1.params)),
                               jax.tree.leaves(want_g)):
        where = jax.tree_util.keystr(path)
        assert np.abs(g - w).max() <= 2 * lr, where
        if "'b'" not in where:
            big = np.abs(m) > 1e-3 * np.abs(m).max()
            np.testing.assert_allclose(g[big], w[big], rtol=2e-6, atol=2e-7,
                                       err_msg=where)
    for (path, g), w in zip(_leaves(got_bn),
                            jax.tree.leaves(_np(st1.bn_state))):
        np.testing.assert_allclose(g, w, rtol=2e-6, atol=2e-7,
                                   err_msg=jax.tree_util.keystr(path))


def _state_tensors(st):
    """Every tensor a step leaves behind: parameters and buffers (BN
    running stats and counts), and the optimizer's moments."""
    out = dict(st.model.state_dict())
    for slot, leaves in st.opt_state.items():
        out.update({f"{slot}.{k}": v for k, v in leaves.items()})
    return out


@pytest.mark.parametrize("net,dtype,grad_accum,plain", [
    ("unet", "float32", 1, False), ("unet", "bfloat16", 1, False),
    ("unet", "float32", 2, False), ("unet", "float32", 1, True),
    ("segnet", "float32", 1, False), ("segnet", "bfloat16", 1, False)])
def test_remat_step_is_bit_equal_to_the_step_without(net, dtype, grad_accum,
                                                     plain):
    """The same arithmetic, recomputed instead of kept: loss, gradient
    norms and every tensor of the state after the step are bit-equal, and
    every BN count advanced once a microbatch, not twice."""
    tdt = DTYPES[dtype][0]
    x, y = _batch(NETS[net][2], 2 * grad_accum)
    st0 = _np(JaxTrainState.create(_variables(net),
                                   joptim.adamw(weight_decay=0.0)))
    (a, ma), (b, mb) = (_port_step(net, st0, x, y, tdt, grad_accum,
                                   remat=remat, plain=plain)
                        for remat in (False, True))
    for key in ("loss", "grad_norm_w", "grad_norm_b"):
        assert torch.equal(ma[key], mb[key]), key
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert ta.keys() == tb.keys()
    assert [k for k in ta if not torch.equal(ta[k], tb[k])] == []
    counts = {int(v) for k, v in tb.items()
              if k.endswith("num_batches_tracked")}
    assert counts == {grad_accum}


def _saved_bytes(model, x, remat):
    """Bytes of the distinct storages autograd keeps for the backward of a
    train-mode forward. A checkpoint's own input goes through the outer
    hooks too (``_NoopSaveInputs``), so it is counted."""
    seen = {}

    def pack(t):
        s = t.untyped_storage()
        seen[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model(x, False, remat)
    return sum(seen.values())


@pytest.mark.parametrize("net", ["unet", "segnet"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_forward_keeps_at_most_half_the_bytes(net, dtype):
    cls, _, hw = NETS[net]
    model = cls(3, 12, width_mult=WIDTH,
                generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(_batch(hw, 2)[0]).to(DTYPES[dtype][0])
    plain = _saved_bytes(copy.deepcopy(model), x, remat=False)
    remat = _saved_bytes(copy.deepcopy(model), x, remat=True)
    assert 0 < remat <= plain / 2, (remat, plain)


def test_remat_step_drops_the_prepared_eval_weights():
    """An eval step prepares every block's kernel arguments (BN folded,
    the kernel's weight layout); a remat train step drops them, as a step
    without remat does."""
    x, y = _batch((48, 64), 2)
    st = train_state_from_jax(
        _np(JaxTrainState.create(_variables("unet"),
                                 joptim.adamw(weight_decay=0.0))),
        UNet(3, 12, width_mult=WIDTH))
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    make_eval_step(12)(st, batch)
    blocks = st.model.blocks()
    assert all(b._kernel_args is not None for b in blocks)
    step = make_train_step(adamw(), schedules.constant_lr(1e-3), remat=True)
    st, _ = step(st, batch)
    assert st.model.training
    assert all(b._kernel_args is None for b in blocks)
