"""The f32 padded copy on the CPU: a side whose channels TMA cannot
describe (no multiple of 4) goes to route "f32" as a copy at a pixel
stride of 4 ceil(C / 4), zeros past C (``fused_conv.pad_channels``, the
.cu's ``pad_channels_kernel``), with the split weights' rows padded to
that stride (``split_weights_plain(stride=)``). Held here: the plain
versions of that layout give the unpadded forward, ``flip`` dx and dW in
float64; the wrappers' copies on a CPU tensor are plain and uncounted;
the copies a step makes (``conv_train.step_pad_copies``); and the port's
f32 train step with a 23- and a 150-class head (the heads whose dx and
dW take the padded route on the card) against the JAX package's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_camvid_tpu.models.unet import apply_unet
from pytorch_camvid_tpu.ops import loss as jloss

from pytorch_camvid_tpu_torch import bench
from pytorch_camvid_tpu_torch.data.synthetic import synthetic_arrays
from pytorch_camvid_tpu_torch.interop.weights import (jax_params_from_named,
                                                      jax_variables_from_model,
                                                      train_state_from_jax)
from pytorch_camvid_tpu_torch.models import unet as unet_model
from pytorch_camvid_tpu_torch.ops import conv_train, fused_conv
from pytorch_camvid_tpu_torch.train.steps import loss_and_grads

from test_torch_train_step import _leaves_close

def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("cin,cout", [(23, 64), (64, 150), (150, 64),
                                      (64, 23), (5, 10), (10, 5), (3, 21),
                                      (6, 150)])
def test_padded_layout_keeps_fwd_dx_and_dw(cin, cout):
    """In float64: x padded (``pad_channels_plain``) through the weights
    with zero rows past Cin is the forward; g padded through the
    tap-reversed transpose with zero rows past Cout is the ``flip`` dx; the
    dW over both padded copies holds the dW in its first Cin x Cout
    channels and zeros past them. Each to 1e-12 of max|f64|."""
    rng = np.random.default_rng(cin * 1000 + cout)
    x = torch.from_numpy(rng.normal(size=(2, 7, 9, cin)))
    g = torch.from_numpy(rng.normal(size=(2, 7, 9, cout)))
    w = torch.from_numpy(rng.normal(size=(3, 3, cin, cout)))
    xp, gp = fused_conv.pad_channels_plain(x), fused_conv.pad_channels_plain(g)
    ci4, co4 = fused_conv.f32_stride(cin), fused_conv.f32_stride(cout)
    assert xp.shape[3] == ci4 and gp.shape[3] == co4
    assert not xp[..., cin:].any() and torch.equal(xp[..., :cin], x)
    w_in = F.pad(w, (0, 0, 0, ci4 - cin))          # rows past Cin zero
    w_out = F.pad(w, (0, co4 - cout))              # flip: rows past Cout
    fwd = conv_train.conv3x3_train_plain(x, w)
    assert _rel(conv_train.conv3x3_train_plain(xp, w_in), fwd) <= 1e-12
    dx = conv_train.conv3x3_dgrad_plain(g, w)
    assert _rel(conv_train.conv3x3_dgrad_plain(gp, w_out), dx) <= 1e-12
    def wgrad64(x, g):   # conv3x3_wgrad_plain's function, in float64
        return torch.nn.grad.conv2d_weight(
            x.permute(0, 3, 1, 2), (g.shape[3], x.shape[3], 3, 3),
            g.permute(0, 3, 1, 2), padding=1).permute(2, 3, 1, 0)
    dw, dw64 = wgrad64(x, g), wgrad64(xp, gp)
    assert _rel(dw64[:, :, :cin, :cout], dw) <= 1e-12
    assert not dw64[:, :, cin:].any() and not dw64[:, :, :, cout:].any()


@pytest.mark.parametrize("flip", [False, True])
def test_split_weights_rows_padded_with_zeros(flip):
    """``split_weights_plain`` at a row stride past Cin (x's padded pixel
    stride) is the unpadded split with zero rows appended to each (n, t)
    row: the layout ``split_weights_kernel`` writes for route "f32"."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.normal(size=(3, 3, 23, 64) if not flip
                                    else (3, 3, 64, 23)).astype(np.float32))
    plain = fused_conv.split_weights_plain(w, flip)
    padded = fused_conv.split_weights_plain(w, flip, stride=24)
    assert padded.shape == (2, 64, 9, 24)
    assert torch.equal(padded[..., :23], plain)
    assert not padded[..., 23:].any()


def test_pad_channels_on_the_cpu_is_plain_and_uncounted():
    """On a CPU tensor ``pad_channels`` is its plain version and counts no
    launch; ``padded_input`` takes a handed-in copy of the right layout and
    refuses another."""
    fused_conv.reset_launches()
    x = torch.randn(2, 3, 5, 6)
    got = fused_conv.pad_channels(x)
    assert torch.equal(got, F.pad(x, (0, 2))) and got.is_contiguous()
    assert fused_conv.pad_channels.launches == 0
    assert fused_conv.padded_input(x, got) is got
    with pytest.raises(ValueError, match="padded copy"):
        fused_conv.padded_input(x, torch.zeros(2, 3, 5, 6))
    assert conv_train._padded_copy(x, True) is None   # CPU: plain path


@pytest.mark.parametrize("width,classes,copies",
                         [(1.0, 150, 1), (1.0, 23, 1), (1.0, 12, 0),
                          (1 / 8, 150, 1), (3 / 32, 12, 3), (5 / 64, 12, 8),
                          (5 / 64, 150, 10)])
def test_step_pad_copies(width, classes, copies):
    """The padded copies of one f32 step: the 23- and 150-class heads (64
    -> classes, 8 -> 150 at width 1/8) pad g once for both dx and dW; each
    odd-width dW with both sides narrow pads the side with more channels
    (UNet 3/32: 3 -> 6, 6 -> 6 twice; 5/64: eight, among them 10 -> 5
    padding x), and 5/64's 5 -> 150 head pads both, x for its dW alone."""
    shapes = bench.block_shapes("unet", spec=unet_model.scaled_spec(
        3, classes, width))
    assert conv_train.step_pad_copies(shapes) == copies


# ---------------------------------------------- the JAX package's step

WIDTH, HW, BATCH = 1 / 8, (45, 60), 2


def _variables(spec, seed=0):
    """JAX UNet variables as numpy: torch-default-scaled convs, non-trivial
    BN affine and running stats (``test_torch_train_step``'s draw)."""
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


@pytest.mark.parametrize("classes", [23, 150])
def test_f32_step_with_a_wide_head_matches_jax(classes):
    """UNet at width 1/8 with a ``classes``-class head on 45x60, batch 2,
    labels over every class: the port's f32 step (its kernel path, plain
    on CPU tensors) against the JAX package's (``use_pallas=False``) from
    the same numpy-drawn variables on the same batch. The loss to 1e-5 and
    the BN running stats to 1e-5 of their max, and the head's weight
    gradient to 1e-3 of its max (``test_torch_train_step``'s limits). The
    other leaves: at this width and size a few max-pool and ReLU decisions
    near a tie go the other way under either package's f32 rounding
    (against each other, and against a float64 run, single BN leaves move
    by up to ~3e-2 of their max), so each leaf is held to chip_smoke's f32
    step limits: its gradient norm to 5e-3 and the norm of its difference
    to 5e-2 of its norm (a conv bias against its conv weight's norm: its
    exact gradient is zero before train-mode BN)."""
    from pytorch_camvid_tpu.train.state import TrainState as JaxTrainState
    spec = unet_model.scaled_spec(3, classes, WIDTH)
    v = _variables(spec)
    images, _ = synthetic_arrays(BATCH, HW, seed=1)
    x = ((images.astype(np.float32) / 255.0 - 0.4) / 0.3).astype(np.float32)
    y = np.random.default_rng(2).integers(0, classes, (BATCH,) + HW)
    apply = functools.partial(apply_unet, use_pallas=False)

    def loss_fn(p, bn):
        logits, nb = apply({"params": p, "state": bn}, jnp.asarray(x),
                           train=True)
        return jloss.cross_entropy_loss(logits, jnp.asarray(y)), nb

    (want_loss, want_bn), want_g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"], v["state"])
    np_tree = functools.partial(jax.tree.map, np.asarray)
    state = train_state_from_jax(
        np_tree(JaxTrainState(v["params"], v["state"], {}, 0, None)),
        unet_model.UNet(3, classes, width_mult=WIDTH))
    got_loss, grads = loss_and_grads(state.model, torch.from_numpy(x),
                                     torch.from_numpy(y))
    got_g = jax_params_from_named(grads, spec)
    want_g = np_tree(want_g)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    _leaves_close(jax_variables_from_model(state.model)["state"],
                  np_tree(want_bn), 1e-5, "BN state")
    head = spec[-1][0]
    assert got_g[head][-1]["w"].shape == (3, 3, spec[-1][1][-1][0], classes)
    _leaves_close(got_g[head][-1]["w"], want_g[head][-1]["w"], 1e-3,
                  "the head's weight gradient")
    for s, blks in want_g.items():
        for i, blk in enumerate(blks):
            for k, want in blk.items():
                got = np.asarray(got_g[s][i][k], np.float64)
                want = np.asarray(want, np.float64)
                scale = max(np.linalg.norm(blk["w"] if k == "b" else want),
                            1e-30)
                what = f"{s}[{i}].{k}"
                assert abs(np.linalg.norm(got) - np.linalg.norm(want)) \
                    <= 5e-3 * scale, what
                assert np.linalg.norm(got - want) <= 5e-2 * scale, what
