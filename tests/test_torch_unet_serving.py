"""The port's UNet serving slice against the JAX package, on the CPU.

Same weights (carried across by pytorch_camvid_tpu_torch/interop/weights.py)
and the same numpy inputs go through both packages in f32. The JAX model
runs with use_pallas=False, its Pallas kernel's plain reference; the port's
fused block runs its plain version on CPU tensors."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pytorch_camvid_tpu.data.augment import to_tensor_normalize as jax_norm
from pytorch_camvid_tpu.models import get_model as jax_get_model
from pytorch_camvid_tpu.models.unet import _pad_to_match as jax_pad
from pytorch_camvid_tpu.ops.conv import conv_bn_relu_apply
from pytorch_camvid_tpu.ops.pooling import max_pool_2x2 as jax_pool
from pytorch_camvid_tpu.ops import resize as jax_resize
from pytorch_camvid_tpu.serving import Predictor as JaxPredictor
from pytorch_camvid_tpu.utils.viz import colorize_mask as jax_colorize

from pytorch_camvid_tpu_torch.config import settings
from pytorch_camvid_tpu_torch.data.normalize import to_tensor_normalize
from pytorch_camvid_tpu_torch.interop.weights import (
    state_dict_from_jax_variables)
from pytorch_camvid_tpu_torch.models import get_model
from pytorch_camvid_tpu_torch.models.unet import (UNet, pad_to_match,
                                                 scaled_spec)
from pytorch_camvid_tpu_torch.ops import resize
from pytorch_camvid_tpu_torch.ops.conv import ConvBNReLU
from pytorch_camvid_tpu_torch.ops.pooling import max_pool_2x2
from pytorch_camvid_tpu_torch.serving import Predictor
from pytorch_camvid_tpu_torch.utils.viz import colorize_mask

WIDTH = 1 / 16
HW = (45, 62)  # odd H: pools 45->22->11->5->2 and pads back up


def _jax_variables(seed=0, width=WIDTH):
    """JAX UNet variables as numpy, drawn directly (JAX's eager init is
    slow on the CPU), with torch-default-scaled conv weights and
    non-trivial BN affine and stats so the BN fold is exercised."""
    rng = np.random.default_rng(seed)
    params, state = {}, {}
    for stage, pairs in scaled_spec(3, 12, width):
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


def _port_unet(variables, width=WIDTH):
    model = UNet(3, 12, width_mult=width)
    model.load_state_dict(state_dict_from_jax_variables(variables),
                          strict=True)
    return model.eval()


def test_unet_eval_logits_match_jax():
    v = _jax_variables()
    x = np.random.default_rng(1).normal(size=(2,) + HW + (3,)).astype(
        np.float32)
    _, apply_fn = jax_get_model("unet", 3, 12)
    want, _ = jax.jit(lambda v, x: apply_fn(v, x, train=False,
                                            use_pallas=False))(
        jax.tree.map(jnp.asarray, v), jnp.asarray(x))
    want = np.asarray(want)
    with torch.no_grad():
        got = _port_unet(v)(torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    # JAX computes (conv + b - mean) * inv + beta per block, the port
    # conv * A + B with A, B folded (ops/fused_conv.py): equal up to f32
    # rounding, compounded over 23 blocks -> 1e-4 of the logits' scale
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * scale)


def test_conv_block_train_mode_matches_jax():
    """Train mode (K1's conv, on CPU its plain version, then batch-stat BN
    with JAX's E[y^2]-E[y]^2 variance) and its running-stat update."""
    rng = np.random.default_rng(2)
    cin, cout = 5, 7
    x = rng.normal(size=(2, 6, 9, cin)).astype(np.float32)
    blk = ConvBNReLU(cin, cout, torch.Generator().manual_seed(0)).train()
    conv, bn = blk.conv[0], blk.conv[1]
    params = {"w": jnp.asarray(conv.weight.detach().numpy()
                               .transpose(2, 3, 1, 0)),
              "b": jnp.asarray(conv.bias.detach().numpy()),
              "scale": jnp.ones(cout), "bias": jnp.zeros(cout)}
    state = {"mean": jnp.zeros(cout), "var": jnp.ones(cout)}
    want, new_state = conv_bn_relu_apply(params, state, jnp.asarray(x),
                                         train=True)
    got = blk(torch.from_numpy(x))
    # f32, the same variance formula on both sides: only the conv's and
    # the moments' summation orders differ, a few ulps of O(1) outputs
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new_state["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new_state["var"]), rtol=1e-5)


def _resized_u8(images, hw):
    x = resize.resize_bilinear_cv2(torch.from_numpy(images).float(), hw)
    return x.clamp(0, 255).round().to(torch.uint8)


@pytest.mark.parametrize("src_hw", [HW, (2 * HW[0], 2 * HW[1])],
                         ids=["working_size", "resized"])
def test_predictor_matches_jax_predictor(src_hw):
    """5 images at batch 2 (two full chunks and a padded one), f32."""
    v = _jax_variables(seed=3)
    imgs = np.random.default_rng(4).integers(0, 256, (5,) + src_hw + (3,),
                                             dtype=np.uint8)
    want = JaxPredictor("unet", jax.tree.map(jnp.asarray, v), batch_size=2,
                        image_hw=HW, compute_dtype=jnp.float32
                        ).predict(imgs)
    sd = state_dict_from_jax_variables(v)
    with Predictor("unet", sd, batch_size=2, image_hw=HW, device="cpu",
                   compute_dtype=torch.float32) as p:
        got = p.predict(imgs)
        with torch.no_grad():
            logits = p.model(to_tensor_normalize(
                _resized_u8(imgs, HW), settings.MEAN, settings.STD))
    assert got.shape == want.shape == (5,) + HW and got.dtype == np.uint8
    # classes must agree wherever the decision is not a near tie. The
    # 2x resize has dyadic weights, so both uint8 resizes are exact.
    top2 = torch.topk(logits, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1] > 1e-3).numpy()
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got[clear], want[clear])


def test_predictor_pads_closes_and_refuses_missing_cuda():
    sd = get_model("unet", 3, 12, width_mult=WIDTH,
                   generator=torch.Generator().manual_seed(0)).state_dict()
    imgs = np.random.default_rng(5).integers(0, 256, (3, 16, 24, 3),
                                             dtype=np.uint8)
    p = Predictor("unet", sd, batch_size=2, image_hw=(16, 24), device="cpu",
                  compute_dtype=torch.float32)
    with p:
        out = p.predict(imgs)
        assert out.shape == (3, 16, 24) and out.max() < 12
        np.testing.assert_array_equal(out, p.predict(imgs))
        assert p.predict(imgs[:0]).shape == (0, 16, 24)
        with pytest.raises(ValueError):
            p.predict(imgs.astype(np.float32))
    with pytest.raises(RuntimeError):
        p.predict(imgs)  # closed: the drain thread is gone
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            Predictor("unet", sd, device="cuda")


@pytest.mark.parametrize("h,w", [(45, 62), (44, 60), (7, 3)])
def test_pad_to_match_matches_jax(h, w):
    rng = np.random.default_rng(h * w)
    x = rng.normal(size=(1, 2 * (h // 2), 2 * (w // 2), 3)).astype(
        np.float32)
    skip = np.zeros((1, h, w, 5), np.float32)
    want = np.asarray(jax_pad(jnp.asarray(x), jnp.asarray(skip)))
    got = pad_to_match(torch.from_numpy(x), torch.from_numpy(skip))
    np.testing.assert_array_equal(got.numpy(), want)


def test_max_pool_odd_size_matches_jax():
    x = np.random.default_rng(6).normal(size=(2, 45, 61, 4)).astype(
        np.float32)
    got = max_pool_2x2(torch.from_numpy(x))
    assert got.shape == (2, 22, 30, 4)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_pool(jnp.asarray(x))))


@pytest.mark.parametrize("hw", [(22, 30), (5, 7), (1, 4)])
def test_upsample_align_corners_matches_jax(hw):
    x = np.random.default_rng(7).normal(size=(2,) + hw + (3,)).astype(
        np.float32)
    want = np.asarray(jax_resize.upsample2x_bilinear_align_corners(
        jnp.asarray(x)))
    got = resize.upsample2x_bilinear_align_corners(torch.from_numpy(x))
    # torch computes the source coordinate in f32, JAX's weights come
    # from f64 (the bound tests/test_resize.py holds JAX to against torch)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


@pytest.mark.parametrize("src,dst", [((37, 53), (360, 480)),
                                     ((480, 640), (360, 480)),
                                     ((45, 61), (22, 31)),
                                     ((37, 53), (37, 53))])
def test_resize_bilinear_cv2_matches_jax(src, dst):
    """Upscale, the serving downscale, an odd downscale and identity."""
    x = np.random.default_rng(8).uniform(0, 255, (2,) + src + (3,)).astype(
        np.float32)
    want = np.asarray(jax_resize.resize_bilinear_cv2(jnp.asarray(x), dst))
    got = resize.resize_bilinear_cv2(torch.from_numpy(x), dst)
    assert tuple(got.shape) == (2,) + dst + (3,)
    # the same f32 weights (built in f64) on both sides; only the f32
    # summation of each output's few products differs, ulps of 255
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_serving_resize_uint8_equals_jax():
    """The 480x640 -> 360x480 serving resize, rounded to uint8 as both
    Predictors do, gives the same bytes in both packages."""
    imgs = np.random.default_rng(10).integers(0, 256, (4, 480, 640, 3),
                                              dtype=np.uint8)
    want = np.asarray(jnp.round(jnp.clip(jax_resize.resize_bilinear_cv2(
        jnp.asarray(imgs, jnp.float32), (360, 480)), 0, 255)
    ).astype(jnp.uint8))
    got = _resized_u8(imgs, (360, 480)).numpy()
    np.testing.assert_array_equal(got, want)


def test_normalize_and_colorize_match_jax():
    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 256, (2, 5, 6, 3), dtype=np.uint8)
    want = np.asarray(jax_norm(jnp.asarray(imgs), settings.MEAN,
                               settings.STD))
    got = to_tensor_normalize(torch.from_numpy(imgs), settings.MEAN,
                              settings.STD)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    mask = rng.integers(0, 14, (5, 6)).astype(np.uint8)  # incl. >= 12
    np.testing.assert_array_equal(colorize_mask(mask), jax_colorize(mask))


def test_conv_init_matches_jax_distribution():
    """Torch-default U(+-1/sqrt(fan_in)) for weight and bias, as the JAX
    initializers draw it; the streams differ, so compare distributions."""
    from pytorch_camvid_tpu.ops.initializers import conv_kernel_init
    cin, cout = 32, 48
    bound = 1 / np.sqrt(9 * cin)
    blk = ConvBNReLU(cin, cout, torch.Generator().manual_seed(0))
    w = blk.conv[0].weight.detach().numpy().ravel()
    b = blk.conv[0].bias.detach().numpy()
    jw = np.asarray(conv_kernel_init(jax.random.PRNGKey(0),
                                     (3, 3, cin, cout))).ravel()
    for v in (w, b, jw):
        assert np.abs(v).max() <= bound
    # 13824 draws of U(-c, c): mean 0, std c/sqrt(3); the bounds are
    # ~5 standard errors of each statistic
    for v in (w, jw):
        assert abs(v.mean()) < 5 * bound / np.sqrt(3 * v.size)
        assert abs(v.std() / (bound / np.sqrt(3)) - 1) < 0.03
    np.testing.assert_allclose(np.quantile(w, [0.1, 0.5, 0.9]),
                               np.quantile(jw, [0.1, 0.5, 0.9]),
                               atol=0.03 * bound)
    # the generator makes the draw reproducible
    again = ConvBNReLU(cin, cout, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(again.conv[0].weight.detach().numpy(),
                                  blk.conv[0].weight.detach().numpy())
    # BatchNorm keeps torch's defaults: identity affine and stats
    bn = blk.conv[1]
    assert bool((bn.weight == 1).all() and (bn.bias == 0).all()
                and (bn.running_mean == 0).all()
                and (bn.running_var == 1).all())


def test_width_mult_checked_by_position():
    """num_classes equal to an internal width (64) must not exempt that
    width from the check (the JAX check filters by value)."""
    with pytest.raises(ValueError, match="width_mult"):
        UNet(3, 64, width_mult=1 / 32)
    UNet(3, 64, width_mult=1 / 16)  # every internal width scales to >= 4
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model("segnet", 3, 12)
