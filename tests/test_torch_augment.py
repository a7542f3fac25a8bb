"""The port's rotation, RandomScale, saturation and hue, and the recipes
that use them, against the JAX package on the CPU, on JAX's own draws
(``test_torch_train_step._jax_draws``).

Tolerances: the warps compute their source coordinates in f32 from
``cos``/``sin`` (rotation) or ``1/s`` (scale), which XLA's CPU and torch
may round an ulp apart, so a mask pixel whose coordinate sits at a
nearest-neighbour tie can take the neighbour: masks must be equal on at
least 99.9% of the pixels, images within 1e-3 on the 0-255 scale. Hue
goes through a uint8 HSV round trip in which one ulp moves a value by up
to one hue unit, and a hue unit moves an 8-bit channel by up to 6: at
least 99% of the values bit-equal, all within 7. The recipes round after
the warps (blur) and then run the LUTs: each value within 7 of JAX's."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pytorch_camvid_tpu.data import augment as jaug

from pytorch_camvid_tpu_torch.data import augment
from test_torch_train_step import _jax_draws

MASK_EQUAL = 0.999
IMAGE_TOL = 1e-3
HUE_EQUAL, HUE_TOL = 0.99, 7.0
RECIPE_TOL = 7.0
MEAN, STD = (0.4, 0.41, 0.42), (0.3, 0.31, 0.32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(n=4, hw=(45, 60), classes=12, seed=0):
    """Blocky masks (so that most pixels are not at a class edge, as in
    the data) and noisy images."""
    rng = np.random.default_rng(seed)
    h, w = hw
    blocks = rng.integers(0, classes, (n, h // 6 + 1, w // 6 + 1))
    masks = np.kron(blocks, np.ones((6, 6), np.int64))[:, :h, :w].astype(
        np.uint8)
    images = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    return images, masks


def _mask_share(got, want) -> float:
    return float((np.asarray(got) == np.asarray(want)).mean())


def _max_err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


def test_rotation_matches_jax():
    imgs, masks = _batch(seed=1)
    cfg = jaug.AugmentConfig(rotation_p=0.3, rotation_angle=10.0)
    key = jax.random.PRNGKey(5)
    k1 = jax.random.split(key, 5)[0]
    want_x, want_m = jaug.random_rotation(k1, jnp.asarray(imgs),
                                          jnp.asarray(masks), 0.3, 10.0, 11)
    d = _jax_draws(key, len(imgs), cfg)
    assert d["rotation_apply"].any() and (d["rotation_angle"] != 0).any()
    got_x, got_m = augment.rotate(torch.from_numpy(imgs),
                                  torch.from_numpy(masks),
                                  d["rotation_angle"], 11)
    assert got_m.dtype == torch.uint8 and (got_m.numpy() == 11).any()
    assert _mask_share(got_m, want_m) >= MASK_EQUAL
    assert _max_err(got_x, want_x) <= IMAGE_TOL


@pytest.mark.parametrize("angle", [0.0, 90.0, -7.25])
def test_rotation_at_fixed_angles(angle):
    """0 is the identity, 90 a quarter turn (exact up to the sin/cos
    ulps: every tap lands on a pixel), -7.25 an arbitrary one."""
    imgs, masks = _batch(n=2, hw=(40, 40), seed=2)
    ang = np.full(2, angle, np.float32)
    got_x, got_m = augment.rotate(torch.from_numpy(imgs),
                                  torch.from_numpy(masks),
                                  torch.from_numpy(ang), 255)
    inv = jax.vmap(lambda a: jaug._rotation_inverse(a, 40, 40))(
        jnp.asarray(ang))
    np.testing.assert_allclose(
        augment.rotation_inverse(torch.from_numpy(ang), 40, 40).numpy(),
        np.asarray(inv), rtol=0, atol=1e-5)
    want_x = jax.vmap(jaug._affine_sample_bilinear)(
        jnp.asarray(imgs, jnp.float32), inv)
    want_m = jax.vmap(lambda m, i: jaug._affine_sample_nearest(m, i, 255))(
        jnp.asarray(masks), inv)
    assert _mask_share(got_m, want_m) >= MASK_EQUAL
    assert _max_err(got_x, want_x) <= IMAGE_TOL
    if angle == 0.0:
        np.testing.assert_array_equal(got_m.numpy(), masks)
        np.testing.assert_array_equal(got_x.numpy(), imgs)


# scale factors: the draw's range ends, 1 exactly, and factors at which
# dst / s lands on integers (the 1e-4 of the mask's floor)
SCALES = [0.5, 1.0, 1.9999, 1.25, 0.8, 1.6, 0.73, 1.37]


def test_scale_pad_crop_matches_jax():
    imgs, masks = _batch(n=len(SCALES), seed=3)
    rng = np.random.default_rng(4)
    s = np.asarray(SCALES, np.float32)
    uy = rng.uniform(size=len(s)).astype(np.float32)
    ux = rng.uniform(size=len(s)).astype(np.float32)
    uy[:2], ux[:2] = 0.9999, 0.0   # the ends of the crop range
    want_x, want_m = jaug.scale_pad_crop(
        jnp.asarray(imgs), jnp.asarray(masks), jnp.asarray(s),
        jnp.asarray(uy), jnp.asarray(ux), 11)
    got_x, got_m = augment.scale_pad_crop(
        torch.from_numpy(imgs), torch.from_numpy(masks), torch.from_numpy(s),
        torch.from_numpy(uy), torch.from_numpy(ux), 11)
    assert (got_m.numpy()[0] == 11).any()   # s = 0.5 pads
    assert _mask_share(got_m, want_m) >= MASK_EQUAL
    assert _max_err(got_x, want_x) <= IMAGE_TOL
    # s = 1 with any offset is the identity
    np.testing.assert_array_equal(got_m.numpy()[1], masks[1])
    np.testing.assert_allclose(got_x.numpy()[1], imgs[1], atol=1e-4)


def test_random_scale_draws_match_jax_random_scale_crop():
    imgs, masks = _batch(seed=5)
    cfg = jaug.AugmentConfig(random_scale=True)
    key = jax.random.PRNGKey(9)
    k5 = jax.random.split(key, 5)[4]
    want_x, want_m = jaug.random_scale_crop(k5, jnp.asarray(imgs),
                                            jnp.asarray(masks),
                                            cfg.scale_range, 11)
    d = _jax_draws(key, len(imgs), cfg)
    got_x, got_m = augment.scale_pad_crop(
        torch.from_numpy(imgs), torch.from_numpy(masks), d["scale_s"],
        d["scale_uy"], d["scale_ux"], 11)
    assert _mask_share(got_m, want_m) >= MASK_EQUAL
    assert _max_err(got_x, want_x) <= IMAGE_TOL


def _color_inputs(seed=6):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (6, 24, 32, 3)).astype(np.float32)
    x[0, :4] = 128.0            # gray pixels (s == 0)
    x[1, :4] = [255, 0, 0]      # pure channels and ties of the max
    x[1, 4:8] = [0, 255, 255]
    x[2, :4] = [0, 0, 0]
    return x


def test_saturation_matches_jax():
    x = _color_inputs()
    f = np.asarray([0.6, 1.0, 1.3999, 0.0, 0.75, 1.2], np.float32)
    want = jaug._adjust_saturation(jnp.asarray(x), jnp.asarray(f))
    got = augment.adjust_saturation(torch.from_numpy(x), torch.from_numpy(f))
    assert _max_err(got, want) <= IMAGE_TOL
    np.testing.assert_array_equal(got.numpy()[1], x[1])   # factor 1


def test_hue_matches_jax():
    x = _color_inputs(seed=7)
    f = np.asarray([-0.1, 0.0, 0.0999, 0.5, -0.5, 0.03], np.float32)
    want = np.asarray(jaug._adjust_hue(jnp.asarray(x), jnp.asarray(f)))
    got = augment.adjust_hue(torch.from_numpy(x), torch.from_numpy(f))
    got = got.numpy()
    assert float((got == want).mean()) >= HUE_EQUAL
    assert _max_err(got, want) <= HUE_TOL
    assert got.min() >= 0 and got.max() <= 255


RECIPES = {
    # the LR finder's (lr_finder.py:141-148)
    "lr_finder": dict(rotation_p=0.5, rotation_angle=10, rotation_fill=11,
                      random_scale=True, scale_fill=11),
    # the four jitter ops in a random order per sample
    "full_jitter": dict(jitter_p=0.2, jitter_brightness=0.4,
                        jitter_contrast=0.4, jitter_saturation=0.4,
                        jitter_hue=0.1),
    "full_jitter_fixed_order": dict(jitter_p=0.2, jitter_brightness=0.4,
                                    jitter_contrast=0.4,
                                    jitter_saturation=0.4, jitter_hue=0.1,
                                    jitter_random_order=False),
}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_recipe_on_jax_draws_matches_jax(name):
    imgs, masks = _batch(n=8, seed=8)
    cfg = jaug.AugmentConfig(mean=MEAN, std=STD, **RECIPES[name])
    key = jax.random.PRNGKey(21)
    want_x, want_m = jaug.make_train_augment(cfg)(key, jnp.asarray(imgs),
                                                  jnp.asarray(masks))
    d = _jax_draws(key, len(imgs), cfg)
    if "jitter_perm" in d:
        assert len(set(d["jitter_perm"].tolist())) > 2
    got_x, got_m = augment.augment_with_draws(
        augment.AugmentConfig(**cfg._asdict()), torch.from_numpy(imgs),
        torch.from_numpy(masks), d)
    assert got_m.dtype == torch.int64 and got_x.dtype == torch.float32
    assert _mask_share(got_m, want_m) >= MASK_EQUAL
    scale = np.asarray(STD, np.float32) * 255.0
    err = np.abs(got_x.numpy() - np.asarray(want_x)) * scale
    assert float(err.max()) <= RECIPE_TOL
    assert float((err <= IMAGE_TOL).mean()) >= MASK_EQUAL


def test_color_jitter_selects_each_samples_order():
    """Position by position selection equals applying each sample's own
    order of the four ops."""
    x = torch.from_numpy(_color_inputs(seed=9))
    n = x.shape[0]
    g = torch.Generator().manual_seed(3)
    factors = {"brightness": torch.rand(n, generator=g) * 0.8 + 0.6,
               "contrast": torch.rand(n, generator=g) * 0.8 + 0.6,
               "saturation": torch.rand(n, generator=g) * 0.8 + 0.6,
               "hue": torch.rand(n, generator=g) * 0.2 - 0.1}
    perm = torch.tensor([0, 5, 11, 17, 23, 14])
    got = augment.color_jitter(x, factors, perm)
    names = list(factors)
    orders = augment.jitter_orders(4, torch.device("cpu"))
    for i in range(n):
        want = x[i:i + 1]
        for j in orders[perm[i]].tolist():
            want = augment.JITTER_OPS[names[j]](want,
                                                factors[names[j]][i:i + 1])
        torch.testing.assert_close(got[i:i + 1], want, rtol=0, atol=0)


def test_sampler_rates_of_the_new_draws():
    cfg = augment.AugmentConfig(rotation_p=0.5, random_scale=True,
                                jitter_saturation=0.4, jitter_hue=0.1)
    n = 4000
    d = augment.sample_draws(torch.Generator().manual_seed(0), n, cfg,
                             "cpu")
    # 4000 draws: rates within ~5 standard errors of p
    assert abs(d["rotation_apply"].float().mean() - 0.5) < 0.04
    a = d["rotation_angle"]
    assert (a[~d["rotation_apply"]] == 0).all()
    assert -10 <= a.min() and a.max() < 10
    assert 0.5 <= d["scale_s"].min() and d["scale_s"].max() < 2.0
    for k in ("scale_uy", "scale_ux"):
        assert 0 <= d[k].min() and d[k].max() < 1
        assert abs(d[k].mean() - 0.5) < 0.03
    skip = d["brightness"] == 1
    assert abs(skip.float().mean() - 0.4) < 0.04
    assert (d["saturation"][skip] == 1).all() and (d["hue"][skip] == 0).all()
    sat, hue = d["saturation"][~skip], d["hue"][~skip]
    assert 0.6 <= sat.min() and sat.max() < 1.4
    assert -0.1 <= hue.min() and hue.max() < 0.1
    perm = d["jitter_perm"]
    assert perm.min() == 0 and perm.max() == math.factorial(3) - 1
    counts = torch.bincount(perm, minlength=6).float() / n
    assert (counts - 1 / 6).abs().max() < 0.03


def test_every_jax_config_runs():
    """make_train_augment takes every option of JAX's AugmentConfig."""
    imgs, masks = _batch(n=3, hw=(20, 24), seed=10)
    cfg = augment.AugmentConfig(rotation_p=0.0, random_scale=True,
                                jitter_contrast=0.3, jitter_saturation=0.3,
                                jitter_hue=0.05, mean=MEAN, std=STD)
    assert set(cfg._fields) == set(jaug.AugmentConfig._fields)
    x, m = augment.make_train_augment(cfg, torch.bfloat16)(
        torch.Generator().manual_seed(2), torch.from_numpy(imgs),
        torch.from_numpy(masks))
    assert x.dtype == torch.bfloat16 and x.shape == imgs.shape
    assert torch.isfinite(x.float()).all() and m.max() <= 11
