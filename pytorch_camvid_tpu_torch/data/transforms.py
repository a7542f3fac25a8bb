"""Class-based paired transforms (counterpart of
pytorch_camvid_tpu/data/transforms.py; reference transforms.py).

The reference's class names and call signature ``t(img, mask) -> (img,
mask)`` on one HWC numpy sample, so per-sample code ports unchanged. Each
class wraps the batched ops of ``data/augment.py`` (adding and removing
the batch axis) and draws from one ``torch.Generator`` that ``seed(s)``
resets, so a pipeline is reproducible. Training composes the batched ops
directly (``make_train_augment``); these serve the datasets'
``transforms=`` hooks and interactive use.

The reference's probability quirks are kept per class: RandomRotation and
ColorJitter *skip* when u < p, HorizontalFlip and GaussianBlur *apply*
when u < p.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from pytorch_camvid_tpu_torch.data import augment as A
from pytorch_camvid_tpu_torch.ops.resize import (resize_bilinear_cv2,
                                                 resize_nearest_cv2)


class _Rng:
    generator = torch.Generator().manual_seed(0)

    @classmethod
    def uniform(cls, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        """One draw in [lo, hi) as a (1,) f32 tensor."""
        return torch.rand(1, generator=cls.generator) * (hi - lo) + lo


def seed(s: int):
    """Reset the transforms' generator (reproducible pipelines)."""
    _Rng.generator.manual_seed(int(s))


def _b(x) -> torch.Tensor:   # one sample -> a batch of one
    return torch.from_numpy(np.ascontiguousarray(x))[None]


def _ub(x: torch.Tensor) -> np.ndarray:
    return x[0].numpy()


def _like(out: torch.Tensor, img) -> np.ndarray:
    """A float result back as the input's kind: uint8 input rounds back to
    uint8 (cv2 does on uint8), so the chain stays integer for the LUTs."""
    out = _ub(out)
    if np.asarray(img).dtype == np.uint8:
        return np.round(out).clip(0, 255).astype(np.uint8)
    return out


class Compose:
    """transforms.py:17-39."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img, mask):
        for trans in self.transforms:
            img, mask = trans(img, mask)
        return img, mask

    def __repr__(self):
        inner = "\n".join(f"    {t}" for t in self.transforms)
        return f"{self.__class__.__name__}(\n{inner}\n)"


class Resize:
    """transforms.py:41-61: size is (w, h) in cv2 order; bilinear for the
    image, nearest for the mask."""

    def __init__(self, size):
        if isinstance(size, int):
            self.size = (size, size)
        elif isinstance(size, Iterable) and len(size) == 2:
            self.size = tuple(size)
        else:
            raise TypeError("size should be iterable with size 2 or int")

    def __call__(self, img, mask):
        w, h = self.size
        im = resize_bilinear_cv2(_b(np.asarray(img, np.float32)), (h, w))
        return _like(im, img), _ub(resize_nearest_cv2(_b(mask), (h, w)))


class RandomScale:
    """transforms.py:63-127."""

    def __init__(self, scale=(0.5, 2.0), value=0):
        self.scale = scale
        self.value = value

    def __call__(self, img, mask):
        s = _Rng.uniform(*self.scale)
        uy, ux = _Rng.uniform(), _Rng.uniform()
        im, mk = A.scale_pad_crop(_b(np.asarray(img, np.float32)), _b(mask),
                                  s, uy, ux, self.value)
        return _like(im, img), _ub(mk)


class RandomRotation:
    """transforms.py:129-164: the first positional argument is p (the
    reference's quirk; train.py passes 15 and never rotates)."""

    def __init__(self, p=0.5, angle=10, fill=0):
        if not angle > 0:
            raise ValueError("angle must be a positive number.")
        self.p, self.angle, self.value = p, angle, fill

    def __call__(self, img, mask):
        apply = _Rng.uniform() >= self.p
        angle = _Rng.uniform(-self.angle, self.angle)
        angle = torch.where(apply, angle, torch.zeros_like(angle))
        im, mk = A.rotate(_b(np.asarray(img, np.float32)), _b(mask), angle,
                          self.value)
        return _like(im, img), _ub(mk)


class RandomHorizontalFlip:
    """transforms.py:166-187."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, mask):
        im, mk = A.hflip(_b(img), _b(mask), _Rng.uniform() < self.p)
        return _ub(im), _ub(mk)


class RandomGaussianBlur:
    """transforms.py:189-238; sigma up to 3 (the fixed 9-tap window)."""

    def __init__(self, p=0.5, sigma=(0.0, 3.0)):
        if not sigma[1] >= sigma[0] >= 0:
            raise ValueError(
                "sigma shoule be an iterval of nonegative real number")
        if int(max(3.3 * sigma[1], 3)) | 1 > A.BLUR_TAPS + 1:
            raise ValueError(f"sigma up to {sigma[1]} needs more than the "
                             f"{A.BLUR_TAPS}-tap window")
        self.p, self.sigma = p, sigma

    def __call__(self, img, mask):
        apply = _Rng.uniform() < self.p
        sigma = _Rng.uniform(*self.sigma)
        im = A.gaussian_blur(_b(np.asarray(img, np.float32)), sigma, apply)
        return _like(im, img), np.asarray(mask)


class Lambda:
    """transforms.py:349-362."""

    def __init__(self, lambd):
        assert callable(lambd)
        self.lambd = lambd

    def __call__(self, img, mask):
        return self.lambd(img), mask


class ColorJitter:
    """transforms.py:364-483: p first, then brightness, contrast,
    saturation and hue; skips when u < p; the active ops in a random
    order."""

    def __init__(self, p=0.5, brightness=0, contrast=0, saturation=0,
                 hue=0):
        self.p = p
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def __call__(self, img, mask):
        cfg = A.AugmentConfig(blur_p=0.0, hflip_p=0.0, jitter_p=self.p,
                              jitter_brightness=self.brightness,
                              jitter_contrast=self.contrast,
                              jitter_saturation=self.saturation,
                              jitter_hue=self.hue)
        d = A.sample_draws(_Rng.generator, 1, cfg, "cpu")
        ops = [k for k in A.JITTER_OPS if k in d]
        im = A.color_jitter(_b(np.asarray(img, np.float32)),
                            {k: d[k] for k in ops}, d.get("jitter_perm"))
        return _like(im, img), np.asarray(mask)


class ToTensor:
    """transforms.py:485-505: to float in [0, 1]; stays HWC (the port's
    NHWC) with an int32 mask, as JAX's."""

    def __call__(self, img, mask):
        return (np.asarray(img, np.float32) / 255.0,
                np.asarray(mask, np.int32))


class Normalize:
    """transforms.py:507-539: per-channel (x - mean) / std on the [0, 1]
    float image; the mask untouched."""

    def __init__(self, mean, std, inplace=False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img, mask):
        return (np.asarray(img, np.float32) - self.mean) / self.std, mask
