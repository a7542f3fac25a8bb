"""Batched paired image+mask augmentation on the device (counterpart of
pytorch_camvid_tpu/data/augment.py).

The port carries the recipe that ``make_train_augment`` runs with
``AugmentConfig``'s defaults (the reference pipeline, train.py:61-69):

- Gaussian blur with p 0.5, sigma ~ U(0, 3), the imgaug odd-ksize rule, a
  fixed 9-tap window, cv2's reflect-101 border and the uint8 round;
- per-sample horizontal flip with p 0.5;
- ColorJitter(0.4, 0.4): *skipped* when u < 0.4 (the reference's inverted
  test, kept), brightness factor ~ U(0.6, 1.4) through the integer LUT
  formula with the factor quantized to 2^-12; contrast as well when asked
  for, in a random per-sample order as the reference shuffles;
- ToTensor + Normalize.

Each transform is a deterministic function of the batch and its random
draws, given as tensors; ``sample_draws`` makes the draws from the train
state's ``torch.Generator``. The JAX package draws from threefry, so the
tests inject the same draws into both. Rotation (the reference binds
p=15, so it never fires), RandomScale, saturation and hue are not ported
yet: ``make_train_augment`` raises if a config asks for them.
"""

from __future__ import annotations

import itertools
from typing import Dict, NamedTuple, Tuple

import torch

from pytorch_camvid_tpu_torch.data.normalize import to_tensor_normalize

BLUR_TAPS = 9  # max ksize for sigma < 3: int(3.3 * sigma) | odd <= 9


class AugmentConfig(NamedTuple):
    """The reference training pipeline's knobs (train.py:61-69); the
    defaults and field names are the JAX package's."""
    rotation_p: float = 15.0       # train.py:63 binds p=15 -> never rotates
    rotation_angle: float = 10.0
    rotation_fill: int = 11        # ignore_index
    blur_p: float = 0.5
    hflip_p: float = 0.5
    jitter_p: float = 0.4          # ColorJitter(0.4, 0.4) -> p=.4, b=.4
    jitter_brightness: float = 0.4
    jitter_contrast: float = 0.0
    jitter_saturation: float = 0.0
    jitter_hue: float = 0.0
    jitter_random_order: bool = True  # transforms.py:430-460 shuffle
    random_scale: bool = False     # lr_finder.py pipeline uses it
    scale_range: Tuple[float, float] = (0.5, 2.0)
    scale_fill: int = 11
    mean: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    std: Tuple[float, float, float] = (1.0, 1.0, 1.0)


# ------------------------------------------------------------------ flip --

def hflip(images: torch.Tensor, masks: torch.Tensor, flip: torch.Tensor):
    """Flip sample i along W where ``flip[i]`` (transforms.py:166-187)."""
    imgs = torch.where(flip[:, None, None, None], images.flip(2), images)
    msks = torch.where(flip[:, None, None], masks.flip(2), masks)
    return imgs, msks


# ------------------------------------------------------------------ blur --

def blur_ksize_from_sigma(sigma: torch.Tensor) -> torch.Tensor:
    """imgaug's odd ksize rule (transforms.py:224-238) for sigma < 3."""
    k = torch.clamp(torch.floor(3.3 * sigma), min=3.0)
    return torch.where(k % 2 == 0, k + 1, k)


def gaussian_kernel_1d(sigma: torch.Tensor,
                       ksize: torch.Tensor) -> torch.Tensor:
    """(N, 9) cv2.getGaussianKernel weights for each sample's sigma, masked
    to its odd ksize <= 9 and centred in the 9-tap window."""
    r = BLUR_TAPS // 2
    pos = torch.arange(-r, r + 1, dtype=torch.float32, device=sigma.device)
    active = pos.abs()[None, :] <= (ksize[:, None] - 1) / 2
    s = torch.clamp(sigma, min=1e-6)[:, None]
    g = torch.exp(-0.5 * (pos * pos)[None, :] / (s * s))
    g = torch.where(active, g, torch.zeros_like(g))
    return g / g.sum(dim=1, keepdim=True)


def _reflect101(n: int, r: int, device) -> torch.Tensor:
    """Source index of each position of a reflect-101 padded axis."""
    i = torch.arange(-r, n + r, device=device)
    i = torch.where(i < 0, -i, i)
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def gaussian_blur(images: torch.Tensor, sigma: torch.Tensor,
                  apply: torch.Tensor) -> torch.Tensor:
    """Separable blur of (N,H,W,C) images in f32 with reflect-101 edges,
    rounded back to integers as cv2 does on uint8; samples with
    ``apply[i]`` false pass through unchanged (transforms.py:189-238)."""
    n, h, w, _ = images.shape
    r = BLUR_TAPS // 2
    kern = gaussian_kernel_1d(sigma, blur_ksize_from_sigma(sigma))
    ident = torch.zeros(BLUR_TAPS, device=kern.device)
    ident[r] = 1.0
    kern = torch.where(apply[:, None], kern, ident)
    x = images.float()
    xp = x.index_select(1, _reflect101(h, r, x.device))
    y = torch.zeros_like(x)
    for t in range(BLUR_TAPS):
        y = y + kern[:, t, None, None, None] * xp[:, t:t + h]
    yp = y.index_select(2, _reflect101(w, r, x.device))
    z = torch.zeros_like(x)
    for t in range(BLUR_TAPS):
        z = z + kern[:, t, None, None, None] * yp[:, :, t:t + w]
    return torch.round(torch.clamp(z, 0, 255))


# ----------------------------------------------------------------- color --

def quantize_factor(f: torch.Tensor) -> torch.Tensor:
    """Round a jitter factor to a multiple of 2^-12, so that i * f is exact
    in f32 for every uint8 i and the LUT's truncation is exact."""
    return torch.round(f * 4096.0) / 4096.0


def adjust_brightness(img: torch.Tensor, factor: torch.Tensor
                      ) -> torch.Tensor:
    """LUT i*factor, clipped, truncated (transforms.py:296-303)."""
    v = img * quantize_factor(factor)[:, None, None, None]
    return torch.floor(torch.clamp(v, 0, 255))


def adjust_contrast(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """LUT (i-74)*factor + 74, clipped, truncated (transforms.py:337-344)."""
    f = quantize_factor(factor)[:, None, None, None]
    return torch.trunc(torch.clamp((img - 74.0) * f + 74.0, 0, 255))


_JITTER_OPS = {"brightness": adjust_brightness, "contrast": adjust_contrast}


def color_jitter(images: torch.Tensor, factors: Dict[str, torch.Tensor],
                 perm: torch.Tensor = None) -> torch.Tensor:
    """Apply the active jitter ops (``factors``: op name -> (N,) factor,
    1.0 where skipped) to (N,H,W,C) f32 images. With several ops and
    ``perm`` (N,) given, sample i applies them in the order of permutation
    ``perm[i]`` of ``itertools.permutations``; otherwise in the order of
    ``factors`` (brightness before contrast)."""
    ops = [(_JITTER_OPS[k], f) for k, f in factors.items()]
    if len(ops) <= 1 or perm is None:
        for fn, f in ops:
            images = fn(images, f)
        return images
    outs = []
    for order in itertools.permutations(range(len(ops))):
        x = images
        for j in order:
            x = ops[j][0](x, ops[j][1])
        outs.append(x)
    stacked = torch.stack(outs)
    return stacked[perm, torch.arange(images.shape[0],
                                      device=images.device)]


# --------------------------------------------------------------- recipe --

def _check_supported(cfg: AugmentConfig) -> None:
    missing = []
    if cfg.rotation_angle and cfg.rotation_p < 1.0:
        missing.append("rotation (rotation_p < 1)")
    if cfg.random_scale:
        missing.append("random_scale")
    if cfg.jitter_saturation:
        missing.append("jitter_saturation")
    if cfg.jitter_hue:
        missing.append("jitter_hue")
    if missing:
        raise NotImplementedError(
            f"augmentations not ported to PyTorch yet: {', '.join(missing)}"
            f" (ROADMAP.md)")


def _jitter_ops(cfg: AugmentConfig):
    return [(k, v) for k, v in (("brightness", cfg.jitter_brightness),
                                ("contrast", cfg.jitter_contrast)) if v]


def sample_draws(generator: torch.Generator, n: int, cfg: AugmentConfig,
                 device) -> Dict[str, torch.Tensor]:
    """The recipe's random draws for a batch of ``n``, from ``generator``
    (which must live on ``device``)."""
    def u(lo=0.0, hi=1.0):
        return torch.rand(n, generator=generator, device=device) \
            * (hi - lo) + lo

    d = {}
    if cfg.blur_p > 0:
        d["blur_apply"] = u() < cfg.blur_p
        d["blur_sigma"] = u(0.0, 3.0)
    if cfg.hflip_p > 0:
        d["flip"] = u() < cfg.hflip_p
    ops = _jitter_ops(cfg)
    if ops:
        apply = u() >= cfg.jitter_p  # the reference skips when u < p
        for name, v in ops:
            f = u(max(0.0, 1.0 - v), 1.0 + v)
            d[name] = torch.where(apply, f, torch.ones_like(f))
        if len(ops) > 1 and cfg.jitter_random_order:
            k = len(list(itertools.permutations(range(len(ops)))))
            d["jitter_perm"] = torch.randint(0, k, (n,),
                                             generator=generator,
                                             device=device)
    return d


def augment_with_draws(cfg: AugmentConfig, images: torch.Tensor,
                       masks: torch.Tensor, draws: Dict[str, torch.Tensor],
                       compute_dtype: torch.dtype = torch.float32):
    """The recipe on uint8 (N,H,W,3) images and (N,H,W) masks with the
    given draws: blur -> hflip -> jitter -> normalize. Returns (images in
    ``compute_dtype``, masks as int64)."""
    _check_supported(cfg)
    x, m = images.float(), masks
    if cfg.blur_p > 0:
        x = gaussian_blur(x, draws["blur_sigma"], draws["blur_apply"])
    if cfg.hflip_p > 0:
        x, m = hflip(x, m, draws["flip"])
    ops = _jitter_ops(cfg)
    if ops:
        x = color_jitter(x, {k: draws[k] for k, _ in ops},
                         draws.get("jitter_perm"))
    return to_tensor_normalize(x, cfg.mean, cfg.std, compute_dtype), \
        m.long()


def make_train_augment(cfg: AugmentConfig,
                       compute_dtype: torch.dtype = torch.float32):
    """augment_fn(generator, images_u8, masks) -> (images, masks int64)
    for ``train/steps.py::make_train_step``."""
    _check_supported(cfg)

    def fn(generator, images, masks):
        draws = sample_draws(generator, images.shape[0], cfg, images.device)
        return augment_with_draws(cfg, images, masks, draws, compute_dtype)

    return fn
