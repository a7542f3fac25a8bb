"""Batched paired image+mask augmentation on the device (counterpart of
pytorch_camvid_tpu/data/augment.py).

Every transform of the JAX package's ``make_train_augment``, in its order
(rotation -> random scale -> blur -> hflip -> color jitter -> normalize):

- rotation about the image centre (cv2.warpAffine's inverse map),
  bilinear with a zero border for the image, nearest (``floor(x + 0.5)``)
  with a constant fill for the mask; *skipped* when u < p (the reference's
  inverted test, kept; train.py binds p=15, so it never fires there);
- RandomScale: scale by s ~ U(0.5, 2), pad centred, crop at a random
  offset, as one inverse map: edge-clamped half-pixel bilinear for the
  image, ``floor(x / s + 1e-4)`` for the mask (cv2.resize's rules);
- Gaussian blur with p 0.5, sigma ~ U(0, 3), the imgaug odd-ksize rule, a
  fixed 9-tap window, cv2's reflect-101 border and the uint8 round;
- per-sample horizontal flip with p 0.5;
- ColorJitter: *skipped* when u < p; brightness and contrast through the
  reference's integer LUT formulas (factor quantized to 2^-12), saturation
  as PIL's blend toward its 'L' gray, hue through PIL's uint8 HSV; the
  active ops in a random per-sample order;
- ToTensor + Normalize.

The warps are explicit index gathers, as in JAX, not ``grid_sample``
(whose nearest rounds half to even and whose borders are not cv2's). Each
transform is a deterministic function of the batch and its random draws,
given as tensors; ``sample_draws`` makes the draws from the train state's
``torch.Generator``. The JAX package draws from threefry, so the tests
inject the same draws into both.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
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


# ---------------------------------------------------------------- warps --

def _coords(inv: torch.Tensor, h: int, w: int):
    """Source coordinates (sx, sy), each (N,H,W) f32, of every destination
    pixel under the (N,2,3) inverse affine maps ``inv``:
    src = inv @ (x, y, 1), rounded as JAX rounds it (products, then sums
    left to right)."""
    yy = torch.arange(h, dtype=torch.float32, device=inv.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=inv.device)[None, :]
    a = inv[:, :, :, None, None]
    return (a[:, 0, 0] * xx + a[:, 0, 1] * yy + a[:, 0, 2],
            a[:, 1, 0] * xx + a[:, 1, 1] * yy + a[:, 1, 2])


def _take(x: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor
          ) -> torch.Tensor:
    """x[n, yi, xi] for (N,H,W[,C]) x and int indices in range that
    broadcast to (N,H,W)."""
    yi, xi = torch.broadcast_tensors(yi, xi)
    n, h, w = x.shape[:3]
    base = torch.arange(n, device=x.device)[:, None, None] * (h * w)
    flat = (base + yi * w + xi).reshape(-1)
    return x.reshape((n * h * w,) + x.shape[3:])[flat].reshape(
        yi.shape + x.shape[3:])


def affine_sample_bilinear(images: torch.Tensor, inv: torch.Tensor
                           ) -> torch.Tensor:
    """(N,H,W,C) f32 images sampled bilinearly at the inverse-mapped
    coordinates, each tap outside the image 0 (warpAffine's constant
    border). JAX's ``_affine_sample_bilinear``."""
    _, h, w, _ = images.shape
    sx, sy = _coords(inv, h, w)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()

    def tap(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = _take(images, yi.clamp(0, h - 1), xi.clamp(0, w - 1))
        return torch.where(inb[..., None], v, torch.zeros_like(v))

    v00, v01 = tap(y0i, x0i), tap(y0i, x0i + 1)
    v10, v11 = tap(y0i + 1, x0i), tap(y0i + 1, x0i + 1)
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def affine_sample_nearest(masks: torch.Tensor, inv: torch.Tensor,
                          fill: int) -> torch.Tensor:
    """(N,H,W) masks sampled at ``floor(src + 0.5)`` (cv2's INTER_NEAREST
    in warpAffine), ``fill`` outside. JAX's ``_affine_sample_nearest``."""
    _, h, w = masks.shape
    sx, sy = _coords(inv, h, w)
    xi, yi = torch.floor(sx + 0.5).long(), torch.floor(sy + 0.5).long()
    inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    v = _take(masks, yi.clamp(0, h - 1), xi.clamp(0, w - 1))
    return torch.where(inb, v, torch.full_like(v, fill))


def rotation_inverse(angle_deg: torch.Tensor, h: int, w: int
                     ) -> torch.Tensor:
    """(N,2,3) inverses of cv2.getRotationMatrix2D((w/2, h/2), angle, 1)
    for (N,) angles in degrees: the rotation by the same angle with the
    sign of sin swapped. JAX's ``_rotation_inverse``."""
    a = angle_deg.float() * (math.pi / 180.0)
    cx, cy = w / 2.0, h / 2.0
    cos, sin = torch.cos(a), torch.sin(a)
    return torch.stack([
        torch.stack([cos, -sin, (1 - cos) * cx + sin * cy], dim=-1),
        torch.stack([sin, cos, -sin * cx + (1 - cos) * cy], dim=-1)], dim=1)


def rotate(images: torch.Tensor, masks: torch.Tensor, angles: torch.Tensor,
           fill: int):
    """Rotate sample i by ``angles[i]`` degrees (0 where the rotation is
    skipped) about its centre (transforms.py:129-164): (f32 images, masks
    with ``fill`` where the rotated mask does not reach)."""
    _, h, w, _ = images.shape
    inv = rotation_inverse(angles, h, w)
    return (affine_sample_bilinear(images.float(), inv),
            affine_sample_nearest(masks, inv, fill))


def scale_pad_crop(images: torch.Tensor, masks: torch.Tensor,
                   s: torch.Tensor, uy: torch.Tensor, ux: torch.Tensor,
                   fill: int = 0):
    """RandomScale's deterministic core (transforms.py:85-127): sample i
    resized by ``s[i]`` (cv2 rounds the size), padded centred to at least
    the original size (image 0, mask ``fill``) and cropped back at the
    offset ``floor(u * (pad + 1))`` of the fractions ``uy``, ``ux`` in
    [0, 1). One inverse map per sample, as JAX's ``scale_pad_crop``:
    cv2.resize with fx = fy = s samples at 1/s, half-pixel and
    edge-clamped for the image, ``floor(dst / s + 1e-4)`` for the mask
    (the 1e-4 keeps f32 from landing just below an exact integer where
    cv2's f64 lands on or above it)."""
    _, h, w, _ = images.shape
    dev = images.device
    b = (slice(None), None, None)
    sh, sw = torch.round(h * s), torch.round(w * s)
    pad_top = torch.clamp(torch.floor((h - sh) / 2.0), min=0.0)
    pad_left = torch.clamp(torch.floor((w - sw) / 2.0), min=0.0)
    max_y = torch.maximum(sh, torch.full_like(sh, h)) - h
    max_x = torch.maximum(sw, torch.full_like(sw, w)) - w
    off_y = torch.floor(uy * (max_y + 1))
    off_x = torch.floor(ux * (max_x + 1))
    f = 1.0 / s
    zero = torch.zeros_like(f)
    inv = torch.stack([
        torch.stack([f, zero, (off_x - pad_left + 0.5) * f - 0.5], dim=-1),
        torch.stack([zero, f, (off_y - pad_top + 0.5) * f - 0.5], dim=-1)],
        dim=1)
    sx, sy = _coords(inv, h, w)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    x1i, y1i = (x0i + 1).clamp(0, w - 1), (y0i + 1).clamp(0, h - 1)
    x0i, y0i = x0i.clamp(0, w - 1), y0i.clamp(0, h - 1)
    x = images.float()
    im = ((_take(x, y0i, x0i) * (1 - fx) + _take(x, y0i, x1i) * fx)
          * (1 - fy)
          + (_take(x, y1i, x0i) * (1 - fx) + _take(x, y1i, x1i) * fx) * fy)

    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    eps = 1e-4
    mx = torch.floor(f[b] * xx + ((off_x - pad_left) * f)[b] + eps).long()
    my = torch.floor(f[b] * yy + ((off_y - pad_top) * f)[b] + eps).long()
    ry, rx = yy + (off_y - pad_top)[b], xx + (off_x - pad_left)[b]
    inside = (ry >= 0) & (ry < sh[b]) & (rx >= 0) & (rx < sw[b])
    inb = (my >= 0) & (my < h) & (mx >= 0) & (mx < w) & inside
    m = _take(masks, my.clamp(0, h - 1), mx.clamp(0, w - 1))
    m = torch.where(inb, m, torch.full_like(m, fill))
    im = torch.where(inside[..., None], im, torch.zeros_like(im))
    return im, m


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


def adjust_saturation(img: torch.Tensor, factor: torch.Tensor
                      ) -> torch.Tensor:
    """PIL's ImageEnhance.Color: a blend toward PIL's 'L' gray
    ``(19595 c0 + 38470 c1 + 7471 c2 + 0x8000) >> 16`` with the luma
    weights on the channels in array order (the reference hands PIL a BGR
    array; transforms.py:305-321), rounded and clipped to uint8 values."""
    c0, c1, c2 = img[..., 0], img[..., 1], img[..., 2]
    gray = torch.floor((19595.0 * c0 + 38470.0 * c1 + 7471.0 * c2
                        + 32768.0) / 65536.0)[..., None]
    out = gray + (img - gray) * factor[:, None, None, None]
    return torch.round(torch.clamp(out, 0, 255))


def adjust_hue(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """PIL's uint8 HSV hue shift (transforms.py:240-282), on the channels
    in array order as if they were RGB (the reference's quirk): H, S, V
    quantized to uint8, ``uint8(factor * 255)`` added to H with uint8
    wraparound, and PIL's hsv2rgb back with p, q, t rounded. JAX's
    ``_adjust_hue`` step for step (within +-1 hue unit of PIL on ~0.8% of
    pixels, as JAX's is)."""
    c0, c1, c2 = img[..., 0], img[..., 1], img[..., 2]
    mx = torch.maximum(c0, torch.maximum(c1, c2))
    mn = torch.minimum(c0, torch.minimum(c1, c2))
    cr = mx - mn
    one = torch.ones_like(cr)
    safe = torch.where(cr > 0, cr, one)
    rc, gc, bc = (mx - c0) / safe, (mx - c1) / safe, (mx - c2) / safe
    h = torch.where(mx == c0, bc - gc,
                    torch.where(mx == c1, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0 + 1.0, 1.0)
    zero = torch.zeros_like(cr)
    uh = torch.where(cr > 0, torch.floor(h * 255.0), zero)
    us = torch.where(cr > 0, torch.floor(
        cr / torch.where(mx > 0, mx, one) * 255.0), zero)
    uv = mx
    shift = torch.remainder(torch.trunc(factor * 255.0), 256.0)
    uh = torch.remainder(uh + shift[:, None, None], 256.0)
    h6 = uh * float(np.float32(6.0 / 255.0))
    i = torch.floor(h6)
    f = h6 - i
    sf = us * float(np.float32(1.0 / 255.0))
    p = torch.round(uv * (1 - sf))
    q = torch.round(uv * (1 - sf * f))
    t = torch.round(uv * (1 - sf * (1 - f)))
    vv = torch.round(uv)
    sector = i.long() % 6

    def select(*by_sector):
        out = by_sector[5]
        for k in range(4, -1, -1):
            out = torch.where(sector == k, by_sector[k], out)
        return out

    out = torch.stack([select(vv, q, p, p, t, vv), select(t, vv, vv, q, p, p),
                       select(p, p, t, vv, vv, q)], dim=-1)
    # s == 0 (gray) short-circuits to v in PIL
    return torch.where((us == 0)[..., None], uv[..., None], out)


JITTER_OPS = {"brightness": adjust_brightness, "contrast": adjust_contrast,
              "saturation": adjust_saturation, "hue": adjust_hue}


@functools.lru_cache(maxsize=None)
def jitter_orders(k: int, device: torch.device) -> torch.Tensor:
    """(k!, k): row r is ``itertools.permutations(range(k))``'s r-th order,
    the orders JAX's color_jitter stacks, in its order; on ``device`` once
    (no host-to-device copy per batch)."""
    return torch.tensor(list(itertools.permutations(range(k))),
                        dtype=torch.long).reshape(-1, k).to(device)


def color_jitter(images: torch.Tensor, factors: Dict[str, torch.Tensor],
                 perm: torch.Tensor = None) -> torch.Tensor:
    """Apply the active jitter ops (``factors``: op name -> (N,) factor,
    1.0 (hue: 0.0) where skipped) to (N,H,W,C) f32 images. With several
    ops and ``perm`` (N,) given, sample i applies them in the order of
    permutation ``perm[i]`` of ``itertools.permutations``; otherwise in the
    order of ``factors`` (brightness, contrast, saturation, hue).

    JAX computes every order for the whole batch and selects (k! branches:
    24 with four ops, ~0.5 GB at b10 360x480 in f32). Each op is
    elementwise per sample, so taking at each position j the op that
    sample i's order puts there gives the same values from k x k op
    passes and k live outputs."""
    ops = [(JITTER_OPS[k], f) for k, f in factors.items()]
    if len(ops) <= 1 or perm is None:
        for fn, f in ops:
            images = fn(images, f)
        return images
    order = jitter_orders(len(ops), images.device)[perm]   # (N, k)
    x = images
    for j in range(len(ops)):
        pick = order[:, j, None, None, None]
        out = x
        for op, (fn, f) in enumerate(ops):
            out = torch.where(pick == op, fn(x, f), out)
        x = out
    return x


# --------------------------------------------------------------- recipe --

def _rotates(cfg: AugmentConfig) -> bool:
    # the reference skips rotation when u < p, so p >= 1 never rotates
    # (train.py binds p=15): no warp, as in JAX
    return bool(cfg.rotation_angle) and cfg.rotation_p < 1.0


def _jitter_ops(cfg: AugmentConfig):
    return [(k, v) for k, v in (("brightness", cfg.jitter_brightness),
                                ("contrast", cfg.jitter_contrast),
                                ("saturation", cfg.jitter_saturation),
                                ("hue", cfg.jitter_hue)) if v]


def sample_draws(generator: torch.Generator, n: int, cfg: AugmentConfig,
                 device) -> Dict[str, torch.Tensor]:
    """The recipe's random draws for a batch of ``n``, from ``generator``
    (which must live on ``device``)."""
    def u(lo=0.0, hi=1.0):
        return torch.rand(n, generator=generator, device=device) \
            * (hi - lo) + lo

    d = {}
    if _rotates(cfg):
        apply = u() >= cfg.rotation_p   # skipped when u < p
        angle = u(-cfg.rotation_angle, cfg.rotation_angle)
        d["rotation_apply"] = apply
        d["rotation_angle"] = torch.where(apply, angle,
                                          torch.zeros_like(angle))
    if cfg.random_scale:
        d["scale_s"] = u(*cfg.scale_range)
        d["scale_uy"], d["scale_ux"] = u(), u()
    if cfg.blur_p > 0:
        d["blur_apply"] = u() < cfg.blur_p
        d["blur_sigma"] = u(0.0, 3.0)
    if cfg.hflip_p > 0:
        d["flip"] = u() < cfg.hflip_p
    ops = _jitter_ops(cfg)
    if ops:
        apply = u() >= cfg.jitter_p  # the reference skips when u < p
        for name, v in ops:
            if name == "hue":
                f = u(-v, v)
                d[name] = torch.where(apply, f, torch.zeros_like(f))
            else:
                f = u(max(0.0, 1.0 - v), 1.0 + v)
                d[name] = torch.where(apply, f, torch.ones_like(f))
        if len(ops) > 1 and cfg.jitter_random_order:
            k = math.factorial(len(ops))
            d["jitter_perm"] = torch.randint(0, k, (n,),
                                             generator=generator,
                                             device=device)
    return d


def augment_with_draws(cfg: AugmentConfig, images: torch.Tensor,
                       masks: torch.Tensor, draws: Dict[str, torch.Tensor],
                       compute_dtype: torch.dtype = torch.float32):
    """The recipe on uint8 (N,H,W,3) images and (N,H,W) masks with the
    given draws, in JAX's order: rotation -> scale -> blur -> hflip ->
    jitter -> normalize. Returns (images in ``compute_dtype``, masks as
    int64)."""
    x, m = images.float(), masks
    if _rotates(cfg):
        x, m = rotate(x, m, draws["rotation_angle"], cfg.rotation_fill)
    if cfg.random_scale:
        x, m = scale_pad_crop(x, m, draws["scale_s"], draws["scale_uy"],
                              draws["scale_ux"], cfg.scale_fill)
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
    """augment_fn(generator, images_u8, masks, rows=None) -> (images,
    masks int64) for ``train/steps.py::make_train_step``. ``rows=(start,
    total)``: the batch is the rows ``start:start + n`` of a global batch
    of ``total`` (a data-parallel rank's), and takes those rows of the
    global batch's draws, so the generator advances as for ``total``."""

    def fn(generator, images, masks, rows=None):
        n = images.shape[0]
        start, total = rows if rows is not None else (0, n)
        draws = sample_draws(generator, total, cfg, images.device)
        if rows is not None:
            draws = {k: v[start: start + n] for k, v in draws.items()}
        return augment_with_draws(cfg, images, masks, draws, compute_dtype)

    return fn
