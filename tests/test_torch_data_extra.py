"""The port's VOC reader, TableBorder, palette strip, nearest resize and
class-based transforms against the JAX package on the CPU (as
tests/test_datasets_extra.py and tests/test_transforms_compat.py hold the
JAX package's)."""

import os
import pickle

import numpy as np
import jax.numpy as jnp
import pytest
import torch

cv2 = pytest.importorskip("cv2")
from PIL import Image  # noqa: E402

from pytorch_camvid_tpu.data import transforms as JT  # noqa: E402
from pytorch_camvid_tpu.data.synthetic import write_synthetic_voc  # noqa
from pytorch_camvid_tpu.data.tableborder import TableBorder as JaxTB  # noqa
from pytorch_camvid_tpu.data.voc2012 import VOC2012Aug as JaxVOC  # noqa
from pytorch_camvid_tpu.ops.resize import resize_nearest_cv2 as jax_nearest

from pytorch_camvid_tpu_torch.data import transforms as T  # noqa: E402
from pytorch_camvid_tpu_torch.data import voc2012  # noqa: E402
from pytorch_camvid_tpu_torch.data.segmentation_aug import strip_palette
from pytorch_camvid_tpu_torch.data.tableborder import TableBorder
from pytorch_camvid_tpu_torch.ops.resize import resize_nearest_cv2


def _same_split(a, b):
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.names == b.names
    assert (a.class_num, a.ignore_index) == (b.class_num, b.ignore_index)


def test_voc2012_builds_the_jax_cache_and_reads_jax_s(tmp_path):
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    for root in (ours, theirs):
        write_synthetic_voc(root, n_train=3, n_val=2)
    for split, n in (("train", 3), ("val", 2)):
        got = voc2012.VOC2012Aug(ours, split, image_size=(96, 72))
        want = JaxVOC(theirs, split, image_size=(96, 72))
        _same_split(got, want)
        assert len(got) == n and got.images.shape == (n, 72, 96, 3)
        assert got.class_num == 21 and got.ignore_index == 255
        assert got.class_names == voc2012.VOC_CLASS_NAMES
        # the letterbox: rows of 255 where the aspect leaves a band
        assert (got.labels == 255).any()
        assert set(np.unique(got.labels)) <= set(range(21)) | {255}
        # one cache for both packages: the same file name, and each
        # package reads the other's
        name = os.path.basename(voc2012.cache_path(ours, split, (96, 72)))
        assert sorted(f for f in os.listdir(ours) if f.endswith(".npz")) \
            == sorted(f for f in os.listdir(theirs) if f.endswith(".npz"))
        assert os.path.exists(os.path.join(theirs, name))
        _same_split(voc2012.VOC2012Aug(theirs, split, image_size=(96, 72)),
                    want)
        _same_split(JaxVOC(ours, split, image_size=(96, 72)), got)
    img, lab = got[0]
    assert img.shape == (72, 96, 3) and lab.shape == (72, 96)
    with pytest.raises(RuntimeError):
        voc2012.VOC2012Aug(ours, "test")


def test_voc2012_cache_written_without_a_tree(tmp_path):
    """chip_smoke's route on a host without cv2: write_cache's file is the
    reader's cache."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, 6, 8, 3), dtype=np.uint8)
    labels = rng.integers(0, 21, (4, 6, 8), dtype=np.uint8)
    labels[:, 0] = 255
    root = str(tmp_path / "voc")
    voc2012.write_cache(voc2012.cache_path(root, "train", (8, 6)), images,
                        labels, [f"n{i}" for i in range(4)])
    ds = voc2012.VOC2012Aug(root, "train", image_size=(8, 6))
    np.testing.assert_array_equal(ds.images, images)
    np.testing.assert_array_equal(ds.labels, labels)
    _same_split(JaxVOC(root, "train", image_size=(8, 6)), ds)


def test_strip_palette(tmp_path):
    src = tmp_path / "SegmentationClassAug"
    dst = tmp_path / "SegmentationClassAugRaw"
    os.makedirs(src)
    lab = np.random.default_rng(1).integers(0, 21, size=(40, 50),
                                            dtype=np.uint8)
    im = Image.fromarray(lab, mode="P")
    im.putpalette([v for i in range(256) for v in (i, 0, 0)])
    im.save(src / "a.png")
    assert strip_palette(str(src), str(dst)) == 1
    np.testing.assert_array_equal(np.array(Image.open(dst / "a.png")), lab)


@pytest.mark.parametrize("size", [None, (40, 30)])
def test_tableborder_matches_jax(tmp_path, size):
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "labels"))
    rng = np.random.default_rng(2)
    for i in range(2):
        img = rng.integers(0, 256, size=(60, 80, 3), dtype=np.uint8)
        cv2.imwrite(os.path.join(root, "images", f"t{i}.png"), img)
        rows = rng.integers(0, 2, size=(60, 80)).astype(np.uint8)
        cols = rng.integers(0, 2, size=(60, 80)).astype(np.uint8)
        with open(os.path.join(root, "labels", f"t{i}.pkl"), "wb") as f:
            pickle.dump((rows, cols), f)
    ds, want = TableBorder(root, image_size=size), JaxTB(root,
                                                         image_size=size)
    assert len(ds) == len(want) == 2
    assert (ds.class_num, ds.ignore_index) == (2, None)
    for i in range(2):
        (gi, gm), (wi, wm) = ds[i], want[i]
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)
        assert gm.shape == (size[::-1] if size else (60, 80)) + (2,)
    if size is None:
        np.testing.assert_array_equal(ds[1][1][..., 0], rows)
        np.testing.assert_array_equal(ds[1][1][..., 1], cols)


@pytest.mark.parametrize("hw,out", [((40, 56), (20, 30)), ((37, 51), (90, 61)),
                                    ((45, 60), (45, 60)), ((7, 9), (3, 4))])
def test_resize_nearest_matches_jax_and_cv2(hw, out):
    rng = np.random.default_rng(3)
    masks = rng.integers(0, 21, (2,) + hw, dtype=np.uint8)
    got = resize_nearest_cv2(torch.from_numpy(masks), out).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_nearest(jnp.asarray(masks), out)))
    for m, g in zip(masks, got):
        np.testing.assert_array_equal(g, cv2.resize(
            m, out[::-1], interpolation=cv2.INTER_NEAREST))
    imgs = rng.integers(0, 256, (2,) + hw + (3,), dtype=np.uint8)
    np.testing.assert_array_equal(
        resize_nearest_cv2(torch.from_numpy(imgs), out).numpy(),
        np.asarray(jax_nearest(jnp.asarray(imgs), out)))


# ---------------------------------------------------- class-based transforms

def _pair(h=40, w=56, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8),
            rng.integers(0, 12, size=(h, w), dtype=np.uint8))


def test_compose_pipeline_runs():
    T.seed(0)
    img, mask = _pair()
    pipe = T.Compose([
        T.Resize((64, 48)),
        T.RandomScale(value=11),
        T.RandomRotation(0.0, fill=11),   # p=0 -> always rotates (quirk)
        T.RandomGaussianBlur(),
        T.RandomHorizontalFlip(),
        T.ColorJitter(0.0, 0.4, 0.4, 0.4, 0.1),
        T.Lambda(lambda x: x),
        T.ToTensor(),
        T.Normalize((0.42, 0.41, 0.40), (0.30, 0.31, 0.305)),
    ])
    out_img, out_mask = pipe(img, mask)
    assert out_img.shape == (48, 64, 3) and out_img.dtype == np.float32
    assert out_mask.shape == (48, 64) and out_mask.dtype == np.int32
    assert set(np.unique(out_mask)) <= set(range(12))
    assert repr(pipe).startswith("Compose(")


def test_resize_matches_jax_and_cv2():
    img, mask = _pair()
    ri, rm = T.Resize((30, 20))(img, mask)
    wi, wm = JT.Resize((30, 20))(img, mask)
    np.testing.assert_array_equal(rm, wm)
    np.testing.assert_array_equal(rm, cv2.resize(
        mask, (30, 20), interpolation=cv2.INTER_NEAREST))
    assert ri.dtype == np.uint8 and np.abs(
        ri.astype(np.int32) - wi.astype(np.int32)).max() <= 1
    want_i = cv2.resize(img.astype(np.float32), (30, 20))
    assert np.abs(ri.astype(np.float32) - want_i).max() <= 1.0


def test_hflip_and_the_skip_quirks():
    img, mask = _pair(seed=1)
    fi, fm = T.RandomHorizontalFlip(p=1.0)(img, mask)
    np.testing.assert_array_equal(fi, img[:, ::-1])
    np.testing.assert_array_equal(fm, mask[:, ::-1])
    # p >= 1 skips rotation and jitter (u < p), p = 0 blurs nothing
    for t in (T.RandomRotation(15, fill=11), T.ColorJitter(1.0, 0.4, 0.4),
              T.RandomGaussianBlur(p=0.0)):
        oi, om = t(img, mask)
        np.testing.assert_array_equal(oi, img)
        np.testing.assert_array_equal(om, mask)


def test_rotation_and_scale_equal_the_batched_ops():
    """Each class is its batched op on the draws it takes."""
    img, mask = _pair(seed=2)
    T.seed(5)
    oi, om = T.RandomRotation(0.0, angle=10, fill=11)(img, mask)
    T.seed(5)
    g = T._Rng.generator
    u = torch.rand(1, generator=g)
    angle = torch.rand(1, generator=g) * 20 - 10
    assert bool(u >= 0.0)
    wi, wm = T.A.rotate(torch.from_numpy(img)[None].float(),
                        torch.from_numpy(mask)[None], angle, 11)
    np.testing.assert_array_equal(om, wm[0].numpy())
    np.testing.assert_array_equal(
        oi, np.round(wi[0].numpy()).clip(0, 255).astype(np.uint8))
    assert (om == 11).any()


def test_to_tensor_normalize_formula():
    img, mask = _pair(seed=3)
    t, m = T.ToTensor()(img, mask)
    wt, wm = JT.ToTensor()(img, mask)
    np.testing.assert_array_equal(t, wt)
    assert t.max() <= 1.0 and m.dtype == wm.dtype == np.int32
    n, _ = T.Normalize((0.5, 0.5, 0.5), (0.25, 0.25, 0.25))(t, m)
    np.testing.assert_allclose(n, (img / 255.0 - 0.5) / 0.25, atol=1e-6)


def test_seeded_reproducibility():
    img, mask = _pair(seed=4)
    outs = []
    for _ in range(2):
        T.seed(42)
        outs.append(T.Compose([T.RandomScale(value=11),
                               T.ColorJitter(0.0, 0.4, 0.4, 0.4, 0.1)])(
            img, mask))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    with pytest.raises(ValueError):
        T.RandomRotation(angle=0)
    with pytest.raises(ValueError):
        T.RandomGaussianBlur(sigma=(0.0, 5.0))
