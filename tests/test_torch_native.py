"""The port's native data runtime (``data/native.py``) and ``HostLoader``
on the CPU: the four cases of tests/test_native.py against the library the
port builds into its ``_build/`` (``native/`` untouched), the numpy
fallback, and HostLoader's batches against the JAX package's HostLoader
and the port's DeviceDataLoader."""

import os

import numpy as np
import pytest
import torch

from pytorch_camvid_tpu.data.pipeline import HostLoader as JaxHostLoader

from pytorch_camvid_tpu_torch.data import native
from pytorch_camvid_tpu_torch.data.pipeline import (DeviceDataLoader,
                                                    HostLoader)


def _listing(path):
    return sorted((e.name, e.stat().st_size, e.stat().st_mtime_ns)
                  for e in os.scandir(path))


@pytest.fixture(scope="module")
def built():
    """The library built (or found) in ``_build/``; ``native/`` keeps its
    files as they were."""
    before = _listing(native.NATIVE_DIR)
    assert native.native_available(), native.build_error()
    lib = native.build()
    assert lib.parent == native.BUILD_DIR and lib.exists()
    assert native.build_key()[:16] in lib.name
    assert _listing(native.NATIVE_DIR) == before
    return lib


def test_record_store_roundtrip(tmp_path, built):
    path = str(tmp_path / "store.cvrs")
    rng = np.random.default_rng(0)
    records = [rng.integers(0, 256, size=rng.integers(1, 500),
                            dtype=np.uint8).tobytes() for _ in range(17)]
    records.append(b"")  # an empty record
    native.RecordStore.write(path, records)
    store = native.RecordStore(path)
    assert len(store) == 18
    for i, r in enumerate(records):
        assert store[i] == r
    assert store[-1] == b""
    with pytest.raises(IndexError):
        store[18]
    store.close()


def test_gather_matches_numpy(built):
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, size=(50, 9, 7, 3), dtype=np.uint8)
    idx = rng.integers(0, 50, size=16)
    got = native.gather_batch(data, idx, nthreads=4)
    np.testing.assert_array_equal(got, data[idx])
    out = np.empty((16, 9, 7, 3), np.uint8)
    assert native.gather_batch(data, idx, out) is out
    np.testing.assert_array_equal(out, data[idx])
    with pytest.raises(IndexError):
        native.gather_batch(data, np.array([50]))
    with pytest.raises(ValueError):
        native.gather_batch(data, idx, np.empty((15, 9, 7, 3), np.uint8))


def test_permutation_deterministic_and_valid(built):
    p1 = native.permutation(100, seed=7)
    p2 = native.permutation(100, seed=7)
    p3 = native.permutation(100, seed=8)
    np.testing.assert_array_equal(p1, p2)
    assert not np.array_equal(p1, p3)
    assert sorted(p1.tolist()) == list(range(100))


def test_prefetcher_covers_epoch(built):
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, size=(23, 4, 5), dtype=np.uint8)
    pf = native.NativePrefetcher(data, batch=5, seed=3, shuffle=True)
    seen = []
    for batch in pf:
        assert batch.shape[1:] == (4, 5)
        seen.append(batch)
    pf.close()
    got = np.concatenate(seen)
    assert got.shape == (23, 4, 5)  # the full epoch, its ragged tail too

    def key(a):
        return sorted(map(bytes, a.reshape(len(a), -1)))
    assert key(got) == key(data)


def test_numpy_fallback_gives_the_same_results(tmp_path, monkeypatch,
                                               built):
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, size=(30, 6, 5), dtype=np.uint8)
    idx = rng.integers(0, 30, size=9)
    records = [b"ab", b"", b"cde"]
    native.RecordStore.write(str(tmp_path / "n.cvrs"), records)
    want = native.gather_batch(data, idx)
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.native_available()
    np.testing.assert_array_equal(native.gather_batch(data, idx), want)
    store = native.RecordStore(str(tmp_path / "n.cvrs"))   # native-written
    assert [store[i] for i in range(3)] == records
    native.RecordStore.write(str(tmp_path / "f.cvrs"), records)
    assert (tmp_path / "f.cvrs").read_bytes() == \
        (tmp_path / "n.cvrs").read_bytes()


@pytest.mark.parametrize("drop_last", [True, False])
def test_host_loader_batches_equal_jax_and_device_loader(drop_last, built):
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (11, 4, 5, 3), dtype=np.uint8)
    masks = rng.integers(0, 12, (11, 4, 5), dtype=np.uint8)
    kw = dict(shuffle=True, seed=5, drop_last=drop_last)
    host = HostLoader(imgs, masks, 3, device="cpu", **kw)
    dev = DeviceDataLoader(imgs, masks, 3, device="cpu", **kw)
    jax_host = JaxHostLoader(imgs, masks, 3, **kw)
    assert len(host) == len(dev) == len(jax_host) == (3 if drop_last else 4)
    for e in range(2):
        got = list(host.epoch(e))
        want = list(jax_host.epoch(e))
        ref = list(dev.epoch(e))
        assert len(got) == len(want) == len(ref) == len(host)
        for (gi, gl), (wi, wl), (ri, rl) in zip(got, want, ref):
            assert gi.dtype == torch.uint8 and gl.dtype == torch.uint8
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
            np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
            assert torch.equal(gi, ri) and torch.equal(gl, rl)
    np.testing.assert_array_equal(host.epoch_indices(4),
                                  dev.epoch_indices(4))
    assert host.native_gathers == host.gathers > 0


def test_host_loader_prefetch_then_gather(built):
    """The loop's protocol: gather(t), prefetch(t + 1); a gather of rows
    not prefetched stages them, and stale prefetches are dropped."""
    rng = np.random.default_rng(6)
    imgs = rng.integers(0, 256, (12, 3, 4, 3), dtype=np.uint8)
    masks = rng.integers(0, 12, (12, 3, 4), dtype=np.uint8)
    host = HostLoader(imgs, masks, 4, shuffle=True, seed=1, drop_last=True,
                      device="cpu")
    plan = host.epoch_indices(0)
    for t, idx in enumerate(plan):
        im, lb = host.gather(idx)
        np.testing.assert_array_equal(im.numpy(), imgs[idx])
        np.testing.assert_array_equal(lb.numpy(), masks[idx])
        if t + 1 < len(plan):
            host.prefetch(plan[t + 1])
    host.prefetch(plan[0])                 # a prefetch the plan skips
    im, _ = host.gather(plan[2])
    np.testing.assert_array_equal(im.numpy(), imgs[plan[2]])
    assert host.gathers == len(plan) + 2
