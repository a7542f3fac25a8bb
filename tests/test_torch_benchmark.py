"""The port's data-side CLIs and readers against the JAX package, on the
CPU: the record-store CamVid (``data/camvid_records.py``), ``plot_dataset``
(``utils/viz.py``), the data-pipeline benchmark (``benchmark.py``, the
counterpart of the root ``benchmark.py``) and the batch sweep
(``batch_sweep.py``, the counterpart of ``tools/batch_sweep.py``), with
``measure_train`` stubbed: it times a CUDA card."""

import io
import json
import math
import os
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from pytorch_camvid_tpu.data.camvid import CamVid as JaxCamVid
from pytorch_camvid_tpu.data.camvid_records import (
    CamVidRecords as JaxCamVidRecords)
from pytorch_camvid_tpu.data.synthetic import write_synthetic_camvid
from pytorch_camvid_tpu.utils.viz import plot_dataset as jax_plot_dataset

from pytorch_camvid_tpu_torch import batch_sweep, bench, benchmark
from pytorch_camvid_tpu_torch.data.camvid import CamVid
from pytorch_camvid_tpu_torch.data.camvid_records import (CamVidRecords,
                                                          records_path)
from pytorch_camvid_tpu_torch.data.synthetic import synthetic_arrays
from pytorch_camvid_tpu_torch.utils.viz import dataset_grid, plot_dataset

# the root benchmark.py's line
LINE = re.compile(r"total (\d+) samples, total \d+\.\d\ds, "
                  r"average \d+ samples/sec")
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny ops: one intra-op thread (spinning pools slow tier-1's
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the records

def _tree(root, hw=(64, 96)):
    write_synthetic_camvid(str(root), n_train=4, n_val=2, hw=hw)
    return str(root)


@pytest.mark.parametrize("image_size", [None, (48, 32)])
@pytest.mark.parametrize("maker", ["jax", "port"])
def test_each_package_reads_the_others_record_store(tmp_path, maker,
                                                    image_size):
    """The store one package builds is the other's file, byte for byte,
    and both read it item by item alike, with and without a resize."""
    root = _tree(tmp_path)
    made = {"jax": JaxCamVidRecords, "port": CamVidRecords}[maker]
    made(root, image_set="train")
    path = records_path(root, "train")
    built = open(path, "rb").read()
    other = _tree(tmp_path / "other")
    {"jax": CamVidRecords, "port": JaxCamVidRecords}[maker](
        other, image_set="train")
    assert open(records_path(other, "train"), "rb").read() == built
    jax_ds = JaxCamVidRecords(root, image_set="train", image_size=image_size)
    port_ds = CamVidRecords(root, image_set="train", image_size=image_size)
    assert len(jax_ds) == len(port_ds) == 4
    for i in range(4):
        (ji, jl), (pi, pl) = jax_ds[i], port_ds[i]
        assert ji.dtype == pi.dtype == np.uint8
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pl, jl)
        if image_size is not None:
            assert pi.shape == image_size[::-1] + (3,)
    assert not os.path.exists(path + ".tmp")


def test_records_match_the_array_cache_as_jax_tests_them(tmp_path):
    """JAX's tests/test_records_profiling.py on the port: the records
    equal the packed-array CamVid (PNG is lossless), and a val store
    resizes."""
    root = _tree(tmp_path)
    arr = CamVid(root, image_set="train", image_size=None)
    rec = CamVidRecords(root, image_set="train")
    assert len(arr) == len(rec) == 4
    jarr = JaxCamVid(root, image_set="train", image_size=None)
    for i in range(4):
        (ai, al), (ri, rl) = arr[i], rec[i]
        np.testing.assert_array_equal(ai, ri)
        np.testing.assert_array_equal(al, rl)
        np.testing.assert_array_equal(jarr[i][1], rl)
    assert rec.class_num == 12 and rec.ignore_index == 11
    img, lab = CamVidRecords(root, image_set="val", image_size=(48, 32))[0]
    assert img.shape == (32, 48, 3) and lab.shape == (32, 48)
    with pytest.raises(RuntimeError):
        CamVidRecords(root, image_set="test")


# ----------------------------------------------------------- plot_dataset

@pytest.mark.parametrize("seed,count", [(0, 3), (None, 9)])
def test_plot_dataset_grid_equals_jax(tmp_path, seed, count):
    """The same seeded draws, the same palette and the same file, byte for
    byte; labels at or past the class count (Void's 11 here is in range,
    255 is not) are black."""
    images, labels = synthetic_arrays(5, (12, 16), seed=4)
    labels[0, :2] = 255
    want = jax_plot_dataset(images, labels, str(tmp_path / "jax.png"),
                            count=count, rng_seed=seed)
    got = plot_dataset(images, labels, str(tmp_path / "port.png"),
                       count=count, rng_seed=seed)
    assert got == str(tmp_path / "port.png")
    assert open(got, "rb").read() == open(want, "rb").read()
    grid = dataset_grid(images, labels, count, rng_seed=seed)
    assert grid.shape == (12 * min(count, 5), 32, 3)
    import cv2
    np.testing.assert_array_equal(cv2.imread(want), grid)


# ------------------------------------------------------------- benchmark

def _lines(fn, *args):
    out = io.StringIO()
    with redirect_stdout(out):
        n = fn(*args)
    return n, out.getvalue().splitlines()


def _jax_counts(n_images, batch, epochs):
    """The counts at which the root benchmark.py prints, by its own
    arithmetic (no epoch passes its 60 s cap here)."""
    count, printed = 0, []
    for _ in range(epochs):
        for _ in range(0, n_images, batch):
            count += batch
            if count % 1000 < batch:
                printed.append(count)
    return printed + [count]


@pytest.mark.parametrize("batch,epochs", [(8, 16), (10, 15)])
def test_benchmark_synthetic_on_the_cpu_prints_jax_lines(batch, epochs):
    """``-device cpu -synthetic`` at a small size: JAX's line at JAX's
    sample counts (64 images, ceil(64 / b) batches an epoch)."""
    args = benchmark.parser().parse_args(
        ["-device", "cpu", "-synthetic", "-b", str(batch), "-epochs",
         str(epochs)])
    n, lines = _lines(benchmark.run, args, (12, 16))
    counts = [int(LINE.fullmatch(ln).group(1)) for ln in lines]
    assert counts == _jax_counts(64, batch, epochs)
    assert n == counts[-1] == epochs * math.ceil(64 / batch) * batch


def test_benchmark_runs_on_the_card_unless_asked():
    """Without ``-device`` the augmentation runs on the card; with no card
    that fails (no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmark.main(["-synthetic", "-epochs", "1"])


def test_benchmark_records_on_the_host(tmp_path):
    """``-records``: the store is built on first use, then each epoch
    decodes every train record; JAX's first line and its last."""
    root = _tree(tmp_path)
    args = benchmark.parser().parse_args(
        ["-records", "-data", root, "-epochs", "3"])
    n, lines = _lines(benchmark.run, args, (32, 48))
    assert re.fullmatch(r"record store: 4 records, native lib: "
                        r"(True|False)", lines[0])
    assert [int(LINE.fullmatch(ln).group(1)) for ln in lines[1:]] == [12]
    assert n == 12 and os.path.exists(records_path(root, "train"))


# ------------------------------------------------------------ batch_sweep

@pytest.fixture
def sweep(monkeypatch):
    """batch_sweep on the CPU: a card that is there, a small model, and
    ``measure_train`` stubbed (it runs out of memory past batch 32)."""
    calls = []

    def measure_train(model, batch_size, steps, remat=False):
        calls.append((batch_size, steps, remat))
        if batch_size > 32:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return {"images_per_sec": 10.0 * batch_size, "step_ms": 1.5,
                "losses": [2.5], "max_memory_allocated": batch_size << 20}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "card", lambda index=0: CARD)
    monkeypatch.setattr(bench, "he_model",
                        lambda net, gen: torch.nn.Identity())
    monkeypatch.setattr(bench, "measure_train", measure_train)
    return calls


def test_batch_sweep_rows_dedupe_and_out_of_memory(sweep, tmp_path,
                                                   capsys):
    out = str(tmp_path / "rows.jsonl")
    rows = batch_sweep.main(["-net", "unet", "-batches", "16", "48",
                             "-steps", "3", "-remat", "-out", out])
    assert [r["batch_size"] for r in rows] == [16, 48]
    assert all(r["card"] == CARD and r["remat"] and r["steps"] == 3
               and r["net"] == "unet" for r in rows)
    assert "error" not in rows[0] and "losses" not in rows[0]
    assert rows[0]["images_per_sec"] == 160.0
    assert rows[1]["error"].startswith("OutOfMemoryError: CUDA out of memory")
    assert sweep == [(16, 3, True), (48, 3, True)]
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert printed == rows
    with open(out) as f:
        assert [json.loads(ln) for ln in f] == rows
    # again: 16 is recorded and skipped, the failed 48 is tried again, and
    # 16 without -remat is another row
    rows2 = batch_sweep.main(["-net", "unet", "-batches", "16", "48",
                              "-steps", "3", "-remat", "-out", out])
    assert [r["batch_size"] for r in rows2] == [48]
    rows3 = batch_sweep.main(["-net", "unet", "-batches", "16", "-steps",
                              "3", "-out", out])
    assert [(r["batch_size"], r["remat"]) for r in rows3] == [(16, False)]
    skipped = json.loads(capsys.readouterr().out.splitlines()[0])
    assert skipped == {"net": "unet", "batch_size": 16, "remat": True,
                       "skipped": "already recorded"}
    assert sweep[2:] == [(48, 3, True), (16, 3, False)]


def test_batch_sweep_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_sweep.main(["-batches", "8"])
    with pytest.raises(ValueError, match="measures a CUDA device"):
        batch_sweep.main(["-device", "cpu"])
