"""The port's multi-process training on the CPU: ``run_training`` on two
ranks through the train CLI's ``-multihost`` (the ``PCT_*`` contract),
against the same run on one rank; the two-rank checkpoint resumed on one;
``train_tpu`` on two replicas; and the rules around them: the ``PCT_*``
parse, the backend rule, ``-dp 0`` as every visible card and ``-dp`` above
the visible cards.

As the JAX package's ``tests/test_multihost.py``: two worker processes,
each the real CLI (UNet narrowed to width 1/16 by the worker script, which
imports only the port), meet at a ``file://`` rendezvous under the test's
temporary directory (gloo: CPU ranks). Rank 0 alone prints the epochs and
writes checkpoints; the ranks end bit-equal (the loop checks it and rank 0
says so); the run agrees with one rank on the same global batch within
JAX's limits (mIoU 0.02, parameter checksum rtol 1e-3)."""

import dataclasses
import functools
import importlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pytorch_camvid_tpu_torch import serve as serve_cli
from pytorch_camvid_tpu_torch import train_tpu
from pytorch_camvid_tpu_torch.data import camvid
from pytorch_camvid_tpu_torch.data.synthetic import synthetic_arrays
from pytorch_camvid_tpu_torch.models import get_model
from pytorch_camvid_tpu_torch.parallel import launch, make_mesh, multihost
from pytorch_camvid_tpu_torch.train import checkpoint as ckpt
from pytorch_camvid_tpu_torch.train import loop

train_cli = importlib.import_module("pytorch_camvid_tpu_torch.train.__main__")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (32, 32)
# UNet at width 1/16 and a checkpoint every epoch, in the workers and in
# the one-rank run
WORKER = """
import dataclasses, functools, importlib, sys
from pytorch_camvid_tpu_torch.models import get_model
from pytorch_camvid_tpu_torch.train import loop
cli = importlib.import_module("pytorch_camvid_tpu_torch.train.__main__")
loop.get_model = functools.partial(get_model, width_mult=1 / 16)
cli.default_settings = dataclasses.replace(cli.default_settings,
                                           SAVE_EPOCH=1)
cli.main(sys.argv[1:])
"""


def _write_caches(root):
    for split, (n, seed) in {"train": (8, 3), "val": (6, 4)}.items():
        images, labels = synthetic_arrays(n, HW, seed=seed)
        camvid.write_cache(camvid.cache_path(root, split, HW[::-1]), images,
                           labels, [f"{split}{i}.png" for i in range(n)])
    return root


def _argv(root):
    # val 6 at batch 4: the two-rank eval pads its second batch with two
    # 255 rows; one rank runs it ragged
    return ["-net", "unet", "-b", "4", "-e", "1", "-lr", "1e-3", "-data",
            root, "-image_size", str(HW[1]), str(HW[0]), "-device", "cpu",
            "-dtype", "float32", "-chain", "4"]


def _hidden_tensorflow(path):
    (path / "tensorflow").mkdir(parents=True)
    (path / "tensorflow" / "__init__.py").write_text(
        "raise ImportError('tensorflow is hidden from this test')\n")
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-rank ``-multihost`` run (both processes' output) and the
    one-rank run of the same arguments (its history)."""
    tmp = tmp_path_factory.mktemp("multihost")
    root = _write_caches(str(tmp / "data"))
    stub = _hidden_tensorflow(tmp / "stub")
    mh, one = tmp / "mh", tmp / "one"
    mh.mkdir()
    one.mkdir()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, stub]),
               OMP_NUM_THREADS="2", PCT_NUM_PROCS="2",
               PCT_COORDINATOR=f"file://{tmp}/rendezvous",
               PCT_INIT_TIMEOUT="300")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, "-multihost"] + _argv(root),
        cwd=str(mh), env=dict(env, PCT_PROC_ID=str(i)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], \
        [o[-3000:] for o in outs]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(loop, "get_model", functools.partial(get_model,
                                                        width_mult=1 / 16))
        mp.setattr(train_cli, "default_settings", dataclasses.replace(
            train_cli.default_settings, SAVE_EPOCH=1))
        mp.setitem(sys.modules, "tensorflow", None)
        mp.chdir(one)
        torch.set_num_threads(2)
        history = train_cli.main(_argv(root))
    finally:
        mp.undo()
    return {"outs": outs, "mh": str(mh), "one": str(one),
            "history": history, "root": root}


def _ckpt(run_dir):
    (run,) = os.listdir(os.path.join(run_dir, "checkpoints"))
    (name,) = os.listdir(os.path.join(run_dir, "checkpoints", run))
    return os.path.join(run_dir, "checkpoints", run, name)


def _checksum(path):
    return float(sum(np.abs(v.numpy()).sum() for k, v in
                     ckpt.load_weights(path, "unet").items()
                     if v.is_floating_point()))


def test_multihost_training_matches_one_rank(runs):
    out0, out1 = runs["outs"]
    assert "distributed: 2 ranks, backend gloo (ranks on the CPU)" in out0
    # rank 0 owns the console, the run folders and the checkpoints
    assert "Training Epoch:" in out0 and "Mean_iou" in out0
    assert "Training Epoch:" not in out1 and "Mean_iou" not in out1
    assert "the 2 ranks' states agree bit for bit" in out0
    for d in ("checkpoints", "runs"):
        assert len(os.listdir(os.path.join(runs["mh"], d))) == 1, d
    miou = float(re.findall(r"Mean_iou ([\d.]+)", out0)[-1])
    assert abs(miou - runs["history"][-1]["miou"]) < 0.02
    np.testing.assert_allclose(_checksum(_ckpt(runs["mh"])),
                               _checksum(_ckpt(runs["one"])), rtol=1e-3)


def test_two_rank_checkpoint_resumes_on_one_rank(runs, monkeypatch):
    """Elastic 2 -> 1: one rank resumes the two-rank run's checkpoint with
    its step and every leaf as saved, then trains its second epoch."""
    monkeypatch.setattr(loop, "get_model", functools.partial(
        get_model, width_mult=1 / 16))
    torch.set_num_threads(2)
    path = _ckpt(runs["mh"])
    train = camvid.CamVid(runs["root"], image_set="train",
                          image_size=HW[::-1])
    val = camvid.CamVid(runs["root"], image_set="val", image_size=HW[::-1])
    cfg = loop.TrainConfig(
        net="unet", batch_size=4, lr=1e-3, epochs=1, resume=True,
        quiet=True, device="cpu", checkpoint_dir=os.path.join(
            os.path.dirname(os.path.dirname(path)), "resumed"))
    state, history = loop.run_training(cfg, train, val)
    assert history == [] and state.step == 2
    z = np.load(path)
    for i, (name, a) in enumerate(ckpt.port_leaves(state)):
        np.testing.assert_array_equal(a, z[f"leaf_{i}"], err_msg=name)
    state, history = loop.run_training(
        loop.TrainConfig(**{**cfg.__dict__, "epochs": 2}), train, val)
    assert [h["epoch"] for h in history] == [2] and state.step == 4
    assert np.isfinite(history[0]["miou"])


def test_train_tpu_two_replicas_match_one(tmp_path, monkeypatch):
    """``train_tpu`` (explicit mode, SGD, warmup) on two CPU replicas of
    one image each against one replica of two: with no ignored pixels the
    mean of the ranks' means is the global mean, and sync-BN makes the
    batch moments global, so the epochs agree. Spawned ranks build the
    full-width UNet (they do not see a narrowed model)."""
    root = _write_caches(str(tmp_path / "data"))
    monkeypatch.syspath_prepend(_hidden_tensorflow(tmp_path / "stub"))
    argv = ["-e", "1", "-warm", "1", "-lr", "1e-3", "-data", root,
            "-image_size", str(HW[1]), str(HW[0]), "-device", "cpu",
            "-dtype", "float32"]
    two = train_tpu.main(argv + ["-dp", "2", "-b", "1"])
    torch.set_num_threads(4)
    one = train_tpu.main(argv + ["-dp", "1", "-b", "2"])
    assert [h["epoch"] for h in two] == [h["epoch"] for h in one] == [1]
    assert abs(two[0]["miou"] - one[0]["miou"]) < 0.02
    np.testing.assert_allclose(two[0]["loss"], one[0]["loss"], rtol=1e-3)


def test_pct_contract_and_backend_rule(monkeypatch):
    assert multihost.init_method_from("10.0.0.1:1234") == \
        "tcp://10.0.0.1:1234"
    assert multihost.init_method_from("file:///tmp/r") == "file:///tmp/r"
    for name in ("PCT_COORDINATOR", "PCT_NUM_PROCS", "PCT_PROC_ID"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="PCT_COORDINATOR"):
        multihost.init_distributed()
    monkeypatch.setenv("PCT_COORDINATOR", "localhost:1")
    monkeypatch.setenv("PCT_NUM_PROCS", "2")
    monkeypatch.setenv("PCT_PROC_ID", "2")
    with pytest.raises(ValueError, match="rank 2 of 2"):
        multihost.init_distributed()
    # devices: an explicit wish is kept; "cuda" takes the rank's place on
    # its host modulo the host's cards
    table = [("a", 2, "cuda"), ("a", 2, "cuda"), ("b", 1, "cuda"),
             ("b", 1, "cuda"), ("c", 0, "cpu")]
    devs = multihost.devices_from_table(table)
    assert [str(d) for d in devs] == ["cuda:0", "cuda:1", "cuda:0",
                                      "cuda:0", "cpu"]
    with pytest.raises(RuntimeError, match="sees none"):
        multihost.devices_from_table([("a", 0, "cuda")])
    hosts = [h for h, _, _ in table]
    assert multihost.choose_backend(hosts[:2], devs[:2]) == (
        "nccl", "one card per rank")
    assert multihost.choose_backend(hosts[:3], devs[:3]) == (
        "nccl", "one card per rank")
    assert multihost.choose_backend(hosts[2:4], devs[2:4]) == (
        "gloo", "ranks share a card")
    assert multihost.choose_backend(hosts, devs) == (
        "gloo", "ranks on the CPU")


def test_dp_counts_visible_cards(monkeypatch, tmp_path):
    """``-dp 0`` is every visible card (one CPU rank); ``-dp`` above the
    visible cards exits with the JAX serve CLI's message, in the train,
    train_tpu and serve CLIs; a mesh asked for more ranks than the
    process group has raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert launch.rank_count(0, "cuda") == 3
    assert launch.rank_count(2, "cuda") == 2
    assert launch.rank_count(0, "cpu") == 1
    assert launch.rank_count(3, "cpu") == 3
    assert launch.local_devices(2, "cuda") == ["cuda:0", "cuda:1"]
    with pytest.raises(SystemExit, match="-dp 4 but only 3 devices"):
        launch.rank_count(4, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for main, argv in ((train_cli.main, ["-net", "unet"]),
                       (train_tpu.main, [])):
        with pytest.raises(SystemExit, match="-dp 5 but only 3 devices"):
            main(argv + ["-dp", "5", "-dtype", "bfloat16"])
    with pytest.raises(SystemExit, match="-dp 4 but only 3 devices"):
        serve_cli.main(["-weight", "w.pth", "-input", str(tmp_path),
                        "-output", str(tmp_path / "out"), "-dp", "4"])
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(2)
    multihost.init_distributed(f"file://{tmp_path}/rendezvous", 1, 0, "cpu")
    try:
        assert make_mesh(0).world == 1 and make_mesh().levels
        with pytest.raises(ValueError, match="process group has 1 ranks"):
            make_mesh(2)
    finally:
        multihost.shutdown()


def test_put_global_hands_a_rank_its_rows():
    """``put_global``: a rank's rows of an array every rank holds whole
    under a batch sharding, all of it under a replicated one."""
    from pytorch_camvid_tpu_torch.parallel import (batch_sharding, put_global,
                                                   replicated_sharding)
    from pytorch_camvid_tpu_torch.parallel.mesh import Mesh
    x = np.arange(24).reshape(6, 4)
    mesh = Mesh(3, 1, torch.device("cpu"))
    np.testing.assert_array_equal(
        put_global(x, batch_sharding(mesh)).numpy(), x[2:4])
    np.testing.assert_array_equal(
        put_global(torch.from_numpy(x), replicated_sharding(mesh)).numpy(), x)
    with pytest.raises(ValueError, match="must divide over 3 ranks"):
        put_global(x[:4], batch_sharding(mesh))
