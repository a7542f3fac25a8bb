"""The port's train, eval, predict and bench entry points on the CPU: the
three CLIs end to end in fresh interpreters with ``-device cpu`` on a tiny
CamVid tree (full-width UNet at 64x48, the default float32), and the rules
every entry point keeps: CUDA by default with no fallback, float32 the
default compute dtype as in the JAX CLIs, and flags whose parts are not
ported naming their ROADMAP.md item."""

import ast
import dataclasses
import functools
import importlib
import inspect
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

cv2 = pytest.importorskip("cv2")

from pytorch_camvid_tpu.data.synthetic import write_synthetic_camvid  # noqa
from pytorch_camvid_tpu.utils import stats as jstats  # noqa: E402

from pytorch_camvid_tpu_torch import bench, eval as eval_cli, predict  # noqa
from pytorch_camvid_tpu_torch import lr_finder  # noqa: E402
from pytorch_camvid_tpu_torch import compute_stats  # noqa: E402
from pytorch_camvid_tpu_torch.config import settings  # noqa: E402
from pytorch_camvid_tpu_torch.data import camvid, voc2012  # noqa: E402
from pytorch_camvid_tpu_torch.data.normalize import (  # noqa: E402
    to_tensor_normalize)
from pytorch_camvid_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_arrays)
from pytorch_camvid_tpu_torch.models import (  # noqa: E402
    get_model, spec_from_state_dict)
from pytorch_camvid_tpu_torch.train import loop, make_train_step  # noqa
from pytorch_camvid_tpu_torch.train.checkpoint import (  # noqa: E402
    load_weights)

train_cli = importlib.import_module("pytorch_camvid_tpu_torch.train.__main__")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The subprocesses' environment. TensorFlow is hidden from them:
    ``torch.utils.tensorboard`` then writes through tensorboard's own stub
    instead of importing TensorFlow, which takes ~16 s on this host and
    changes nothing the tests read. Two intra-op threads each: several test
    workers share the cores."""
    stub = tmp_path_factory.mktemp("no_tensorflow")
    (stub / "tensorflow").mkdir()
    (stub / "tensorflow" / "__init__.py").write_text(
        "raise ImportError('tensorflow is hidden from this test')\n")
    return dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, str(stub)]),
                OMP_NUM_THREADS="2")


def _run(args, cwd, env, timeout=300):
    return subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_train_then_eval_then_predict(tmp_path, env):
    write_synthetic_camvid(str(tmp_path / "data"), n_train=4, n_val=3,
                           hw=(48, 64), structured=True)
    common = ["-image_size", "64", "48", "-device", "cpu"]
    r = _run(["pytorch_camvid_tpu_torch.train", "-net", "unet", "-b", "2",
              "-e", "1", *common], str(tmp_path), env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert len(re.findall(r"^Training Epoch:1 \[\d/4\]", r.stdout,
                          re.M)) == 2
    miou = re.search(r"^Mean_iou (\S+)$", r.stdout, re.M).group(1)
    (run,) = os.listdir(tmp_path / "checkpoints")
    # one epoch of one: past epochs // 2 = 0, so a best save
    assert os.listdir(tmp_path / "checkpoints" / run) == [
        "1-best.ckpt.npz"]
    assert os.listdir(tmp_path / "runs" / run)
    weight = str(tmp_path / "checkpoints" / run / "1-best.ckpt.npz")

    r = _run(["pytorch_camvid_tpu_torch.eval", "-weight", weight, "-b", "2",
              *common], str(tmp_path), env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert f"miou: {miou}\n" in r.stdout
    for key in ("precision", "recall", "loss"):
        assert re.search(rf"^{key}: \d+\.\d{{4}}$", r.stdout, re.M)

    img = str(tmp_path / "data" / "camvid" / "images" / "seq000.png")
    r = _run(["pytorch_camvid_tpu_torch.predict", "-img", img, "-weight",
              weight, "-device", "cpu"], str(tmp_path), env)
    assert r.returncode == 0, r.stderr[-3000:]
    src = cv2.imread(img)
    for name in ("src.jpg", "predict.jpg", "predict_color.png"):
        out = cv2.imread(str(tmp_path / name))
        assert out is not None and out.shape[:2] == src.shape[:2], name
    classes = cv2.imread(str(tmp_path / "predict.jpg"), cv2.IMREAD_GRAYSCALE)
    assert classes.max() < 16   # class indices (JPEG blurs them a little)


def test_default_device_fails_without_cuda(tmp_path, env):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(["pytorch_camvid_tpu_torch.train", "-net", "unet"],
             str(tmp_path), env, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not os.path.exists(tmp_path / "checkpoints")
    for main, argv in ((eval_cli.main, ["-weight", "w.pth"]),
                       (predict.main, ["-img", "x.png", "-weight", "w.pth"]),
                       (bench.main, [])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


@pytest.mark.parametrize("main,argv", [
    (train_cli.main, ["-net", "unet"]), (eval_cli.main, ["-weight", "w"])])
def test_float32_on_cuda_is_refused_at_startup(main, argv):
    """float32 on a CUDA device runs the card's f32 kernels: the entry
    points take it, so on a host without a card the one refusal at
    startup is the device check's (no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv + ["-device", "cuda", "-dtype", "float32"])


def _write_caches(root, hw=(45, 60)):
    """CamVid and VOC split caches at ``hw`` (no cv2 needed): VOC's with
    21 classes and letterbox rows of 255 at the top and bottom."""
    for split, (n, seed) in {"train": (4, 1), "val": (3, 2)}.items():
        images, labels = synthetic_arrays(n, hw, seed=seed)
        camvid.write_cache(camvid.cache_path(root, split, hw[::-1]), images,
                           labels, [f"{split}{i}.png" for i in range(n)])
        images, labels = synthetic_arrays(n, hw, 21, seed=seed)
        labels[:, :3] = labels[:, -3:] = 255
        voc2012.write_cache(voc2012.cache_path(root, split, hw[::-1]),
                            images, labels, [f"{split}{i}" for i in range(n)])
    return root


@pytest.fixture
def tiny_run(tmp_path, monkeypatch):
    """In-process CLI runs on the CPU from ``tmp_path``: UNet at width 1/16
    and TensorFlow hidden from tensorboard (as ``env`` hides it)."""
    monkeypatch.setattr(loop, "get_model", functools.partial(
        get_model, width_mult=1 / 16))
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    monkeypatch.chdir(tmp_path)
    root = _write_caches(str(tmp_path / "data"))
    return ["-data", root, "-image_size", "60", "45", "-dtype", "float32",
            "-device", "cpu"]


# ROADMAP.md Queue 1 items that are done: their flags run
PORTED_ITEMS = {"VOC reader", "the rest of augmentation and the pipeline",
                "remat"}


@pytest.mark.parametrize("main,argv,item", [
    (train_cli.main, ["-multihost"], "multi-GPU"),
    (train_cli.main, ["-dp", "2"], "multi-GPU"),
    (train_cli.main, ["-dataset", "voc2012"], "VOC reader"),
    (train_cli.main, ["-loader", "host"],
     "the rest of augmentation and the pipeline"),
    (train_cli.main, ["-remat"], "remat"),
    (eval_cli.main, ["-int8"], "int8"),
    (eval_cli.main, ["-dataset", "voc2012"], "VOC reader")])
def test_unported_flags_name_their_roadmap_item(main, argv, item, request):
    """A flag of a Queue 1 item raises, naming it, until the item is
    ported; then it runs: one tiny CPU epoch (train) or eval pass."""
    base = (["-net", "unet"] if main is train_cli.main
            else ["-weight", "w.pth"])
    if item not in PORTED_ITEMS:
        with pytest.raises(NotImplementedError, match=f"Queue 1: {item}"):
            main(base + argv + ["-device", "cpu"])
        return
    common = request.getfixturevalue("tiny_run")
    if main is train_cli.main:
        history = main(base + argv + ["-b", "2", "-e", "1", "-quiet"]
                       + common)
        assert [h["epoch"] for h in history] == [1]
        assert np.isfinite(history[0]["miou"])
        return
    model = get_model("unet", 3, 21, width_mult=1 / 16)
    torch.save(model.state_dict(), "w.pth")
    out = main(base + argv + ["-b", "2"] + common)
    assert set(out) == {"miou", "precision", "recall", "loss"}
    assert all(np.isfinite(v) for v in out.values())


def test_voc2012_train_then_eval_keep_255_out(tiny_run, monkeypatch):
    """-dataset voc2012 through the train and eval CLIs at 45x60: the
    training loss ignores 255 (the letterbox rows), the eval CLI's mIoU is
    the loop's, and its loss and mIoU are the ones computed here over the
    non-255 pixels with VOC's mean and std."""
    seen = {}

    def train_step(*a, **kw):
        seen["ignore_index"] = kw["ignore_index"]
        return make_train_step(*a, **kw)
    monkeypatch.setattr(loop, "make_train_step", train_step)
    # a checkpoint after the one epoch, best or not (an untrained model's
    # mIoU may be 0, which saves no best)
    monkeypatch.setattr(train_cli, "default_settings", dataclasses.replace(
        train_cli.default_settings, SAVE_EPOCH=1))
    history = train_cli.main(["-net", "unet", "-b", "2", "-e", "1",
                              "-dataset", "voc2012", "-quiet"] + tiny_run)
    assert seen["ignore_index"] == 255
    (run,) = os.listdir("checkpoints")
    (name,) = os.listdir(os.path.join("checkpoints", run))
    weight = os.path.join("checkpoints", run, name)
    out = eval_cli.main(["-weight", weight, "-b", "2", "-dataset",
                         "voc2012"] + tiny_run)
    assert abs(out["miou"] - history[0]["miou"]) <= 1e-9

    sd = load_weights(weight, "unet")
    model = get_model("unet", spec=spec_from_state_dict("unet", sd))
    model.load_state_dict(sd)
    model.eval()
    val = voc2012.VOC2012Aug(tiny_run[1], "val", image_size=(60, 45))
    cm, losses = torch.zeros(21, 21, dtype=torch.float64), []
    with torch.no_grad():
        for lo in range(0, len(val), 2):
            x = to_tensor_normalize(torch.from_numpy(val.images[lo:lo + 2]),
                                    settings.VOC_MEAN, settings.VOC_STD)
            y = torch.from_numpy(val.labels[lo:lo + 2]).long()
            logits = model(x)
            losses.append(F.cross_entropy(logits.permute(0, 3, 1, 2), y,
                                          ignore_index=255))
            keep = y != 255
            cm += torch.bincount(y[keep] * 21 + logits.argmax(-1)[keep],
                                 minlength=21 * 21).reshape(21, 21)
    assert cm.sum() == (val.labels != 255).sum() < val.labels.size
    iou = cm.diag() / (cm.sum(0) + cm.sum(1) - cm.diag())
    assert abs(out["miou"] - float(np.nanmean(iou.numpy()))) <= 1e-9
    np.testing.assert_allclose(out["loss"], float(sum(losses) / len(losses)),
                               rtol=1e-5)


def test_compute_stats_both_datasets(tmp_path):
    """CamVid's cache at its native size and VOC's at the reader's default
    480x360, as the JAX tool reads them (small arrays under those names)."""
    root = str(tmp_path)
    images, labels = synthetic_arrays(3, (20, 24), seed=5)
    camvid.write_cache(camvid.cache_path(root, "train", None), images,
                       labels, ["a", "b", "c"])
    voc2012.write_cache(voc2012.cache_path(root, "train", (480, 360)),
                        images[::-1].copy(), labels, ["a", "b", "c"])
    for dataset, imgs in (("camvid", images), ("voc2012", images[::-1])):
        mean, std = compute_stats.main(["-data", root, "-dataset", dataset])
        want = jstats.compute_mean_and_std(imgs)
        np.testing.assert_allclose(mean, want[0], rtol=1e-12)
        np.testing.assert_allclose(std, want[1], rtol=1e-12)
        assert len(mean) == 3 and all(0 < m < 1 for m in mean)


def _jax_cli_default(script: str, flag: str):
    """The default of ``flag`` in the JAX package's root CLI ``script``
    (its parser is built under ``__main__``, so read from the source)."""
    tree = ast.parse(open(os.path.join(REPO, script)).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"
                and node.args and getattr(node.args[0], "value", "") == flag):
            return next(k.value.value for k in node.keywords
                        if k.arg == "default")
    return None


def test_help_states_the_bf16_default():
    """The train, eval and LR finder CLIs default to float32 as the JAX
    CLIs do (train.py's and eval.py's -dtype; lr_finder.py has no -dtype
    and runs the JAX train step at its float32 default), and their help
    states no bf16-only rule; -device defaults to cuda."""
    from pytorch_camvid_tpu.train.steps import (
        make_train_step as jax_make_train_step)
    assert _jax_cli_default("train.py", "-dtype") == "float32"
    assert _jax_cli_default("eval.py", "-dtype") == "float32"
    assert _jax_cli_default("lr_finder.py", "-dtype") is None
    assert inspect.signature(jax_make_train_step).parameters[
        "compute_dtype"].default == np.float32
    for parser in (train_cli.parser(), eval_cli.parser(),
                   lr_finder.parser()):
        assert parser.get_default("dtype") == "float32"
        assert parser.get_default("device") == "cuda"
        assert "bf16 only" not in " ".join(parser.format_help().split())
    assert predict.parser().get_default("device") == "cuda"


def test_bench_main_keys_and_rows(monkeypatch):
    """bench.main's JSON object has the JAX bench's keys, its headline is
    UNet's b24 train row and SegNet trains at b32; the rows are measured
    on the card, so here they are stand-ins."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "train_row", lambda net, b, device: {
        "images_per_sec": {"unet": 72.0, "segnet": 110.0}[net],
        "mfu": 0.08, "batch_size": b, "card": "c"})
    monkeypatch.setattr(bench, "measure_serving", lambda net, device: {
        "images_per_sec": 900.0, "card": "c"})
    out = bench.main([])
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "mfu",
                        "extra"}
    assert out["metric"] == \
        "camvid_unet_360x480_train_images_per_sec_per_chip"
    assert out["value"] == 72.0 and out["vs_baseline"] == 72.0 / 3.6
    assert out["mfu"] == 0.08 and out["unit"] == "images/sec/chip"
    assert set(out["extra"]) == {"unet_train", "segnet_train",
                                 "unet_serving_fwd", "segnet_serving_fwd"}
    assert out["extra"]["segnet_train"]["batch_size"] == 32
    assert out["extra"]["unet_train"]["batch_size"] == 24
    with pytest.raises(ValueError, match="CUDA device"):
        bench.main(["-device", "cpu"])
