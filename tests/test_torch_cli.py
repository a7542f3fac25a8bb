"""The port's train, eval, predict and bench entry points on the CPU: the
three CLIs end to end in fresh interpreters with ``-device cpu`` on a tiny
CamVid tree (full-width UNet at 64x48, the default bf16), and the rules
every entry point keeps: CUDA by default with no fallback, float32 refused
on a CUDA device, and flags whose parts are not ported naming their
ROADMAP.md item."""

import importlib
import os
import re
import subprocess
import sys

import pytest
import torch

cv2 = pytest.importorskip("cv2")

from pytorch_camvid_tpu.data.synthetic import write_synthetic_camvid  # noqa

from pytorch_camvid_tpu_torch import bench, eval as eval_cli, predict  # noqa

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
    with pytest.raises(NotImplementedError, match="f32 on the card"):
        main(argv + ["-device", "cuda", "-dtype", "float32"])


@pytest.mark.parametrize("main,argv,item", [
    (train_cli.main, ["-multihost"], "multi-GPU"),
    (train_cli.main, ["-dp", "2"], "multi-GPU"),
    (train_cli.main, ["-dataset", "voc2012"], "VOC reader"),
    (train_cli.main, ["-loader", "host"],
     "the rest of augmentation and the pipeline"),
    (train_cli.main, ["-remat"], "remat"),
    (eval_cli.main, ["-int8"], "int8"),
    (eval_cli.main, ["-dataset", "voc2012"], "VOC reader")])
def test_unported_flags_name_their_roadmap_item(main, argv, item):
    base = (["-net", "unet"] if main is train_cli.main
            else ["-weight", "w.pth"])
    with pytest.raises(NotImplementedError, match=f"Queue 1: {item}"):
        main(base + argv + ["-device", "cpu"])


def test_help_states_the_bf16_default():
    for parser in (train_cli.parser(), eval_cli.parser()):
        assert parser.get_default("dtype") == "bfloat16"
        assert parser.get_default("device") == "cuda"
        assert "unlike the JAX CLI's float32" in " ".join(
            parser.format_help().split())
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
