"""``eval -int8`` and ``serve -int8`` of the port on the CPU, on tiny
synthetic data: they run, the eval CLI's figures are the JAX package's
``eval.py -int8`` (the root script, run in-process on the same caches and
weights at the same width), and the serve CLI writes the masks that the
Predictor it wraps gives after ``quantize_int8`` on the served images.

UNet at width 1/4 (64 output channels from ``down3``, so ``min_cout`` 64
quantizes 12 of its 23 blocks), 45x60, f32 (eval's default). The two eval
passes quantize from their own calibrations, so the figures agree within
2e-3 (a few pixels of 9 images' 2700; the JAX int8 path and the port's
plain version compute the same exact int32 sums and the same f32 ops)."""

import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch

from pytorch_camvid_tpu_torch import eval as eval_cli
from pytorch_camvid_tpu_torch import serve as serve_cli
from pytorch_camvid_tpu_torch.data import camvid
from pytorch_camvid_tpu_torch.data.synthetic import synthetic_arrays
from pytorch_camvid_tpu_torch.models import get_model
from pytorch_camvid_tpu_torch.ops import quant
from pytorch_camvid_tpu_torch.serving import Predictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (45, 60)
WIDTH = 1 / 4


@pytest.fixture
def weights(tmp_path, monkeypatch):
    """A width-1/4 UNet (He-scaled convs, non-trivial BN stats) saved as
    a reference .pth, CamVid caches at 45x60, and the CLI's common
    flags."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    monkeypatch.chdir(tmp_path)
    torch.set_num_threads(2)
    gen = torch.Generator().manual_seed(0)
    model = get_model("unet", 3, 12, width_mult=WIDTH, generator=gen)
    with torch.no_grad():   # He-scaled, so activations stay O(1)
        for blk in model.blocks():
            conv, bn = blk.conv_bn()
            conv.weight.normal_(0.0, (2.0 / conv.weight[0].numel()) ** 0.5,
                                generator=gen)
            bn.running_mean.normal_(0, 0.1, generator=gen)
            bn.running_var.uniform_(0.5, 2.0, generator=gen)
    path = str(tmp_path / "unet.pth")
    torch.save(model.state_dict(), path)
    root = str(tmp_path / "data")
    for split, (n, seed) in {"train": (2, 1), "val": (9, 2)}.items():
        images, labels = synthetic_arrays(n, HW, seed=seed)
        camvid.write_cache(camvid.cache_path(root, split, HW[::-1]), images,
                           labels, [f"{split}{i}.png" for i in range(n)])
    return path, ["-weight", path, "-net", "unet", "-data", root,
                  "-image_size", str(HW[1]), str(HW[0]), "-b", "2"]


def _jax_eval(argv, monkeypatch, capsys) -> dict:
    """The JAX package's root eval.py with ``argv``, its model built at
    the test width; returns its printed figures."""
    import pytorch_camvid_tpu.models as jmodels
    import pytorch_camvid_tpu.runtime as jruntime
    base = jmodels.get_model

    def narrow(net, cin, classes):
        init_fn, apply_fn = base(net, cin, classes)
        return (lambda key, **kw: init_fn(key, width_mult=WIDTH, **kw),
                apply_fn)
    monkeypatch.setattr(jmodels, "get_model", narrow)
    monkeypatch.setattr(jruntime, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(sys, "argv", ["eval.py"] + argv)
    capsys.readouterr()
    runpy.run_path(os.path.join(REPO, "eval.py"), run_name="__main__")
    out = capsys.readouterr().out
    return {k: float(v) for k, v in
            re.findall(r"^(miou|precision|recall|loss): ([-\d.na]+)$", out,
                       re.M)}


def test_eval_int8_matches_jax_eval(weights, monkeypatch, capsys):
    _, argv = weights
    got = eval_cli.main(argv + ["-int8", "-device", "cpu"])
    flt = eval_cli.main(argv + ["-device", "cpu"])
    want = _jax_eval(argv + ["-int8"], monkeypatch, capsys)
    assert set(want) == set(got) == {"miou", "precision", "recall", "loss"}
    for k in got:
        assert np.isfinite(got[k])
        assert abs(got[k] - want[k]) <= 2e-3, (k, got[k], want[k])
    assert got != flt   # the int8 pass is not the float one


def test_eval_int8_quantizes_the_wide_blocks(weights, monkeypatch):
    """-int8 calibrates on the first 4 val batches, then quantizes every
    block of 64 or more output channels; the head stays float."""
    _, argv = weights
    seen = {}
    real = quant.quantize_model

    def spy(model, amax, *a, **kw):
        seen["batches"] = amax
        out = real(model, amax, *a, **kw)
        seen["int8"] = [b.conv_bn()[0].out_channels
                        for b in quant.quantized_blocks(model)]
        seen["float"] = [b.conv_bn()[0].out_channels for b in
                         model.blocks() if not b.quantized]
        return out
    calls = []
    real_cal = quant.calibrate
    monkeypatch.setattr(eval_cli, "quantize_model", spy)
    monkeypatch.setattr(eval_cli, "calibrate", lambda m, b: calls.append(
        len(b)) or real_cal(m, b))
    eval_cli.main(argv + ["-int8", "-device", "cpu"])
    assert calls == [4]
    assert len(seen["int8"]) == 12 and min(seen["int8"]) >= 64
    assert max(seen["float"]) < 64 and 12 in seen["float"]


def test_serve_int8_writes_the_quantized_predictors_masks(weights,
                                                          tmp_path):
    cv2 = pytest.importorskip("cv2")
    path, _ = weights
    src = tmp_path / "imgs"
    src.mkdir()
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (3, 40, 56, 3), dtype=np.uint8)
    for i, img in enumerate(imgs):
        cv2.imwrite(str(src / f"{i}.png"), img)
    out = tmp_path / "masks"
    assert serve_cli.main(["-weight", path, "-input", str(src), "-output",
                           str(out), "-b", "2", "-int8", "-device",
                           "cpu"]) == 0
    with Predictor.from_checkpoint("unet", path, batch_size=2,
                                   device="cpu") as p:
        p.quantize_int8(imgs)
        assert len(quant.quantized_blocks(p.model)) == 12
        want = p.predict(imgs)
    for i in range(3):
        m = cv2.imread(str(out / f"{i}_mask.png"), cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(m, want[i])


def test_int8_on_cuda_without_a_card_raises(weights, tmp_path):
    """-int8 on the default device fails without a card, as every other
    option does: no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cv2 = pytest.importorskip("cv2")
    path, argv = weights
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_cli.main(argv + ["-int8", "-device", "cuda"])
    img = str(tmp_path / "a.png")
    cv2.imwrite(img, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["-weight", path, "-input", img, "-output",
                        str(tmp_path / "o"), "-int8"])
