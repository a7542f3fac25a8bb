"""``python -m pytorch_camvid_tpu_torch.serve`` end to end on the CPU, and
the port's independence from jax, each in a fresh interpreter."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_serve_cli_writes_masks(tmp_path):
    from pytorch_camvid_tpu_torch.models import get_model
    model = get_model("unet", 3, 12, width_mult=1 / 16,
                      generator=torch.Generator().manual_seed(0))
    weight = str(tmp_path / "unet.pth")
    torch.save(model.state_dict(), weight)

    src = tmp_path / "imgs"
    src.mkdir()
    rng = np.random.default_rng(3)
    # ragged sizes: resized per image on the host to the working size
    for name, hw in [("a", (60, 88)), ("b", (48, 72)), ("c", (60, 88))]:
        cv2.imwrite(str(src / f"{name}.png"),
                    rng.integers(0, 256, hw + (3,), dtype=np.uint8))
    out = tmp_path / "masks"
    r = _run(["-m", "pytorch_camvid_tpu_torch.serve", "-weight", weight,
              "-input", str(src), "-output", str(out), "-b", "2",
              "-color", "-device", "cpu"], cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "served 3 images" in r.stdout
    for name in ("a", "b", "c"):
        m = cv2.imread(str(out / f"{name}_mask.png"), cv2.IMREAD_GRAYSCALE)
        assert m is not None and m.shape == (360, 480) and m.max() < 12
        c = cv2.imread(str(out / f"{name}_color.png"))
        assert c is not None and c.shape == (360, 480, 3)


def test_serve_cli_dp_replicas_write_the_same_masks(tmp_path):
    """``serve -dp 2 -device cpu``: two replicas on the CPU, each batch of
    2 split 1 + 1, write the masks one replica writes."""
    from pytorch_camvid_tpu_torch import serve
    from pytorch_camvid_tpu_torch.models import get_model
    torch.set_num_threads(2)
    model = get_model("unet", 3, 12, width_mult=1 / 16,
                      generator=torch.Generator().manual_seed(0))
    weight = str(tmp_path / "unet.pth")
    torch.save(model.state_dict(), weight)
    src = tmp_path / "imgs"
    src.mkdir()
    rng = np.random.default_rng(4)
    for name in "abc":
        cv2.imwrite(str(src / f"{name}.png"),
                    rng.integers(0, 256, (60, 88, 3), dtype=np.uint8))
    for dp in ("1", "2"):
        assert serve.main(["-weight", weight, "-input", str(src), "-output",
                           str(tmp_path / dp), "-b", "2", "-dp", dp,
                           "-device", "cpu"]) == 0
    for name in "abc":
        one, two = (cv2.imread(str(tmp_path / dp / f"{name}_mask.png"),
                               cv2.IMREAD_GRAYSCALE) for dp in "12")
        np.testing.assert_array_equal(two, one)


def test_port_imports_no_jax(tmp_path):
    code = ("import sys\n"
            "import pytorch_camvid_tpu_torch\n"
            "import pytorch_camvid_tpu_torch.serving\n"
            "import pytorch_camvid_tpu_torch.serve\n"
            "import pytorch_camvid_tpu_torch.interop.weights\n"
            "import pytorch_camvid_tpu_torch.utils.viz\n"
            "import pytorch_camvid_tpu_torch.bench\n"
            "import pytorch_camvid_tpu_torch.benchmark\n"
            "import pytorch_camvid_tpu_torch.batch_sweep\n"
            "import pytorch_camvid_tpu_torch.data.camvid_records\n"
            "import pytorch_camvid_tpu_torch.profile\n"
            "import pytorch_camvid_tpu_torch.perf_probe\n"
            "import pytorch_camvid_tpu_torch.ops.fused_conv_pair\n"
            "import pytorch_camvid_tpu_torch.ops.layout_probes\n"
            "import pytorch_camvid_tpu_torch.mosaic_probes\n"
            "import pytorch_camvid_tpu_torch.data.augment\n"
            "import pytorch_camvid_tpu_torch.data.pipeline\n"
            "import pytorch_camvid_tpu_torch.data.synthetic\n"
            "import pytorch_camvid_tpu_torch.ops.conv_train\n"
            "import pytorch_camvid_tpu_torch.ops.fused_pool\n"
            "import pytorch_camvid_tpu_torch.ops.quant\n"
            "import pytorch_camvid_tpu_torch.ops.fused_conv_int8\n"
            "import pytorch_camvid_tpu_torch.ops.pooling\n"
            "import pytorch_camvid_tpu_torch.models.segnet\n"
            "import pytorch_camvid_tpu_torch.ops.loss\n"
            "import pytorch_camvid_tpu_torch.ops.metrics\n"
            "import pytorch_camvid_tpu_torch.train\n"
            "import pytorch_camvid_tpu_torch.train.__main__\n"
            "import pytorch_camvid_tpu_torch.train.loop\n"
            "import pytorch_camvid_tpu_torch.train.checkpoint\n"
            "import pytorch_camvid_tpu_torch.eval\n"
            "import pytorch_camvid_tpu_torch.predict\n"
            "import pytorch_camvid_tpu_torch.config\n"
            "import pytorch_camvid_tpu_torch.data.camvid\n"
            "import pytorch_camvid_tpu_torch.utils.confusion\n"
            "import pytorch_camvid_tpu_torch.utils.metrics_np\n"
            "import pytorch_camvid_tpu_torch.utils.stats\n"
            "import pytorch_camvid_tpu_torch.utils.tb\n"
            "import pytorch_camvid_tpu_torch.utils.summary\n"
            "import pytorch_camvid_tpu_torch.utils.profiling\n"
            "import pytorch_camvid_tpu_torch.data.native\n"
            "import pytorch_camvid_tpu_torch.data.voc2012\n"
            "import pytorch_camvid_tpu_torch.data.tableborder\n"
            "import pytorch_camvid_tpu_torch.data.segmentation_aug\n"
            "import pytorch_camvid_tpu_torch.data.transforms\n"
            "import pytorch_camvid_tpu_torch.lr_finder\n"
            "import pytorch_camvid_tpu_torch.compute_stats\n"
            "import pytorch_camvid_tpu_torch.train_tpu\n"
            "import pytorch_camvid_tpu_torch.parallel\n"
            "import pytorch_camvid_tpu_torch.parallel.launch\n"
            "import pytorch_camvid_tpu_torch.parallel.mesh\n"
            "import pytorch_camvid_tpu_torch.parallel.multihost\n"
            "import pytorch_camvid_tpu_torch.parallel.data_parallel\n"
            "import pytorch_camvid_tpu_torch.parallel.shard_map_dp\n"
            "import pytorch_camvid_tpu_torch.parallel.spatial\n"
            "import pytorch_camvid_tpu_torch.ops.library\n"
            "import pytorch_camvid_tpu_torch.export_program\n"
            "import pytorch_camvid_tpu_torch.export_torch\n"
            "from pytorch_camvid_tpu_torch.models import get_model\n"
            "get_model('unet', 3, 12, width_mult=1 / 16)\n"
            "get_model('segnet', 3, 12, width_mult=1 / 16)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib',\n"
            "                                            'pytorch_camvid_tpu.')))\n"
            "assert not bad, bad\n"
            "# the card's host has none of these: imported only to build a\n"
            "# cache, strip a palette or draw a plot\n"
            "host = sorted(m for m in sys.modules\n"
            "              if m.split('.')[0] in ('cv2', 'PIL', 'matplotlib'))\n"
            "assert not host, host\n"
            "print('ok')\n")
    r = _run(["-c", code], cwd=str(tmp_path), timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "ok"
