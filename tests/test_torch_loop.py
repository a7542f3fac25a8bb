"""The port's training loop (``train/loop.py``) and what it stands on, on
the CPU: the CamVid reader and its cache against the JAX package's, the
eval pass against JAX's ``evaluate``, the OneCycle schedule per reported
step, bit-exact preemption + resume and dispatch chains, the checkpoint
cadence, the guards, the options that are not ported, and the utils
(confusion metrics, numpy metrics, TB fallback, model summary). The loop
runs UNet at width 1/16 (``small_unet``), f32."""

import functools
import json
import os
import signal
from dataclasses import replace

import numpy as np
import jax
import pytest
import torch

from pytorch_camvid_tpu.data import camvid as jcamvid
from pytorch_camvid_tpu.data.augment import make_eval_normalize
from pytorch_camvid_tpu.data.pipeline import DeviceDataLoader as JaxLoader
from pytorch_camvid_tpu.data.synthetic import write_synthetic_camvid
from pytorch_camvid_tpu.models.unet import apply_unet
from pytorch_camvid_tpu.train import loop as jloop, schedules as jsched
from pytorch_camvid_tpu.train.state import TrainState as JaxTrainState
from pytorch_camvid_tpu.train.steps import make_eval_step as jax_eval_step
from pytorch_camvid_tpu.utils import confusion as jconfusion
from pytorch_camvid_tpu.utils import metrics_np as jmetrics_np
from pytorch_camvid_tpu.utils import stats as jstats
from pytorch_camvid_tpu.utils import summary as jsummary

from pytorch_camvid_tpu_torch.config import settings
from pytorch_camvid_tpu_torch.data import camvid
from pytorch_camvid_tpu_torch.data.pipeline import DeviceDataLoader
from pytorch_camvid_tpu_torch.data.synthetic import synthetic_arrays
from pytorch_camvid_tpu_torch.interop.weights import (jax_variables_from_model,
                                                      train_state_from_jax)
from pytorch_camvid_tpu_torch.models import get_model
from pytorch_camvid_tpu_torch.models.unet import UNet, scaled_spec
from pytorch_camvid_tpu_torch.parallel import multihost
from pytorch_camvid_tpu_torch.train import loop, make_eval_step
from pytorch_camvid_tpu_torch.utils import (confusion, metrics_np, stats,
                                            summary, tb)
from pytorch_camvid_tpu_torch.utils.profiling import (StepTimer,
                                                      metrics_report)

WIDTH = 1 / 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny ops: one intra-op thread. Several test workers share the cores,
    and spinning thread pools then stall small ops for seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _DS:
    """A split as the loop takes it (CamVid's surface)."""

    def __init__(self, n, hw=(32, 32), seed=0):
        self.images, self.labels = synthetic_arrays(n, hw, 12, seed)
        self.class_num, self.ignore_index = 12, 11
        self.class_names = [str(i) for i in range(12)]


@pytest.fixture
def small_unet(monkeypatch):
    """The loop builds its UNet at width 1/16."""
    monkeypatch.setattr(loop, "get_model", functools.partial(
        get_model, width_mult=WIDTH))


CFG = loop.TrainConfig(net="unet", batch_size=4, lr=1e-3, epochs=2,
                       quiet=True, device="cpu")


def _assert_same_state(a, b):
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), k
    for key in a.opt_state:
        for n, t in a.opt_state[key].items():
            assert torch.equal(t, b.opt_state[key][n]), (key, n)
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


# ---------------------------------------------------------------- CamVid

@pytest.mark.parametrize("size", [(40, 30), None])
def test_camvid_reader_equals_jax_and_shares_its_cache(tmp_path,
                                                       monkeypatch, size):
    """Both packages build the same arrays and names, and each reads the
    cache the other wrote (the build is disabled for the reader)."""
    for first, second in ((jcamvid, camvid), (camvid, jcamvid)):
        root = str(tmp_path / first.__name__)
        write_synthetic_camvid(root, n_train=4, n_val=3, hw=(36, 52))
        for split in ("train", "val"):
            built = first.CamVid(root, image_set=split, image_size=size)
            with monkeypatch.context() as m:
                m.setattr(second.CamVid, "_build_arrays", None)
                read = second.CamVid(root, image_set=split,
                                     image_size=size)
            np.testing.assert_array_equal(read.images, built.images)
            np.testing.assert_array_equal(read.labels, built.labels)
            assert read.names == built.names
            assert read.images.dtype == np.uint8 == read.labels.dtype
            assert len(read) == (4 if split == "train" else 3)
            assert (read.class_names, read.class_num, read.ignore_index) \
                == (built.class_names, 12, 11)
    # and a fresh build by each equals the other's
    roots = [str(tmp_path / f"fresh{i}") for i in range(2)]
    for r in roots:
        write_synthetic_camvid(r, n_train=4, n_val=3, hw=(36, 52))
    a = jcamvid.CamVid(roots[0], image_set="val", image_size=size)
    b = camvid.CamVid(roots[1], image_set="val", image_size=size)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)


# ------------------------------------------------------------ evaluate

def _jax_variables(spec, seed=0):
    rng = np.random.default_rng(seed)
    params, state = {}, {}
    for stage, pairs in spec:
        params[stage], state[stage] = [], []
        for cin, cout in pairs:
            bound = 1 / np.sqrt(9 * cin)
            params[stage].append({
                "w": rng.uniform(-bound, bound, (3, 3, cin, cout)),
                "b": rng.uniform(-bound, bound, cout),
                "scale": rng.uniform(0.5, 1.5, cout),
                "bias": rng.normal(scale=0.1, size=cout)})
            state[stage].append({"mean": rng.normal(scale=0.1, size=cout),
                                 "var": rng.uniform(0.5, 2.0, cout)})
    return jax.tree.map(lambda a: a.astype(np.float32),
                        {"params": params, "state": state})


def test_evaluate_matches_jax_with_a_ragged_last_batch():
    """13 images at batch 4: JAX pads the last batch with 255 labels, the
    port runs it as it is; same loss sum, confusion matrix and mIoU."""
    v = _jax_variables(scaled_spec(3, 12, WIDTH))
    images, labels = synthetic_arrays(13, (45, 60), seed=3)
    mean, std = settings.MEAN, settings.STD
    apply = functools.partial(apply_unet, use_pallas=False)
    jstate = JaxTrainState(v["params"], v["state"], {}, 0, None)
    want_loss, want_cm, want_n = jloop.evaluate(
        jstate, jax.jit(jax_eval_step(apply, 12, ignore_index=11,
                                      loss_ignore_index=255)),
        JaxLoader(images, labels, 4), make_eval_normalize(mean, std), 4)

    state = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                 UNet(3, 12, width_mult=WIDTH))
    got_loss, got_cm, got_n = loop.evaluate(
        state, make_eval_step(12, ignore_index=11, loss_ignore_index=(255,)),
        DeviceDataLoader(images, labels, 4, device="cpu"),
        loop.eval_normalize(mean, std, torch.float32, torch.device("cpu")))
    assert got_n == want_n == 4
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    # argmax ties may flip a few pixels between the two frameworks
    assert np.abs(got_cm - want_cm).sum() <= 2e-3 * labels.size
    assert got_cm.sum() == want_cm.sum()
    names = [str(i) for i in range(12)]
    want_miou, _ = jloop.print_epoch_metrics(want_cm, names, 11, quiet=True)
    got_miou, _ = loop.print_epoch_metrics(got_cm, names, 11, quiet=True)
    assert abs(got_miou - want_miou) <= 1e-3
    # the port's reductions on JAX's own matrix: the same figures
    assert loop.print_epoch_metrics(want_cm, names, 11, quiet=True) == \
        pytest.approx(jloop.print_epoch_metrics(want_cm, names, 11,
                                                quiet=True), rel=1e-6)


# ---------------------------------------------------------------- loop

class _Recorder:
    """A logger that keeps what the loop logs per step and per epoch."""

    def __init__(self, on_step=None):
        self.steps, self.scalars, self.hists = {}, [], []
        self.on_step = on_step

    def last_layer_grad_norms(self, m, n_iter):
        self.steps[n_iter] = dict(m)
        if self.on_step:
            self.on_step(n_iter)

    def scalar(self, tag, value, step):
        self.scalars.append((tag, step))

    def param_histograms(self, named, epoch):
        self.hists.append((epoch, len(list(named))))


def test_schedule_per_reported_step_matches_jax(small_unet):
    rec = _Recorder()
    state, history = loop.run_training(CFG, _DS(8), _DS(4, seed=1),
                                       logger=rec)
    total = 4   # 2 epochs x 2 steps (drop_last)
    assert state.step == total and sorted(rec.steps) == [1, 2, 3, 4]
    lr, beta1 = jsched.onecycle_lr(CFG.lr, total), jsched.onecycle_beta1(
        total)
    for n_iter, m in rec.steps.items():
        np.testing.assert_allclose(m["lr"], float(lr(n_iter - 1)),
                                   rtol=1e-6)
        np.testing.assert_allclose(m["beta1"], float(beta1(n_iter - 1)),
                                   rtol=1e-6)
        assert np.isfinite(m["loss"]) and m["grad_norm_w"] >= 0
    tags = {t for t, _ in rec.scalars}
    assert tags == {"Train/LearningRate", "Train/Beta1", "Test/mIOU",
                    "Test/Acc", "Test/Loss"}
    assert [e for e, _ in rec.hists] == [1, 2]
    assert [h["epoch"] for h in history] == [1, 2]
    assert all(h["train_s"] > 0 and h["eval_s"] > 0 for h in history)


def test_checkpoint_cadence_matches_jax(small_unet, tmp_path):
    """JAX's tests/test_loop.py cadence: epoch 1 is not past epochs // 2,
    so regular; epoch 2 is best, and the best save skips the regular one
    (train.py:232-240)."""
    ckpt = str(tmp_path / "checkpoints" / "run1")
    state, history = loop.run_training(
        replace(CFG, checkpoint_dir=ckpt, save_epoch=1), _DS(8),
        _DS(4, seed=1))
    assert [h["epoch"] for h in history] == [1, 2] and state.step == 4
    assert history[1]["miou"] > 0
    assert sorted(os.listdir(ckpt)) == ["1-regular.ckpt.npz",
                                        "2-best.ckpt.npz"]


def test_preemption_and_resume_are_bit_exact(small_unet, tmp_path):
    train, val = _DS(12), _DS(4, seed=1)   # 3 steps an epoch
    want, _ = loop.run_training(CFG, train, val)
    ckpt = str(tmp_path / "checkpoints" / "run1")
    mid, _ = loop.run_training(
        replace(CFG, checkpoint_dir=ckpt, stop_after_batches=4), train, val)
    assert mid.step == 4
    assert os.listdir(ckpt) == ["1-preempt.ckpt.npz"]
    meta = json.loads(str(np.load(os.path.join(
        ckpt, "1-preempt.ckpt.npz"))["__payload__"]))["meta"]
    assert meta == {"epoch": 1, "net": "unet", "preempted_in_epoch": 2,
                    "resume_batch_idx": 1}
    got, history = loop.run_training(
        replace(CFG, checkpoint_dir=str(tmp_path / "checkpoints" / "run2"),
                resume=True), train, val)
    assert [h["epoch"] for h in history] == [2]
    _assert_same_state(got, want)


def test_sigterm_mid_epoch_saves_and_resumes_bit_exact(small_unet,
                                                       tmp_path):
    """A real SIGTERM, sent while step 2's metrics are read: the loop
    stops before the next dispatch, saves the preemption point, and the
    handler it replaced is back afterwards."""
    train, val = _DS(16), _DS(4, seed=1)   # 4 steps an epoch
    cfg = replace(CFG, dispatch_chain=1)
    want, _ = loop.run_training(cfg, train, val, logger=_Recorder())
    before = signal.getsignal(signal.SIGTERM)

    def term(n_iter):
        if n_iter == 2:
            assert signal.getsignal(signal.SIGTERM) is not before
            os.kill(os.getpid(), signal.SIGTERM)

    ckpt = str(tmp_path / "checkpoints" / "run1")
    mid, _ = loop.run_training(replace(cfg, checkpoint_dir=ckpt), train,
                               val, logger=_Recorder(term))
    assert signal.getsignal(signal.SIGTERM) is before
    # step 3 was queued before step 2's metrics were read
    assert mid.step == 3 and os.listdir(ckpt) == ["0-preempt.ckpt.npz"]
    got, _ = loop.run_training(replace(cfg, checkpoint_dir=ckpt,
                                       resume=True), train, val)
    _assert_same_state(got, want)


@pytest.mark.parametrize("chain", [1, 8])
def test_dispatch_chain_is_bit_exact_to_one_step(small_unet, chain):
    train, val = _DS(12), _DS(4, seed=1)
    ref, ref_hist = loop.run_training(replace(CFG, dispatch_chain=2),
                                      train, val)
    got, hist = loop.run_training(replace(CFG, dispatch_chain=chain),
                                  train, val)
    _assert_same_state(got, ref)
    assert [(h["miou"], h["all_acc"]) for h in hist] == \
        [(h["miou"], h["all_acc"]) for h in ref_hist]


def test_nan_guard_raises_and_restores_the_handler(small_unet):
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(FloatingPointError):
        loop.run_training(replace(CFG, lr=1e20, dispatch_chain=1),
                          _DS(8), _DS(4, seed=1))
    assert signal.getsignal(signal.SIGTERM) is before


def test_batch_larger_than_the_split_raises(small_unet):
    with pytest.raises(ValueError, match="exceeds the train split"):
        loop.run_training(replace(CFG, batch_size=16), _DS(8), _DS(4))


# ROADMAP.md Queue 1 items that are done: their options run
PORTED_ITEMS = {"the rest of augmentation and the pipeline",
                "f32 on the card", "remat", "multi-GPU"}


@pytest.mark.parametrize("change,item", [
    ({"data_parallel": 2}, "multi-GPU"),
    ({"loader": "host"}, "the rest of augmentation and the pipeline"),
    ({"remat": True}, "remat"),
    ({"device": "cuda", "compute_dtype": "float32"}, "f32 on the card")])
def test_unported_options_name_their_roadmap_item(small_unet, change, item,
                                                  tmp_path):
    """An option of a Queue 1 item raises, naming it, until the item is
    ported; then it runs: ``loader='host'`` and ``remat`` each train a
    tiny CPU epoch (with its eval pass) bit-equal to the run without the
    option; float32 on a CUDA device is taken, so without a card the run
    stops at the device check; ``data_parallel=2`` needs two ranks (without
    a process group it raises, naming the launchers), and in a process
    group of one rank, where every collective of the data-parallel path
    runs, the epoch is bit-equal to the run without one
    (``test_torch_multihost.py`` trains on two ranks)."""
    if item not in PORTED_ITEMS:
        with pytest.raises(NotImplementedError, match=f"Queue 1: {item}"):
            loop.run_training(replace(CFG, **change), _DS(4), _DS(4))
        return
    if item == "multi-GPU":
        with pytest.raises(ValueError, match="needs 2 ranks.*-dp 2"):
            loop.run_training(replace(CFG, **change), _DS(4), _DS(4))
        cfg = replace(CFG, epochs=1)
        want, want_hist = loop.run_training(cfg, _DS(12), _DS(5, seed=1))
        multihost.init_distributed(f"file://{tmp_path}/rendezvous", 1, 0,
                                   "cpu")
        try:
            got, hist = loop.run_training(replace(cfg, data_parallel=1),
                                          _DS(12), _DS(5, seed=1))
        finally:
            multihost.shutdown()
        _assert_same_state(got, want)
        assert [(h["miou"], h["all_acc"]) for h in hist] == \
            [(h["miou"], h["all_acc"]) for h in want_hist]
        return
    if item == "f32 on the card":
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loop.run_training(replace(CFG, **change), _DS(4), _DS(4))
        return
    cfg = replace(CFG, epochs=1, **change)
    got, hist = loop.run_training(cfg, _DS(12), _DS(5, seed=1))
    want, want_hist = loop.run_training(
        replace(cfg, **{k: getattr(CFG, k) for k in change}), _DS(12),
        _DS(5, seed=1))
    _assert_same_state(got, want)
    assert [(h["miou"], h["all_acc"]) for h in hist] == \
        [(h["miou"], h["all_acc"]) for h in want_hist]


def test_device_rule():
    assert loop.check_device("cpu", "float32") == torch.device("cpu")
    assert loop.check_device("cpu", "bfloat16") == torch.device("cpu")
    if not torch.cuda.is_available():
        for dtype in ("float32", "bfloat16"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                loop.check_device("cuda", dtype)
    with pytest.raises(ValueError):
        loop.check_device("cpu", "float16")


# --------------------------------------------------------------- utils

def test_confusion_metrics_match_jax():
    rng = np.random.default_rng(0)
    got, want = confusion.Metrics(12, 11), jconfusion.Metrics(12, 11)
    for _ in range(3):
        p = rng.integers(0, 12, (2, 9, 7))
        g = rng.integers(0, 12, (2, 9, 7))
        got.add(p, g)
        want.add(p, g)
    np.testing.assert_array_equal(got.matrix, want.matrix)
    for name in ("precision", "recall", "iou"):
        assert getattr(got, name)() == pytest.approx(getattr(want, name)(),
                                                     rel=1e-6)
        np.testing.assert_allclose(getattr(got, name)(average=False),
                                   getattr(want, name)(average=False),
                                   rtol=1e-6)
    got.clear()
    assert got.matrix.sum() == 0


def test_numpy_metrics_and_stats_equal_jax():
    rng = np.random.default_rng(1)
    res = [rng.integers(0, 12, (8, 8)) for _ in range(3)]
    gts = [rng.integers(0, 13, (8, 8)) for _ in range(3)]
    for a, b in zip(metrics_np.mean_iou(res, gts, 12, 11, nan_to_num=0.0),
                    jmetrics_np.mean_iou(res, gts, 12, 11, nan_to_num=0.0)):
        np.testing.assert_array_equal(a, b)
    images = rng.integers(0, 256, (3, 5, 6, 3), dtype=np.uint8)
    assert stats.compute_mean_and_std(images) == \
        jstats.compute_mean_and_std(images)


def test_summary_equals_jax():
    model = UNet(3, 12, width_mult=WIDTH)
    v = jax_variables_from_model(model)
    assert summary.count_params(model) == jsummary.count_params(v["params"])
    assert summary.summarize_model(model, "unet") == \
        jsummary.summarize_model(v, "unet")


def test_tb_logger_falls_back_to_jsonl(tmp_path, monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard",
                        None)
    logger = tb.SummaryLogger(str(tmp_path))
    logger.scalar("Test/mIOU", torch.tensor(0.5), 3)
    logger.last_layer_grad_norms({"grad_norm_w": 1.5, "grad_norm_b": 2.0},
                                 7)
    logger.param_histograms(UNet(3, 12, width_mult=WIDTH).named_parameters(),
                            1)
    logger.close()
    rows = [json.loads(line) for line in
            open(tmp_path / "events.jsonl").read().splitlines()]
    assert [(r["tag"], r["value"], r["step"]) for r in rows] == [
        ("Test/mIOU", 0.5, 3),
        ("LastLayerGradients/grad_norm2_weights", 1.5, 7),
        ("LastLayerGradients/grad_norm2_bias", 2.0, 7)]


def test_step_timer_and_report():
    t = StepTimer()
    for _ in range(3):
        with t.span(lambda: torch.zeros(1)):
            pass
    s = t.summary()
    assert s["steps"] == 3 and s["p95_ms"] >= s["p50_ms"] >= 0
    if not torch.cuda.is_available():
        assert metrics_report() == ""
