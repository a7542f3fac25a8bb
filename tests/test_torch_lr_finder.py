"""The port's LR finder (``pytorch_camvid_tpu_torch/lr_finder.py``) against
the JAX package's root ``lr_finder.py`` on the CPU, in f32: the same
weights (carried across by ``interop/weights.py``), a 45x60 UNet at width
1/16, the same loader permutations and a draw-free augment (normalize
only), so both sweeps take the same steps. Also the stop rules on a
scripted loss and the CLI's ``main`` on a tiny CamVid cache."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from pytorch_camvid_tpu.data.augment import make_eval_normalize
from pytorch_camvid_tpu.data.pipeline import DeviceDataLoader as JaxLoader
from pytorch_camvid_tpu.train.state import TrainState as JaxTrainState

from pytorch_camvid_tpu_torch import lr_finder as port
from pytorch_camvid_tpu_torch.data import camvid
from pytorch_camvid_tpu_torch.data.normalize import to_tensor_normalize
from pytorch_camvid_tpu_torch.data.pipeline import DeviceDataLoader
from pytorch_camvid_tpu_torch.data.synthetic import synthetic_arrays
from pytorch_camvid_tpu_torch.models import get_model
from pytorch_camvid_tpu_torch.train import schedules
from test_torch_train_step import APPLY, _port, _variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN, STD = (0.4, 0.41, 0.42), (0.3, 0.31, 0.32)
SWEEP = dict(start_lr=1e-7, end_lr=1e-2, num_it=5, stop_div=True,
             weight_decay=0.0)


def _jax_lr_finder():
    """The root lr_finder.py as a module (its CLI is under __main__)."""
    spec = importlib.util.spec_from_file_location(
        "jax_lr_finder", os.path.join(REPO, "lr_finder.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("smoothing", ["reference", "fastai"])
def test_sweep_matches_jax(smoothing):
    """Five iterations over two epochs of a 7-image split at batch 3 (the
    loader's epoch is the iteration count, a reference quirk kept):
    losses within the one-step parity tolerance (f32, summation order
    only), lrs equal."""
    images, labels = synthetic_arrays(7, (45, 60), seed=3)
    v = _variables(seed=4)
    jnorm = make_eval_normalize(MEAN, STD)
    want_loss, want_lr = _jax_lr_finder().lr_finder(
        JaxLoader(images, labels, 3, shuffle=True, drop_last=True),
        APPLY, v, augment_fn=lambda key, x, m: jnorm(x, m),
        smoothing=smoothing, **SWEEP)
    model = _port(JaxTrainState(v["params"], v["state"], {}, 0, None)).model
    got_loss, got_lr = port.lr_finder(
        DeviceDataLoader(images, labels, 3, shuffle=True, drop_last=True,
                         device="cpu"), model,
        augment_fn=lambda g, x, m: (to_tensor_normalize(x, MEAN, STD),
                                    m.long()),
        smoothing=smoothing, **SWEEP)
    assert len(got_loss) == len(want_loss) == 5
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    np.testing.assert_array_equal(got_lr, want_lr)
    sweep = schedules.exponential_sweep_lr(1e-7, 1e-2, 5)
    if smoothing == "reference":   # the lr after each step
        assert got_lr.tolist() == [sweep(i) for i in range(1, 6)]
    else:                          # the lr of each step
        assert got_lr.tolist() == [sweep(i) for i in range(5)]


class _Scripted:
    """A loader and step that feed lr_finder scripted losses."""

    def __init__(self, losses):
        self.losses = list(losses)

    def epoch(self, _e):
        return iter([None] * 3)

    def step(self, _opt, lr_fn, **_kw):
        def fn(state, _batch):
            m = {"loss": torch.tensor(self.losses[state.step]),
                 "lr": lr_fn(state.step)}
            state.step += 1
            return state, m
        return fn


def _run_scripted(monkeypatch, losses, smoothing, num_it):
    s = _Scripted(losses)
    monkeypatch.setattr(port, "make_train_step", s.step)
    model = torch.nn.Linear(1, 1)
    return port.lr_finder(s, model, start_lr=1e-3, end_lr=1.0,
                          num_it=num_it, stop_div=True, weight_decay=0.0,
                          augment_fn=None, smoothing=smoothing)


def test_reference_rule_stops_on_nan_only(monkeypatch):
    losses, lrs = _run_scripted(
        monkeypatch, [2.0, 1.0, 50.0, float("nan"), 1.0], "reference", 5)
    # the first raw, then 0.05 * loss + 0.95 * previous; a 25x jump does
    # not stop it, the NaN does, and is not recorded
    want = [2.0]
    for x in (1.0, 50.0):
        want.append(0.05 * x + 0.95 * want[-1])
    np.testing.assert_allclose(losses, want)
    sweep = schedules.exponential_sweep_lr(1e-3, 1.0, 5)
    assert lrs.tolist() == [sweep(i) for i in (1, 2, 3)]


def test_fastai_rule_stops_past_4x_best(monkeypatch):
    losses, lrs = _run_scripted(
        monkeypatch, [1.0, 1.0, 1.0, 400.0, 1.0], "fastai", 5)
    avg, want = 0.0, []
    for i, x in enumerate([1.0, 1.0, 1.0, 400.0], start=1):
        avg = 0.98 * avg + 0.02 * x
        want.append(avg / (1 - 0.98 ** i))
    np.testing.assert_allclose(losses, want)
    assert want[-1] > 4 * min(want) and len(lrs) == 4
    # no stop: num_it entries
    losses, _ = _run_scripted(monkeypatch, [1.0] * 5, "fastai", 5)
    assert len(losses) == 5


def test_main_sweeps_and_writes_its_plot(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    root = str(tmp_path / "data")
    images, labels = synthetic_arrays(6, (48, 64), seed=1)
    camvid.write_cache(camvid.cache_path(root, "train", (64, 48)), images,
                       labels, [f"t{i}.png" for i in range(6)])
    monkeypatch.chdir(tmp_path)
    # UNet at width 1/16: the CLI's path at a CPU test's cost
    monkeypatch.setattr(port, "get_model", functools.partial(
        get_model, width_mult=1 / 16))
    argv = ["-net", "unet", "-b", "2", "-num_it", "4", "-skip_start", "0",
            "-skip_end", "0", "-data", root, "-image_size", "64", "48",
            "-dtype", "float32", "-device", "cpu"]
    args = port.parser().parse_args(argv)
    assert (args.smoothing, args.stop_div) == ("reference", True)
    loss, lr = port.main(argv)
    assert len(loss) == len(lr) == 4 and np.isfinite(loss).all()
    sweep = schedules.exponential_sweep_lr(1e-7, 10, 4)
    assert lr.tolist() == [sweep(i) for i in range(1, 5)]
    assert (tmp_path / "lr_finder.jpg").stat().st_size > 0
    # the sweep alone is the CLI's: the same model, draws and losses
    again, _ = port.sweep(args)
    np.testing.assert_array_equal(again, loss)


def test_recorded_lr_is_the_next_iterations():
    fn = schedules.exponential_sweep_lr(1e-7, 10, 12)
    assert port.recorded_lr(fn, 1) == fn(1) > fn(0)
    args = port.parser().parse_args(["-net", "unet", "-stop_div", "false"])
    assert args.stop_div is False
    assert (args.device, args.dtype) == ("cuda", "bfloat16")
