"""The port's export CLIs and program dump against the JAX package, on the
CPU: ``python -m pytorch_camvid_tpu_torch.export_program`` on a JAX
checkpoint (full-width SegNet at batch 1, at 64x32 and at 32x24, the
size tests/test_export_stablehlo.py runs the JAX tool at),
``export_torch`` against JAX's ``state_dict_from_variables``, ``utils/summary.py::dump_program``
(the ops it names, a train step after a dump bit-equal to one without) and
the loop writing ``program_{net}.txt`` into its run directory."""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pytorch_camvid_tpu.interop import state_dict_from_variables
from pytorch_camvid_tpu.train import TrainState as JaxTrainState
from pytorch_camvid_tpu.train import adamw as jax_adamw
from pytorch_camvid_tpu.train.checkpoint import (
    save_checkpoint as jax_save_checkpoint)

from pytorch_camvid_tpu_torch import export_program, export_torch
from pytorch_camvid_tpu_torch.data.synthetic import synthetic_arrays
from pytorch_camvid_tpu_torch.models import get_model, spec_from_state_dict
from pytorch_camvid_tpu_torch.models.segnet import segnet_spec
from pytorch_camvid_tpu_torch.train import (TrainState, adamw, loop,
                                            make_train_step, schedules)
from pytorch_camvid_tpu_torch.train.checkpoint import save_checkpoint
from pytorch_camvid_tpu_torch.utils.summary import dump_program

import test_torch_segnet

WIDTH = 1 / 16
TRAIN_HW = (36, 44)
# the train-mode forward's op nodes: K1's forward per block (K4's op),
# SegNet's K2 pool and unpool per stage
TRAIN_NODES = {"unet": {"conv3x3_bn_relu": 23},
               "segnet": {"conv3x3_bn_relu": 26, "max_pool_2x2_phase": 5,
                          "max_unpool_2x2_phase": 5}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny ops: one intra-op thread (several test workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_segnet(tmp_path_factory):
    """A JAX ``.ckpt.npz`` of full-width SegNet (its variables drawn with
    numpy: JAX's eager init takes ~20 s here) and its JAX state."""
    v = test_torch_segnet._variables(seed=1, spec=segnet_spec(3, 12))
    state = JaxTrainState.create(jax.tree.map(jnp.asarray, v), jax_adamw())
    path = str(tmp_path_factory.mktemp("jax") / "1-regular.ckpt.npz")
    jax_save_checkpoint(path, state, {"epoch": 1, "miou": 0.25})
    return path, state


def test_export_program_cli_on_a_jax_checkpoint(jax_segnet, tmp_path,
                                                capsys):
    ckpt, _ = jax_segnet
    out = str(tmp_path / "segnet.pt2")
    export_program.main(["-weight", ckpt, "-net", "segnet", "-b", "1",
                         "-image_size", "64", "32", "-device", "cpu",
                         "-out", out])
    line = capsys.readouterr().out
    assert line.startswith(f"wrote {out} (")
    assert "signature uint8[1,32,64,3] -> uint8[1,32,64]" in line
    assert "roundtrip verified" in line and "(100.00% pixel" in line
    assert os.path.getsize(out) > 1e6   # the weights are in it


def test_export_program_cli_at_the_jax_tools_size(jax_segnet, tmp_path,
                                                  capsys):
    """``-image_size 32 24``, the size tests/test_export_stablehlo.py
    exports JAX's SegNet at: its fifth pool's output is empty (24 rows ->
    12, 6, 3, 1, 0), and the program traces and round-trips all the
    same."""
    ckpt, _ = jax_segnet
    out = str(tmp_path / "segnet.pt2")
    export_program.main(["-weight", ckpt, "-net", "segnet", "-b", "1",
                         "-image_size", "32", "24", "-device", "cpu",
                         "-out", out])
    line = capsys.readouterr().out
    assert "signature uint8[1,24,32,3] -> uint8[1,24,32]" in line
    assert "roundtrip verified" in line and "(100.00% pixel" in line


def test_export_program_cli_without_a_card_fails(jax_segnet, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_program.main(["-weight", jax_segnet[0], "-net", "segnet",
                             "-out", str(tmp_path / "x.pt2")])


@pytest.mark.parametrize("source", ["jax_ckpt", "port_ckpt", "pth"])
def test_export_torch_cli(source, jax_segnet, tmp_path, capsys):
    """The .pth holds the reference-named state_dict of the checkpoint:
    JAX's ``state_dict_from_variables`` of a JAX checkpoint, the model's
    own state_dict of a port checkpoint or a .pth; it loads strictly into
    the port's model."""
    if source == "jax_ckpt":
        ckpt, state = jax_segnet
        want = {k: torch.from_numpy(np.array(v)) for k, v in
                state_dict_from_variables("segnet", state.variables())
                .items()}
        net, classes, epoch = "segnet", 12, "epoch 1, miou 0.25"
    else:
        model = get_model("unet", 3, 12, width_mult=WIDTH,
                          generator=torch.Generator().manual_seed(0))
        want = model.state_dict()
        net, classes, epoch = "unet", 12, "epoch ?, miou ?"
        if source == "port_ckpt":
            ckpt = str(tmp_path / "3-best.ckpt.npz")
            save_checkpoint(ckpt, TrainState.create(model, adamw()),
                            {"epoch": 3, "miou": 0.5})
            epoch = "epoch 3, miou 0.5"
        else:
            ckpt = str(tmp_path / "w.pth")
            torch.save(want, ckpt)
    out = str(tmp_path / "out.pth")
    export_torch.main(["-weight", ckpt, "-net", net, "-out", out,
                       "-num_classes", str(classes)])
    line = capsys.readouterr().out
    assert line.startswith(f"wrote {out} ({len(want)} tensors, {epoch})")
    got = torch.load(out, weights_only=True)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    get_model(net, spec=spec_from_state_dict(net, got)).load_state_dict(
        got, strict=True)
    with pytest.raises(SystemExit, match="11"):
        export_torch.main(["-weight", ckpt, "-net", net, "-out", out,
                           "-num_classes", "11"])


def _batch(seed=1):
    images, labels = synthetic_arrays(2, TRAIN_HW, seed=seed)
    x = ((images.astype(np.float32) / 255.0 - 0.4) / 0.3).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(labels.astype(np.int64))


def _step(model, batch):
    state = TrainState.create(model, adamw(), seed=1)
    state, met = make_train_step(adamw(), schedules.constant_lr(1e-3))(
        state, batch)
    return float(met["loss"]), model.state_dict()


@pytest.mark.parametrize("net", ["unet", "segnet"])
def test_dump_program_names_the_ops_and_moves_nothing(net, tmp_path):
    """The dump of a train-mode forward names K1's forward op per block
    (and K2's per SegNet stage), holds no library conv, leaves every
    parameter, BN stat and count as it was, and a train step after it is
    bit-equal to the same step without it."""
    make = functools.partial(get_model, net, 3, 12, width_mult=WIDTH)
    model = make(generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    path = dump_program(model, (torch.zeros((2,) + TRAIN_HW + (3,)),),
                        str(tmp_path / f"program_{net}.txt"))
    text = open(path).read()
    for op, n in TRAIN_NODES[net].items():
        assert text.count(f"torch.ops.camvid.{op}.default(") == n, op
    assert "aten.convolution" not in text and "aten.conv2d" not in text
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    batch = _batch()
    loss, after = _step(model, batch)
    ref_loss, ref = _step(make(generator=torch.Generator().manual_seed(0)),
                          batch)
    assert loss == ref_loss
    for k, v in ref.items():
        assert torch.equal(after[k], v), k


class _DS:
    def __init__(self, n, hw=(32, 32), seed=0):
        self.images, self.labels = synthetic_arrays(n, hw, 12, seed)
        self.class_num, self.ignore_index = 12, 11
        self.class_names = [str(i) for i in range(12)]


class _Logger:
    def last_layer_grad_norms(self, m, n_iter):
        pass

    def scalar(self, tag, value, step):
        pass

    def param_histograms(self, named, epoch):
        pass


def test_loop_writes_the_program(tmp_path, monkeypatch):
    monkeypatch.setattr(loop, "get_model", functools.partial(
        get_model, width_mult=WIDTH))
    cfg = loop.TrainConfig(net="unet", batch_size=4, epochs=1, quiet=True,
                           device="cpu", log_dir=str(tmp_path))
    state, history = loop.run_training(cfg, _DS(4), _DS(4, seed=1),
                                       logger=_Logger())
    assert state.step == 1 and len(history) == 1
    text = open(tmp_path / "program_unet.txt").read()
    assert text.count("torch.ops.camvid.conv3x3_bn_relu.default(") == 23
    # the program is of the rank's batch at the data's size, in f32
    assert 'f32[4, 32, 32, 3]' in text
