"""The planted faults of chip_faults.py that patch a launch function
(``conv_train._wgrad_launch``, ``layout_probes._launch``), on the CPU: each
changes what it should of the launch it wraps, and nothing else. Whether
chip_smoke's checks catch them is shown on the card (``python3
chip_faults.py``)."""

import math

import pytest
import torch

import chip_faults
from pytorch_camvid_tpu_torch.ops import layout_probes as lp

MODES = lp.ROWS_MODES


@pytest.fixture
def launches(monkeypatch):
    """The args of each probe launch the faults pass on."""
    seen = []
    monkeypatch.setattr(chip_faults, "_probe_launch",
                        lambda op, *args: seen.append((op, args)))
    return seen


def _rows_args(mode, v, n=150, s_dev=None):
    x = torch.zeros(300, 200)
    return (x, torch.zeros(n, 200), s_dev, MODES[mode], 1, 300, 200, n, v)


@pytest.mark.parametrize("mode,v,want", [("static", 5, 4), ("static", 0, 0),
                                         ("roll", 77, 78), ("roll", 299, 0)])
def test_rows_one_row_early_moves_the_start(launches, mode, v, want):
    n = 300 if mode == "roll" else 150
    chip_faults.rows_one_row_early("rows", *_rows_args(mode, v, n))
    (op, args), = launches
    assert op == "rows" and args[8] == want and args[7] == n


def test_rows_one_row_early_moves_the_device_start(launches):
    s = torch.tensor([131], dtype=torch.int32)
    chip_faults.rows_one_row_early("rows", *_rows_args("dynamic", 0,
                                                       s_dev=s))
    (_, args), = launches
    assert args[2].item() == 130 and s.item() == 131   # a copy
    chip_faults.rows_one_row_early("slice_matmul", 1, 2, 3)
    assert launches[-1] == ("slice_matmul", (1, 2, 3))


@pytest.mark.parametrize("n,keep", [(150, 144), (32, 24), (291, 288),
                                    (8, 0)])
def test_rows_last_block_dropped_cuts_n(launches, n, keep):
    args = _rows_args("static", 5, n)
    chip_faults.rows_last_block_dropped("rows", *args)
    out = args[1]
    assert torch.isnan(out[keep:]).all() and not torch.isnan(out[:keep]).any()
    if keep:
        (_, got), = launches
        assert got[7] == keep and got[1] is out
    else:
        assert launches == []
    chip_faults.rows_last_block_dropped("rows", *_rows_args("roll", 1, 300))
    assert launches[-1][1][7] == 300


def test_packed_dw_faults_transpose_taps_and_swap_stem_channels(
        monkeypatch):
    dw = torch.arange(3 * 3 * 3 * 4, dtype=torch.float32).view(3, 3, 3, 4)
    monkeypatch.setattr(chip_faults, "_wgrad_launch",
                        lambda x, g, path: dw.clone())
    x3, x8 = torch.zeros(1, 2, 2, 3), torch.zeros(1, 2, 2, 8)
    got = chip_faults.packed_dw_taps_transposed(x3, None, "packed")
    assert torch.equal(got, dw.transpose(0, 1))
    assert torch.equal(
        chip_faults.packed_dw_taps_transposed(x3, None, "wgmma"), dw)
    got = chip_faults.stem_dw_bgr(x3, None, "packed")
    assert torch.equal(got[:, :, 0], dw[:, :, 2])
    assert torch.equal(got[:, :, 1], dw[:, :, 1])
    assert torch.equal(chip_faults.stem_dw_bgr(x8, None, "packed"), dw)
    assert not math.isnan(got.sum().item())


def test_training_run_faults_change_what_they_name(tmp_path):
    """Phase 12's faults on the CPU: the resume faults move the restart
    point or keep the fresh generator, the loader fault drops only a short
    last batch, and the eval-step fault runs the model in train mode (its
    BN running stats move) and leaves the model's own eval() in place."""
    import numpy as np
    from pytorch_camvid_tpu_torch.models.unet import UNet
    from pytorch_camvid_tpu_torch.train import TrainState, adamw
    from pytorch_camvid_tpu_torch.train.checkpoint import save_checkpoint

    model = UNet(3, 12, width_mult=1 / 16,
                 generator=torch.Generator().manual_seed(0))
    saved = TrainState.create(model, adamw(), seed=1)
    torch.rand(5, generator=saved.generator)   # the generator moves on
    path = str(tmp_path / "1-preempt.ckpt.npz")
    save_checkpoint(path, saved, {"epoch": 1, "resume_batch_idx": 2})
    fresh = TrainState.create(UNet(3, 12, width_mult=1 / 16), adamw(),
                              seed=1)
    start = fresh.generator.get_state()
    _, meta = chip_faults.resume_one_batch_late(path, fresh)
    assert meta["resume_batch_idx"] == 3
    assert torch.equal(fresh.generator.get_state(),
                       saved.generator.get_state())
    fresh = TrainState.create(UNet(3, 12, width_mult=1 / 16), adamw(),
                              seed=1)
    _, meta = chip_faults.resume_without_generator(path, fresh)
    assert meta["resume_batch_idx"] == 2
    assert torch.equal(fresh.generator.get_state(), start)

    loader = chip_faults.DeviceDataLoader(
        np.zeros((13, 4, 4, 3), np.uint8), np.zeros((13, 4, 4), np.uint8),
        5, device="cpu")
    sizes = [len(i) for i, _ in chip_faults.epoch_without_ragged_batch(
        loader, 0)]
    assert sizes == [5, 5] and [len(i) for i, _ in loader.epoch(0)] == [
        5, 5, 3]

    step = chip_faults.eval_step_in_train_mode(12)
    stats = [b.clone() for b in model.buffers()]
    x = torch.randn(2, 16, 16, 3)
    step(saved, (x, torch.zeros(2, 16, 16, dtype=torch.long)))
    assert model.training and "eval" not in model.__dict__
    assert any(not torch.equal(a, b) for a, b in zip(stats,
                                                    model.buffers()))
