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
