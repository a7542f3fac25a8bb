"""The port's layout probes (``pytorch_camvid_tpu_torch/mosaic_probes.py``
on ``ops/layout_probes.py``) against the JAX tool they port
(``tools/mosaic_probes.py``, loaded by path and not edited), on the CPU. The
tool runs its Pallas kernels in interpret mode; each kernel's inputs and
output are recorded around ``pl.pallas_call`` and the tool's own
``np.testing.assert_allclose`` checks."""

import ast
import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pytorch_camvid_tpu_torch import mosaic_probes
from pytorch_camvid_tpu_torch.ops import layout_probes as lp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = [key for key, _, _ in mosaic_probes.PROBES]


@pytest.fixture(scope="module")
def jax_run():
    """One run of the JAX tool with ``--interpret``: (its printed lines,
    the inputs of each pallas_call, (actual, desired) of each check)."""
    from jax.experimental import pallas as pl
    spec = importlib.util.spec_from_file_location(
        "jax_mosaic_probes", os.path.join(REPO, "tools", "mosaic_probes.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    calls, checks = [], []
    real_call, real_close = pl.pallas_call, np.testing.assert_allclose

    def recording_call(*args, **kwargs):
        kernel = real_call(*args, **kwargs)

        def run(*xs):
            calls.append([np.asarray(x) for x in xs])
            return kernel(*xs)
        return run

    def recording_close(actual, desired, *args, **kwargs):
        checks.append((np.array(actual), np.array(desired)))
        return real_close(actual, desired, *args, **kwargs)

    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(pl, "pallas_call", recording_call)
        mp.setattr(np.testing, "assert_allclose", recording_close)
        mp.setattr(sys, "argv", ["mosaic_probes.py", "--interpret"])
        tool.main()
    return buf.getvalue().splitlines(), calls, checks


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.int16 if a.itemsize == 2
                                        else np.int32)


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.element_size() == 2
                  else torch.int32).numpy()


def test_jax_tool_passes_every_probe(jax_run):
    lines, calls, checks = jax_run
    assert [ln.split(":")[1].strip() for ln in lines[:7]] == ["OK"] * 7
    assert len(calls) == 7 and len(checks) == 7


def test_port_labels_and_keys_are_the_tools(jax_run):
    lines, _, _ = jax_run
    assert [ln.split(":")[0] for ln in lines[:7]] == [
        label for _, label, _ in mosaic_probes.PROBES]
    assert list(ast.literal_eval(lines[7])) == KEYS


def test_inputs_bit_equal_to_the_tools(jax_run):
    _, calls, _ = jax_run
    t = mosaic_probes.inputs("cpu")
    want = [["x32"], ["x16"], ["s", "x32"], ["x32", "w"], ["x32"], ["x16"],
            ["xp"]]
    for names, args in zip(want, calls):
        assert len(names) == len(args)
        for name, arg in zip(names, args):
            assert tuple(t[name].shape) == arg.shape
            np.testing.assert_array_equal(_torch_bits(t[name]), _bits(arg))


@pytest.mark.parametrize("i", range(7), ids=KEYS)
def test_probe_output_matches_jax_interpret_kernel(jax_run, i):
    _, _, checks = jax_run
    pallas_out = checks[i][0]
    got = mosaic_probes.probes(mosaic_probes.inputs("cpu"))[KEYS[i]]()
    got = got.float().numpy()
    assert got.shape == pallas_out.shape
    if KEYS[i] == "B_unaligned_slice_to_mxu":
        err = np.abs(got - pallas_out).max() / np.abs(pallas_out).max()
        assert err <= 1e-5
    else:
        np.testing.assert_array_equal(_bits(got), _bits(pallas_out))


def test_cpu_run_counts_no_launch():
    before = lp.launches()
    records = []
    assert mosaic_probes.run("cpu", records) == dict.fromkeys(KEYS, True)
    assert lp.launches() == before
    assert [r["key"] for r in records] == KEYS
    assert all(r["launches"] == 0 and r["ms"] is None for r in records)
    assert mosaic_probes.calls_per_probe("cpu") == 1


@pytest.mark.parametrize("runs,traces,ok", [
    (1, 1, True), (1, 3, True), (2, 2, True), (2, 6, True), (1, 4, False),
    (2, 7, False)])
def test_chip_smoke_probe_launch_rule_counts_retried_traces(runs, traces,
                                                            ok):
    """chip_smoke's launch check of phase 11: each run launches once for
    the checked call and each warm-up call, and ITERS times for each
    profiler trace the timing took (one to TRACE_TRIES a run, as
    ``perf_probe.time_op`` takes a trace again when it holds no device
    records); one launch more or less is never right."""
    import chip_smoke
    from pytorch_camvid_tpu_torch import perf_probe
    n = runs * (1 + perf_probe.WARMUP) + traces * mosaic_probes.ITERS
    assert chip_smoke.probe_launches_ok(n, runs) is ok
    assert not chip_smoke.probe_launches_ok(n + 1, runs)
    assert not chip_smoke.probe_launches_ok(n - 1, runs)


# ---------------------------------------- plain versions against numpy

RNG = np.random.default_rng(5)
X = RNG.normal(size=(300, 200)).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("start,n", [(0, 300), (5, 150), (9, 291),
                                     (131, 1)])
def test_row_slice_on_cpu(dtype, start, n):
    x = torch.from_numpy(X).to(dtype)
    got = lp.row_slice(x, start, n)
    np.testing.assert_array_equal(_torch_bits(got),
                                  _torch_bits(x)[start:start + n])


@pytest.mark.parametrize("s", [-4, 0, 3, 131, 200, 1000])
def test_row_slice_dynamic_clamps_like_dynamic_slice(s):
    x = torch.from_numpy(X)
    got = lp.row_slice_dynamic(x, torch.tensor([s], dtype=torch.int32), 100)
    first = min(max(s, 0), 200)
    np.testing.assert_array_equal(got.numpy(), X[first:first + 100])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 1, -3, 77, 300, 301])
def test_roll_rows_on_cpu(dtype, shift):
    x = torch.from_numpy(X).to(dtype)
    np.testing.assert_array_equal(
        _torch_bits(lp.roll_rows(x, shift)),
        np.roll(_torch_bits(x), shift, 0))


@pytest.mark.parametrize("rows,k,m,start,n", [(64, 256, 128, 1, 32),
                                              (100, 132, 68, 7, 70),
                                              (9, 4, 4, 8, 1),
                                              (50, 64, 12, 3, 45),
                                              (40, 300, 20, 0, 33)])
def test_row_slice_matmul_on_cpu(rows, k, m, start, n):
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(rows, k)).astype(np.float32)
    w = rng.normal(size=(k, m)).astype(np.float32)
    got = lp.row_slice_matmul(torch.from_numpy(x), torch.from_numpy(w),
                              start, n).numpy()
    want = x[start:start + n].astype(np.float64) @ w
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("h,wp,c,w", [(16, 48, 128, 40), (45, 203, 64, 201),
                                      (3, 7, 4, 5), (2, 10, 12, 3)])
def test_sum_width_shifts_on_cpu(h, wp, c, w):
    xp = np.random.default_rng(h).normal(size=(h, wp, c)).astype(np.float32)
    got = lp.sum_width_shifts(torch.from_numpy(xp), w).numpy()
    want = xp[:, 0:w] + xp[:, 1:w + 1] + xp[:, 2:w + 2]
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ------------------------------------------------ what the wrappers take

def _calls(device, dtype=torch.float32, c=128):
    x = torch.zeros(64, 256, dtype=dtype, device=device)
    w = torch.zeros(256, 128, dtype=dtype, device=device)
    xp = torch.zeros(16, 48, c, dtype=dtype, device=device)
    s = torch.zeros(1, dtype=torch.int32, device=device)
    return {"row_slice": lambda: lp.row_slice(x, 1, 32),
            "row_slice_dynamic": lambda: lp.row_slice_dynamic(x, s, 32),
            "row_slice_matmul": lambda: lp.row_slice_matmul(x, w, 1),
            "roll_rows": lambda: lp.roll_rows(x, 1),
            "sum_width_shifts": lambda: lp.sum_width_shifts(xp, 40)}


WRAPPERS = list(_calls("cpu"))


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_raises_on_meta(name):
    with pytest.raises(ValueError, match="no kernel for meta"):
        _calls("meta")[name]()


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_raises_on_a_wrong_dtype(name):
    with pytest.raises(TypeError):
        _calls("cpu", torch.float64)[name]()


@pytest.mark.parametrize("c", [3, 6, 130])
def test_sum_width_shifts_raises_on_misaligned_c(c):
    with pytest.raises(ValueError, match="multiple of 4"):
        _calls("cpu", c=c)["sum_width_shifts"]()


@pytest.mark.parametrize("call", [
    lambda x: lp.row_slice(x, 40, 32),                 # past the end
    lambda x: lp.row_slice(x, -1, 32),
    lambda x: lp.row_slice(x[:, :3], 0, 8),            # 12-byte rows
    lambda x: lp.row_slice_matmul(x, torch.zeros(255, 8), 1),
    lambda x: lp.row_slice_dynamic(x, torch.zeros(1, dtype=torch.int64), 8),
    lambda x: lp.roll_rows(x[None], 1),
])
def test_wrappers_raise_on_what_the_kernels_do_not_take(call):
    with pytest.raises((ValueError, TypeError)):
        call(torch.zeros(64, 256))


# ------------------------------------------------------------------ CLI

def _cli(args, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "pytorch_camvid_tpu_torch.mosaic_probes",
         *args], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=timeout)


# ------------------------------------------------- rows_kernel's grid

# (rows, cols, dtype, n, mode): the tool's M1, M2, M3 and M5, then the
# ragged 300 x 200 calls of chip_smoke's probe checks
ROWS_CALLS = [(64, 256, torch.float32, 32, "static"),
              (64, 256, torch.bfloat16, 32, "static"),
              (64, 256, torch.float32, 32, "dynamic"),
              (64, 256, torch.float32, 64, "roll"),
              (64, 256, torch.bfloat16, 64, "roll"),
              (300, 200, torch.float32, 150, "static"),
              (300, 200, torch.bfloat16, 291, "static"),
              (300, 200, torch.bfloat16, 300, "roll"),
              (300, 200, torch.float32, 100, "dynamic")]


@pytest.mark.parametrize("rows,cols,dtype,n,mode", ROWS_CALLS,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_rows_grid_covers_every_output_row_once(rows, cols, dtype, n, mode):
    """rows_kernel's grid (``rows_grid``, the rule ``layout_rows`` holds):
    its blocks of 8 rows x 256 bytes cover every output row and byte
    exactly once, at the tool's shapes and the ragged ones."""
    plan = lp.rows_grid(rows, cols, dtype, n, mode)
    gx, gy = plan["grid"]
    assert (len(plan["rows"]), len(plan["bytes"])) == (gx, gy)
    row_bytes = cols * torch.empty((), dtype=dtype).element_size()
    for spans, size, step in ((plan["rows"], n, lp.ROWS_PER_BLOCK),
                              (plan["bytes"], row_bytes,
                               lp.ROW_TILE_BYTES)):
        hits = np.zeros(size, dtype=int)
        for first, last in spans:
            assert 0 < last - first <= step
            hits[first:last] += 1
        assert (hits == 1).all()
    if (rows, cols) == (64, 256):
        # the tool's shape spreads over the card: M1 on 16 blocks, where
        # one block per 64 rows x 512 bytes gave 2
        assert gx * gy >= 8
        if dtype == torch.float32 and mode == "static":
            assert gx * gy == 16


def test_rows_grid_is_the_sources():
    """The block of rows_grid is the one csrc/layout_probes.cu's
    rows_kernel takes (RB rows x CT bytes, one 16-byte chunk a thread);
    a roll is of every row."""
    src = lp.SOURCE.read_text()
    rb = int(re.search(r"constexpr int RB = (\d+);", src).group(1))
    ct = int(re.search(r"constexpr int CT = (\d+);", src).group(1))
    assert (rb, ct) == (lp.ROWS_PER_BLOCK, lp.ROW_TILE_BYTES)
    assert "const int r0 = blockIdx.x * RB;" in src
    assert "const int c0 = blockIdx.y * CT;" in src
    with pytest.raises(ValueError, match="roll"):
        lp.rows_grid(64, 256, torch.float32, 32, "roll")


def test_cli_on_cpu():
    r = _cli(["--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert lines[:7] == [f"{label}: OK"
                         for _, label, _ in mosaic_probes.PROBES]
    assert json.loads(lines[7]) == dict.fromkeys(KEYS, True)
    assert len(lines) == 8


def test_cli_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    r = _cli([])
    assert r.returncode == 1
    assert "no CUDA device" in r.stderr and not r.stdout.strip()


def test_a_failing_probe_fails_the_run(monkeypatch, capsys):
    monkeypatch.setattr(lp, "roll_rows",
                        lambda x, shift: torch.roll(x, shift + 1, 0))
    assert mosaic_probes.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert [ln.endswith(": OK") for ln in out[:7]] == [True] * 4 + [
        False] * 2 + [True]
    assert out[4].startswith("C  pltpu.roll sublane (f32): FAIL (")
    results = json.loads(out[7])
    assert [k for k, ok in results.items() if not ok] == KEYS[4:6]
