"""The port's per-shape probe (pytorch_camvid_tpu_torch/perf_probe.py)
against the JAX tool it ports (tools/perf_probe.py, imported by path and
not edited): the same shape tables and roofline, rows with the JAX tool's
keys, and the CLI, all on the CPU."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pytorch_camvid_tpu_torch import bench, perf_probe, profile
from pytorch_camvid_tpu_torch.ops import fused_conv, fused_conv_pair, \
    fused_pool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE_KEYS = {"shape", "ms", "ms_gross", "ms_chain_tax", "tflops",
              "roofline_tflops", "pct_of_roofline", "impl", "mode", "k"}
POOL_KEYS = {"stage", "impl", "shape", "pool_unpool_ms", "bw_bound_ms",
             "pct_of_bw_bound"}


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_perf_probe", os.path.join(REPO, "tools", "perf_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("hw", [(360, 480), (90, 124), (45, 61)])
@pytest.mark.parametrize("net", ["unet", "segnet"])
def test_conv_shapes_match_jax_tool(jax_tool, net, hw):
    name = f"{net}_conv_shapes"
    assert getattr(perf_probe, name)(hw) == getattr(jax_tool, name)(hw)


@pytest.mark.parametrize("shape", [(24, 360, 480, 64, 64),
                                   (24, 360, 480, 128, 64),
                                   (24, 360, 480, 3, 64),
                                   (24, 22, 30, 1024, 1024),
                                   (8, 360, 480, 64, 12)])
def test_roofline_matches_jax_tool(jax_tool, shape):
    got = perf_probe.roofline_tflops(*shape)
    want = jax_tool.roofline_tflops(*shape, peak_tflops=989.0,
                                    hbm_gbps=3350.0)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("traces", [1, perf_probe.TRACE_TRIES])
def test_op_calls_counts_every_attempt(monkeypatch, traces):
    """A row's ``calls`` is every call of its op: the warm-ups, each trace
    ``time_op`` took again and each attempt over the roofline (here a
    stand-in ``time_op`` that reads 1e-12 ms, so all three attempts run)."""
    def time_op(fn, k, dev, bound_ms=0.0):
        for _ in range(perf_probe.WARMUP + traces * k):
            fn()
        return 1e-12, 1e-12
    monkeypatch.setattr(perf_probe, "time_op", time_op)
    row = perf_probe.probe_shape(1, 4, 6, 8, 8, k=2, device="cpu")
    assert "suspect" in row
    assert row["calls"] == sum(perf_probe.WARMUP + traces * kk
                               for kk in (2, 6, 18))


def test_busy_ms_counts_overlaps_once():
    assert bench.busy_ms([]) == 0
    assert bench.busy_ms([(0, 1000), (2000, 2500)]) == 1.5
    # two kernels that overlap, one inside another, and one out of order
    spans = [(5000, 6000), (0, 1000), (500, 1500), (600, 700)]
    assert bench.busy_ms(spans) == 2.5


@pytest.mark.parametrize("steps", [1, 2])
def test_profile_summary_counts_overlaps_once(steps):
    # profile.py's busy time is perf_probe's: the union of the spans; the
    # summed kernel time and the groups count an overlap twice
    kernels = [("conv3x3_bn_relu_kernel<64>", 0, 1000),
               ("conv3x3_wgrad_kernel<64>", 500, 1500),
               ("sum_splits_kernel", 1500, 1600),
               ("vectorized_elementwise_kernel", 3000, 3400)]
    s = profile.summarize(kernels, steps=steps)
    assert s["span"] == pytest.approx(3.4 / steps)
    assert s["busy"] == pytest.approx(2.0 / steps)
    assert s["kernel"] == pytest.approx(2.5 / steps)
    assert s["busy"] == pytest.approx(bench.busy_ms(
        [(a, b) for _, a, b in kernels]) / steps)
    assert dict(s["groups"]) == pytest.approx({
        "K4/K1 conv (fwd, dx)": 1.0 / steps, "K1 dW": 1.1 / steps,
        "elementwise and copies": 0.4 / steps})
    assert s["by_name"]["sum_splits_kernel"] == pytest.approx(0.1 / steps)


@pytest.mark.parametrize("mode,impl", [("fwd", "plain"), ("fwd", "kernel"),
                                       ("fwd", "pair"), ("dgrad", "plain"),
                                       ("wgrad", "plain"),
                                       ("blockvjp", "plain")])
def test_probe_shape_rows_on_cpu(mode, impl):
    before = (fused_conv.conv3x3_bn_relu.launches,
              fused_conv_pair.conv3x3_pair_bn_relu.launches)
    row = perf_probe.probe_shape(2, 6, 10, 16, 32, k=2, mode=mode,
                                 kernel=impl == "kernel",
                                 pair=impl == "pair", device="cpu")
    assert SHAPE_KEYS <= set(row)
    assert row["shape"] == [2, 6, 10, 16, 32]
    assert (row["mode"], row["impl"], row["k"]) == (mode, impl, 2)
    assert row["device"] == "cpu" and "suspect" not in row
    assert np.isfinite(row["ms"]) and row["ms"] > 0
    assert row["ms_gross"] == row["ms"] and row["ms_chain_tax"] == 0
    assert row["roofline_tflops"] == perf_probe.roofline_tflops(
        2, 6, 10, 16, 32)[0]
    assert (fused_conv.conv3x3_bn_relu.launches,
            fused_conv_pair.conv3x3_pair_bn_relu.launches) == before


def test_probe_shape_kernel_flags_apply_to_fwd_only():
    row = perf_probe.probe_shape(1, 4, 6, 16, 16, k=1, kernel=True,
                                 pair=True, mode="dgrad", device="cpu")
    assert (row["mode"], row["impl"]) == ("dgrad", "plain")


def test_probe_shape_pair_needs_even_h():
    with pytest.raises(ValueError, match="even H"):
        perf_probe.probe_shape(1, 5, 8, 16, 16, k=1, pair=True,
                               device="cpu")


@pytest.mark.parametrize("impl", perf_probe.POOL_IMPLS)
def test_probe_pool_ops_rows_on_cpu(impl):
    before = fused_pool.launches()
    rows = perf_probe.probe_pool_ops(1, hw=(32, 46), k=1, impl=impl,
                                     device="cpu")
    assert [r["stage"] for r in rows] == [1, 2, 3, 4, 5]
    assert [r["shape"] for r in rows] == [
        [1, 32, 46, 64], [1, 16, 23, 128], [1, 8, 11, 256], [1, 4, 5, 512],
        [1, 2, 2, 512]]
    for r in rows:
        assert POOL_KEYS <= set(r) and r["impl"] == impl
        assert np.isfinite(r["pool_unpool_ms"]) and r["pool_unpool_ms"] > 0
        n, h, w, c = r["shape"]
        idx = 1 if impl in ("phase", "k2") else 4
        pooled = n * (h // 2) * (w // 2) * c
        traffic = n * h * w * c * 2 * 2 + pooled * (2 + idx) * 2
        assert r["bw_bound_ms"] == pytest.approx(traffic / 3.35e12 * 1e3)
    assert fused_pool.launches() == before


def _cli(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "pytorch_camvid_tpu_torch.perf_probe", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def test_cli_pair_shallow64_on_cpu():
    r = _cli(["--device", "cpu", "--pair", "--shapes", "shallow64",
              "--batch", "1", "--k", "1"])
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith("{")]
    assert [row["shape"] for row in rows] == [[1, 360, 480, 64, 64],
                                             [1, 360, 480, 128, 64]]
    for row in rows:
        assert row["impl"] == "pair" and row["multiplicity"] == 2
        assert row["mode"] == "fwd" and row["device"] == "cpu"


def test_cli_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    r = _cli(["--pair", "--shapes", "shallow64", "--batch", "1", "--k", "1"],
             timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and not r.stdout.strip()


def test_time_op_times_by_events_when_every_trace_is_empty(monkeypatch,
                                                            capsys):
    """A profiler that returns no device records TRACE_TRIES times in a row
    (seen on the H100) does not fail the run: ``ms`` is then the CUDA
    events' time, and stderr says so. The card's calls are stood in for by
    fakes, since this host has no CUDA."""
    import contextlib

    class Event:
        def __init__(self, enable_timing=False):
            pass

        def record(self):
            pass

        def elapsed_time(self, other):
            return 2.0

    traces = []

    @contextlib.contextmanager
    def profile(activities):
        traces.append(activities)
        yield object()

    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.profiler, "profile", profile)
    monkeypatch.setattr(perf_probe.bench, "device_spans", lambda prof: [])
    calls = []
    gross, ms = perf_probe.time_op(lambda: calls.append(1), 4,
                                   torch.device("cuda"))
    assert (gross, ms) == (0.5, 0.5)
    assert len(traces) == perf_probe.TRACE_TRIES
    assert len(calls) == perf_probe.WARMUP + 4 * perf_probe.TRACE_TRIES
    assert "held no device records" in capsys.readouterr().err



_SHORT = [("k", 1000.0 * i, 1000.0 * i + 250.0) for i in range(4)]
_WHOLE = [("k", 1000.0 * i, 1000.0 * i + 500.0) for i in range(4)]


@pytest.mark.parametrize("traces_seen,bound,want", [
    # one kernel of the 4 calls left (seen late in a whole chip_smoke run)
    ([[("k", 0.0, 500.0)], _WHOLE], 0.0, 0.5),
    # whole records, each busy for less than the bound (a K3 stage read
    # 1.38 of its byte bound)
    ([_SHORT, _WHOLE], 0.4, 0.5),
    # every trace under the bound: the last try's events' time (its calls
    # queued behind a spin of the device), a suspect reading
    ([_SHORT] * (perf_probe.TRACE_TRIES - 1), 0.4, 2.0)])
def test_time_op_takes_a_trace_again(monkeypatch, capsys, traces_seen,
                                     bound, want):
    """A trace holding fewer device records than calls, or whose busy time
    a call is under the caller's bound, is taken again, and the next sound
    trace gives ``ms``; where every trace but the last fails, ``ms`` is the
    last try's CUDA events' time and stderr says the reading is suspect.
    Fakes stand in for the card."""
    import contextlib

    class Event:
        def __init__(self, enable_timing=False):
            pass

        def record(self):
            pass

        def elapsed_time(self, other):
            return 8.0

    traces = []

    @contextlib.contextmanager
    def profile(activities):
        traces.append(activities)
        yield object()

    spans = iter(traces_seen)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.profiler, "profile", profile)
    monkeypatch.setattr(perf_probe.bench, "device_spans",
                        lambda prof: next(spans))
    calls = []
    got = perf_probe.time_op(lambda: calls.append(1), 4,
                             torch.device("cuda"), bound)
    tries = len(traces_seen) + (want == 2.0)
    assert got == (2.0, want)
    assert len(traces) == tries
    assert len(calls) == perf_probe.WARMUP + 4 * tries
    assert ("suspect reading" in capsys.readouterr().err) == (want == 2.0)
