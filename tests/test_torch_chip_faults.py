"""The planted faults of chip_faults.py that patch a launch function
(``conv_train._wgrad_launch``, ``layout_probes._launch``, the caller's
``conv_train.conv3x3_bn_relu``) or the data side (HostLoader, the loop's
train step, the LR finder's record, K2's pool backward, the card's jitter
factors) or the export (the K4 op's CUDA kernel, the upsample cache, the
int8 op's fake), on the CPU: each changes what it
should of the call it wraps, and nothing else. Whether chip_smoke's checks
catch them is shown on the card (``python3 chip_faults.py``)."""

import copy
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_faults
from pytorch_camvid_tpu_torch.data import augment
from pytorch_camvid_tpu_torch.data.pipeline import HostLoader
from pytorch_camvid_tpu_torch.ops import fused_conv, fused_pool
from pytorch_camvid_tpu_torch.ops import layout_probes as lp
from pytorch_camvid_tpu_torch.train import schedules

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


@pytest.mark.parametrize("cin,cout,hit", [(64, 21, True), (64, 12, False),
                                          (64, 64, False)])
def test_narrow_dx_tap_dropped_only_on_the_narrow_dx(cin, cout, hit):
    """The dx call (flip) of the VOC head's conv (its 21-channel cotangent,
    on the packed path since the head left the narrow kernels) loses its
    first tap; other calls, the 12-class head's dx among them, are as they
    were, and the caller's weights are not touched."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 5, 6, cout, generator=g)      # a dx call's input
    w = torch.randn(3, 3, cin, cout, generator=g)
    one, zero = torch.ones(cin), torch.zeros(cin)
    w0 = w.clone()
    got = chip_faults.narrow_dx_tap_dropped(x, w, one, zero, False, True)
    assert torch.equal(w, w0)
    cut = w.clone()
    cut[0, 0] = 0
    want = fused_conv.conv3x3_bn_relu(x, cut if hit else w, one, zero,
                                      False, True)
    assert torch.equal(got, want)
    assert hit == (not torch.equal(got, fused_conv.conv3x3_bn_relu(
        x, w, one, zero, False, True)))
    xf = torch.randn(1, 5, 6, cin, generator=g)     # forward calls: as is
    assert torch.equal(
        chip_faults.narrow_dx_tap_dropped(xf, w, torch.ones(cout),
                                          torch.zeros(cout)),
        fused_conv.conv3x3_bn_relu(xf, w, torch.ones(cout),
                                   torch.zeros(cout)))


def test_train_step_with_255_in_the_loss_drops_the_ignore_index(
        monkeypatch):
    seen = []
    monkeypatch.setattr(chip_faults, "_make_train_step",
                        lambda *a, **kw: seen.append((a, kw)))
    chip_faults.train_step_with_255_in_the_loss(1, 2, ignore_index=255,
                                                compute_dtype="x")
    assert seen == [((1, 2), {"ignore_index": None, "compute_dtype": "x"})]


def test_lr_recorded_before_the_step_is_the_steps_own():
    fn = schedules.exponential_sweep_lr(1e-7, 10, 12)
    for it in (1, 5, 12):
        assert chip_faults.lr_recorded_before_the_step(fn, it) == fn(it - 1)


def test_host_loader_serving_the_next_batch():
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (9, 2, 3, 3), dtype=np.uint8)
    masks = rng.integers(0, 12, (9, 2, 3), dtype=np.uint8)
    host = HostLoader(imgs, masks, 3, shuffle=True, seed=2, drop_last=True,
                      device="cpu")
    with chip_faults.host_loader_serving_next_batch():
        plan = host.epoch_indices(0)
        got = [host.gather(idx)[0].numpy() for idx in plan]
    for t, want in enumerate((1, 2, 2)):   # the last step's own
        np.testing.assert_array_equal(got[t], imgs[plan[want]])
    # outside the block: each step's own batch
    np.testing.assert_array_equal(host.gather(plan[0])[0].numpy(),
                                  imgs[plan[0]])


def test_planted_restores_own_and_inherited_methods():
    """A fault on a method the class inherits (the loaders' shared
    ``epoch``) is removed after the block, so the base's shows again; a
    class's own method is put back."""
    from pytorch_camvid_tpu_torch.data.pipeline import (DeviceDataLoader,
                                                        _EpochPlan)
    with chip_faults.planted(DeviceDataLoader, "epoch", len):
        assert DeviceDataLoader.epoch is len
    assert "epoch" not in DeviceDataLoader.__dict__
    assert DeviceDataLoader.epoch is _EpochPlan.epoch
    own = HostLoader.gather
    with chip_faults.planted(HostLoader, "gather", len):
        assert HostLoader.gather is len
    assert HostLoader.gather is own


def test_pool_backward_zeroed_has_the_inputs_shape():
    x = torch.randn(2, 6, 9, 4, generator=torch.Generator().manual_seed(0))
    pooled, k = fused_pool.pool_phase_train(x)
    ctx = SimpleNamespace(saved_tensors=(k,), in_hw=x.shape[1:3])
    got = chip_faults.pool_backward_zeroed(ctx, torch.ones_like(pooled), None)
    assert got.shape == x.shape and not got.any()


def test_card_factor_fault_leaves_the_cpu_factors():
    """The fault moves only factors on the card: on the CPU (the port the
    card is held against) the quantized factors are the sound ones."""
    f = torch.tensor([0.6, 1.0, 1.37, 0.91])
    assert torch.equal(chip_faults.card_factor_2pct_high(f),
                       augment.quantize_factor(f))


def test_shadowed_errors_keep_the_worst_and_nan():
    """chip_smoke's per-piece record of kernel-vs-plain errors keeps the
    largest, and a NaN once seen (which then fails its limit)."""
    errs = {}
    for e in (0.1, 0.3, 0.2):
        chip_faults.smoke._note(errs, "K1 dW", e)
    assert errs == {"K1 dW": 0.3}
    chip_faults.smoke._note(errs, "K1 dW", float("nan"))
    chip_faults.smoke._note(errs, "K1 dW", 0.5)
    assert math.isnan(errs["K1 dW"])


@pytest.fixture
def f32_launches(monkeypatch):
    """The weights of each f32 forward launch the faults pass on; each
    launch returns 1 + 2**-12."""
    seen = []

    def fwd(x, w, a, b, relu, flip):
        seen.append((w, flip))
        return torch.full((2, 3), 1.0 + 2.0 ** -12)

    monkeypatch.setattr(chip_faults, "_f32_launch", fwd)
    return seen


def test_f32_dx_tap_dropped_zeroes_a_copy_on_dx_only(f32_launches):
    """Only the dx on the packed route (VOC's 21 -> 64: g has 21 channels,
    Cin % 4 != 0) loses its first tap; a forward, and a dx on the wgmma
    route (64 -> 21's forward weights read the other way), pass as they
    were."""
    w = torch.ones(3, 3, 64, 21)
    chip_faults.f32_dx_tap_dropped(torch.zeros(1, 2, 2, 64), w, None, None,
                                   False, False)
    chip_faults.f32_dx_tap_dropped(torch.zeros(1, 2, 2, 21), w, None, None,
                                   False, True)
    wide = torch.ones(3, 3, 21, 64)
    chip_faults.f32_dx_tap_dropped(torch.zeros(1, 2, 2, 64), wide, None,
                                   None, False, True)
    (fwd_w, _), (dx_w, flip), (wide_w, _) = f32_launches
    assert fwd_w is w and flip and wide_w is wide
    assert not dx_w[0, 0].any() and dx_w[1:].all() and dx_w[0, 1:].all()
    assert w.all()   # the caller's weights untouched


def test_f32_output_through_bf16_rounds(f32_launches):
    """1 + 2**-12 leaves the faulty forward as 1.0, in f32."""
    out = chip_faults.f32_out_through_bf16(None, None, None, None, True,
                                           False)
    assert out.dtype == torch.float32 and torch.equal(out,
                                                      torch.ones(2, 3))


@pytest.mark.parametrize("name", ["single_pass", "lo_hi_dropped",
                                  "stale_scratch", "atomic_splits",
                                  "packed_dw_bgr"])
def test_f32_variant_faults_replace_both_callers_library(monkeypatch, name):
    """A planted f32 variant stands in for ``f32_library`` where both the
    forward's and the dW's launches look it up, and only inside the
    block; the variants are built once, all together."""
    from pytorch_camvid_tpu_torch.ops import conv_train
    builds = []

    def build(names):
        builds.append(tuple(names))
        return {n: f"lib {n}" for n in names}, [(n, True, []) for n in names]

    monkeypatch.setattr(chip_faults.f32_variants, "build", build)
    monkeypatch.setattr(chip_faults, "_F32_LIBS", {})
    sound = fused_conv.f32_library, conv_train.f32_library
    with chip_faults.f32_variant(name):
        assert fused_conv.f32_library() == conv_train.f32_library() == \
            f"lib {name}"
    with chip_faults.f32_variant(name):
        pass
    assert (fused_conv.f32_library, conv_train.f32_library) == sound
    assert builds == [chip_faults.f32_variants.FAULTS]


def test_recompute_updating_bn_again_moves_each_count_twice():
    """The remat fault: with ``recompute_updates_bn_again`` in place of
    ``remat_contexts`` a remat forward and backward advances every BN
    count by two and moves the running stats again; after the block the
    recompute leaves them alone."""
    from pytorch_camvid_tpu_torch.models import common, get_model
    model = get_model("unet", 3, 12, width_mult=1 / 16,
                      generator=torch.Generator().manual_seed(0)).train()
    x = torch.randn(2, 24, 32, 3, generator=torch.Generator().manual_seed(1))

    def after_step():
        m = copy.deepcopy(model)
        m(x, False, True).sum().backward()
        return m.state_dict()

    with chip_faults.planted(common, "remat_contexts",
                             chip_faults.recompute_updates_bn_again):
        planted = after_step()
    sound = after_step()
    for k, v in sound.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1 and int(planted[k]) == 2, k
        elif "running" in k:
            assert not torch.equal(v, planted[k]), k


@pytest.mark.parametrize("name", sorted(chip_faults.INT8_FAULTS))
def test_int8_fault_edits_apply(name):
    """Each int8 fault's edits apply to the kernel source it names, once
    each, and change it (built on the card by ``chip_faults.int8_fault``)."""
    module, edits = chip_faults.INT8_FAULTS[name]
    src = module.SOURCE.read_text()
    for old, new in edits:
        assert src.count(old) == 1 and old != new, old
    edited = chip_faults.edited_source(name)
    assert edited != src and all(new in edited for _, new in edits)


def test_int8_fault_libraries_take_the_wrappers_place(monkeypatch):
    """``int8_fault`` builds every variant once and puts the named one in
    place of its module's library inside the block only."""
    from pytorch_camvid_tpu_torch.ops import fused_conv_int8
    builds = []
    monkeypatch.setattr(chip_faults, "_INT8_LIBS", {})
    monkeypatch.setattr(chip_faults, "_build_fault", lambda n: (
        builds.append(n) or (n, f"lib {n}")))
    sound = fused_conv_int8._library, fused_pool._library
    with chip_faults.int8_fault("fmaf_epilogue"):
        assert fused_conv_int8._library() == "lib fmaf_epilogue"
        assert fused_pool._library is sound[1]
    with chip_faults.int8_fault("k3_last_max"):
        assert fused_pool._library() == "lib k3_last_max"
    assert (fused_conv_int8._library, fused_pool._library) == sound
    assert sorted(builds) == sorted(chip_faults.INT8_FAULTS)


@pytest.mark.parametrize("name", sorted(chip_faults.NARROW_FAULTS))
def test_narrow_fault_edits_apply(name):
    """Each fault of K4's narrow path edits its source once, inside the
    narrow namespace, and changes it (built on the card by
    ``chip_faults.narrow_fault``, caught there by ``narrow_checks``)."""
    module, edits = chip_faults.NARROW_FAULTS[name]
    assert module is fused_conv
    src = module.SOURCE.read_text()
    ns = src[src.index("namespace narrow {"):
             src.index("}  // namespace narrow")]
    for old, new in edits:
        assert src.count(old) == 1 and ns.count(old) == 1 and old != new
    edited = chip_faults.edited_source(name)
    assert edited != src and all(new in edited for _, new in edits)


def test_narrow_fault_libraries_take_the_wrappers_place(monkeypatch):
    """``narrow_fault`` builds the three variants once and puts the named
    one in place of fused_conv's library inside the block only."""
    builds = []
    monkeypatch.setattr(chip_faults, "_NARROW_LIBS", {})
    monkeypatch.setattr(chip_faults, "_build_fault", lambda n: (
        builds.append(n) or (n, f"lib {n}")))
    sound = fused_conv._library
    with chip_faults.narrow_fault("halo_unzeroed"):
        assert fused_conv._library() == "lib halo_unzeroed"
    with chip_faults.narrow_fault("flip_taps_not_reversed"):
        assert fused_conv._library() == "lib flip_taps_not_reversed"
    assert fused_conv._library is sound
    assert sorted(builds) == sorted(chip_faults.NARROW_FAULTS)
    # K4's three narrow faults and the narrow dW's three
    assert ("narrow" in chip_faults.PATHS
            and sum(c[0] == "narrow" for c in chip_faults.fault_cases()) == 6)


@pytest.mark.parametrize("cin,cout", [(3, 64), (64, 64), (128, 24)])
def test_weights_hwio_keeps_the_bytes_in_the_packed_shape(cin, cout):
    """The unrepacked-weights fault hands the kernel HWIO's bytes in the
    packed layout's shape: same shape and dtype, other values."""
    from pytorch_camvid_tpu_torch.ops import fused_conv_int8
    w = torch.randint(-127, 128, (3, 3, cin, cout), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(cin))
    got = chip_faults.weights_hwio(w)
    want = fused_conv_int8.pack_weights(w)
    assert got.shape == want.shape and got.dtype == torch.int8
    assert torch.equal(got.view(-1)[:w.numel()], w.view(-1))
    assert not torch.equal(got, want)


@pytest.mark.parametrize("cin", [40, 36, 100])
def test_padded_layout_faults_change_what_they_name(cin):
    """The weights' fault puts 1s in the packed weights' zero columns past
    Cin and leaves the rest (chip_smoke's ``padded_weights_ok`` tells the
    two apart); the buffer's fault hands out the padded layout with 1s past
    Cin; the map's fault edits x's extent (``x_extent_cs``, built on the
    card). The padded layout's x and weights poisoned so give the plain
    block's result on the CPU too."""
    import chip_smoke
    from pytorch_camvid_tpu_torch.ops import fused_conv_int8
    w = torch.randint(-127, 128, (3, 3, cin, 16), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(cin))
    sound, bad = fused_conv_int8.pack_weights(w), \
        chip_faults.weights_ones_past_cin(w)
    assert torch.equal(bad[..., :cin], sound[..., :cin])
    assert bool((bad[..., cin:] == 1).all()) and bad.shape[2] > cin
    assert chip_smoke.padded_weights_ok(sound, w)
    assert not chip_smoke.padded_weights_ok(bad, w)
    x = chip_faults.ones_block_input((2, 3, 5, cin), "cpu")
    assert x.stride() == fused_conv_int8.block_strides(2, 3, 5, cin)
    assert bool((x.as_strided((30 * x.stride(2),), (1,)) == 1).all())
    assert "xd[4] = {cs," in chip_faults.edited_source("x_extent_cs")
    t = {"x": torch.randint(-127, 128, (1, 4, 5, cin), dtype=torch.int8),
         "packed": sound}
    p = chip_smoke.poisoned(t)
    assert torch.equal(p["x"], t["x"]) and torch.equal(p["packed"], bad)
    args = (w, torch.rand(16) * 1e-3, torch.tensor(0.02), torch.randn(16))
    assert torch.equal(
        fused_conv_int8.conv3x3_int8_block(p["x"], *args,
                                           packed=p["packed"]),
        fused_conv_int8.conv3x3_int8_block_plain(t["x"], *args))


def test_fmaf_epilogue_rounds_otherwise():
    """The contracted epilogue rounds float(acc) * scale + bias once (an
    FMA: exact in float64, then to f32) where the kernel rounds twice; on
    random operands the two differ, so phase 16's bit-equality catches
    it."""
    rng = np.random.default_rng(0)
    acc = rng.integers(-2 ** 20, 2 ** 20, 100000).astype(np.float32)
    scale = rng.uniform(1e-6, 1e-4, 100000).astype(np.float32)
    bias = rng.normal(0, 1, 100000).astype(np.float32)
    twice = (acc * scale).astype(np.float32) + bias
    once = (acc.astype(np.float64) * scale + bias).astype(np.float32)
    assert (twice != once).mean() > 0.01


# ------------------------------------------------ phase 17's rank faults

def _mesh(rank):
    """A two-rank mesh whose all-reduce doubles (the sum of two equal
    ranks), without a process group."""
    from pytorch_camvid_tpu_torch.parallel.mesh import Mesh
    return Mesh(2, rank, torch.device("cpu"), levels=("stand-in",))


@pytest.fixture
def two_equal_ranks(monkeypatch):
    """``Mesh.all_reduce`` as two equal ranks' sum; the rank faults'
    patches undone after the test."""
    from pytorch_camvid_tpu_torch.ops import conv
    from pytorch_camvid_tpu_torch.parallel import mesh, spatial
    from pytorch_camvid_tpu_torch.train import steps
    monkeypatch.setattr(mesh.Mesh, "all_reduce",
                        lambda self, t, op=None: t.mul_(2))
    for owner, name in ((mesh.Mesh, "reduce_grads"), (conv, "sync_mesh"),
                        (steps, "loss_and_grads"),
                        (spatial, "exchange_rows")):
        monkeypatch.setattr(owner, name, getattr(owner, name))


def test_rank1_keeps_its_gradients(two_equal_ranks):
    grads = {"w": torch.ones(3)}
    chip_faults.rank1_keeps_its_gradients()
    assert torch.equal(_mesh(0).reduce_grads(grads, mean=False)["w"],
                       torch.full((3,), 2.0))
    assert _mesh(1).reduce_grads(grads, mean=False) is grads


def test_bn_on_local_moments_skips_the_sync(two_equal_ranks, monkeypatch):
    """A train-mode block under ``syncing``, the other rank's moments
    twice this one's: the synced output differs from the local one; under
    the fault it is the local one."""
    from pytorch_camvid_tpu_torch.ops.conv import ConvBNReLU, syncing
    from pytorch_camvid_tpu_torch.parallel.mesh import Mesh
    monkeypatch.setattr(Mesh, "all_reduce",
                        lambda self, t, op=None: t.mul_(3))
    blk = ConvBNReLU(3, 4, torch.Generator().manual_seed(0)).train()
    x = torch.randn(2, 6, 5, 3, generator=torch.Generator().manual_seed(1))
    local = copy.deepcopy(blk)(x)
    with syncing(_mesh(0)):
        synced = copy.deepcopy(blk)(x)
        chip_faults.bn_on_local_moments()
        faulty = copy.deepcopy(blk)(x)
    assert not torch.equal(synced, local)
    assert torch.equal(faulty, local)


def test_loss_over_local_weights_drops_the_mesh(two_equal_ranks):
    """The inferred step's ``loss_and_grads`` divides by the summed weights
    (twice the local sum here); under the fault by the local sum."""
    from pytorch_camvid_tpu_torch.models import get_model
    from pytorch_camvid_tpu_torch.train import steps
    model = get_model("unet", 3, 12, width_mult=1 / 16,
                      generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    y = torch.randint(0, 12, (2, 32, 32),
                      generator=torch.Generator().manual_seed(2))

    def loss():
        args = (copy.deepcopy(model), x, y, None, None, False, False,
                _mesh(0))
        return float(steps.loss_and_grads(*args)[0])
    sound = loss()
    chip_faults.loss_over_local_weights()
    assert loss() == pytest.approx(2 * sound, rel=1e-6)


def test_halo_rows_swapped_swaps_top_and_bottom(two_equal_ranks):
    from pytorch_camvid_tpu_torch.parallel import spatial
    top, bottom = torch.zeros(1, 2, 3, 4), torch.ones(1, 2, 3, 4)
    spatial.exchange_rows = lambda t, b, mesh: (b, t)   # the neighbours'
    chip_faults.halo_rows_swapped()
    got = spatial.exchange_rows(top, bottom, None)
    assert got[0] is top and got[1] is bottom


# ------------------------------------------------- phase 18's export faults

def _conv_args():
    g = torch.Generator().manual_seed(0)
    return (torch.randn(1, 4, 5, 8, generator=g).to(torch.bfloat16),
            torch.randn(3, 3, 8, 16, generator=g).to(torch.bfloat16),
            torch.ones(16), torch.zeros(16), True, False)


def test_op_kernel_plain_swaps_the_cuda_kernel_and_restores_it(monkeypatch):
    """Under the fault, the op's CUDA kernel (reached with the CUDA key on
    CPU tensors) is the plain version and never the launcher; after it,
    the launcher again."""
    from pytorch_camvid_tpu_torch.ops import library  # noqa: F401
    seen = []
    monkeypatch.setattr(fused_conv, "launch",
                        lambda *a: seen.append(a) or torch.zeros(1))
    op = torch.ops.camvid.conv3x3_bn_relu.default
    cuda = torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA)
    args = _conv_args()
    with chip_faults.op_kernel_plain():
        got = op.redispatch(cuda, *args)
    assert not seen
    assert torch.equal(got, fused_conv.conv3x3_bn_relu_plain(*args))
    op.redispatch(cuda, *args)
    assert len(seen) == 1


def _upsampling_export():
    """Export a module whose forward upsamples (UNet's 2x matrices)."""
    from pytorch_camvid_tpu_torch.ops import resize

    class Up(torch.nn.Module):
        def forward(self, x):
            return resize.upsample2x_bilinear_align_corners(x)

    x = torch.zeros(1, 3, 5, 2)
    with torch.no_grad():
        torch.export.export(Up(), (x,), strict=False)
    return resize.upsample2x_bilinear_align_corners(x + 1)


def test_upsample_cache_kept_while_tracing_poisons_the_next_call():
    """The sound cache leaves an eager call after a trace real; under the
    fault the trace's tensors reach it."""
    from torch._subclasses.fake_tensor import FakeTensor
    assert not isinstance(_upsampling_export(), FakeTensor)
    with chip_faults.upsample_cache_kept_while_tracing():
        with pytest.raises(Exception):
            out = _upsampling_export()
            assert not isinstance(out, FakeTensor)
    assert not isinstance(_upsampling_export(), FakeTensor)


def test_int8_fake_says_int8_only_inside_the_fault():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from pytorch_camvid_tpu_torch.ops import fused_conv_int8, library
    w_q = torch.zeros(3, 3, 8, 16, dtype=torch.int8)
    args = (torch.zeros(1, 4, 5, 8, dtype=torch.int8), w_q,
            fused_conv_int8.pack_weights(w_q), torch.ones(16),
            torch.tensor(1.0), torch.zeros(16), None, torch.bfloat16)

    def fake_dtype():
        with FakeTensorMode() as mode:
            fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                    for a in args]
            return torch.ops.camvid.conv3x3_int8_block(*fake).dtype

    assert library.OPS and fake_dtype() == torch.bfloat16
    with chip_faults.int8_fake_says_int8():
        assert fake_dtype() == torch.int8
    assert fake_dtype() == torch.bfloat16


def test_k5_f32_faults_are_registered():
    """Three planted faults of K5's f32 instance, each under phase 10's
    f32 checks: single-pass TF32 (the f32 source's variant), a pair's
    output rows swapped and the dx = 2 taps' weights zeroed (patches of
    ``fused_conv_pair._f32_launch``, whose launch counts stay)."""
    cases = [c for c in chip_faults.fault_cases() if c[0] == "K5 f32"]
    assert [what for _, what, _ in cases] == [
        "K5 f32 as single-pass TF32 (hi*hi only)",
        "K5 f32 output rows of each pair swapped",
        "K5 f32 with the dx = 2 taps' weights zeroed"]
    assert "K5 f32" in chip_faults.PATHS
    assert {path for path, _, _ in chip_faults.fault_cases()} == set(
        chip_faults.PATHS)
    assert "single_pass" in chip_faults.f32_variants.FAULTS
    from pytorch_camvid_tpu_torch.ops import fused_conv_pair
    sound = fused_conv_pair._f32_launch
    for _, _, fault in cases[1:]:
        with fault():
            assert fused_conv_pair._f32_launch is not sound
        assert fused_conv_pair._f32_launch is sound


def test_k5_f32_pair_faults_change_what_they_name(monkeypatch):
    """Rows swapped within each pair of the output; the weights' dx = 2
    column zeroed in a copy; nothing else."""
    seen = []

    def launch(x, w, a, b, relu):
        seen.append(w)
        return x + 0

    monkeypatch.setattr(chip_faults, "_pair_f32_launch", launch)
    x = torch.arange(2 * 4 * 3 * 1, dtype=torch.float32).view(2, 4, 3, 1)
    out = chip_faults.pair_f32_rows_swapped(x, None, None, None, True)
    assert torch.equal(out[:, 0::2], x[:, 1::2])
    assert torch.equal(out[:, 1::2], x[:, 0::2])
    w = torch.ones(3, 3, 4, 4)
    chip_faults.pair_f32_dx_tap_zeroed(x, w, None, None, True)
    got = seen[-1]
    assert not got[:, 2].any() and got[:, :2].all() and w.all()


def test_main_takes_paths():
    """``python3 chip_faults.py [path ...]``: an unknown path exits 2,
    a known one needs the card (1 here)."""
    assert chip_faults.main(["no such path"]) == 2
    assert chip_faults.main(["K5 f32"]) == 1
