"""Planted faults against chip_smoke.py's checks on one NVIDIA GPU (Hopper,
sm_90a): each fault must make a check fail.

    python3 chip_faults.py

Builds the kernels (chip_smoke's phases 1 and 2), then runs, on a
full-width SegNet with chip_smoke's He-scaled weights from seed 0, the
serving logits check (``chip_smoke.logits_parity``, batch 8, 360x480) and
the one-step training check (``chip_smoke.train_parity``, batch 32), and
K5's checks against its plain version and K4 (``chip_smoke.pair_checks``,
phase 10 without its timings) and the layout probes' checks against their
plain versions (``chip_smoke.probe_checks``, phase 11 without its
timings), phase 12's checks after its run A (``resume_checks``,
``eval_checks`` and ``predictor_checks``: the preempted and resumed run
against run A, the eval CLI and the Predictor on A's checkpoint), and
phase 13's (``augment_checks``: the recipes on the card against the CPU
port; ``host_loader_checks``, ``voc_checks``, ``lr_finder_checks``:
``-loader host`` against run A, VOC training and eval with the 64->21
head on the wgmma head tile and the packed paths, the LR finder's
sweeps), phase 14's
per-shape checks of the f32 kernels (``f32_kernel_checks``: the error
rule against float64 and the dW's determinism), phase 15's remat
check on a full-width UNet at batch 24 (``remat_parity``: the remat step
bit for bit against the step without) and phase 16's int8 checks
(``int8_kernel_checks`` and ``int8_pool_checks`` without their timings:
the int8 block bit for bit in three output modes at every quantized
block shape, K3 on int8 with ties), once sound and once under each
planted fault. Every kernel fault keeps every
kernel launch, so only the values can show it (the packed
dW's, rows_kernel's and the f32 kernels' faults patch the launch
functions ``conv_train._wgrad_launch``, ``layout_probes._launch`` and
``fused_conv._f32_launch``, never a wrapper, whose launch counts stay as
they are; the f32 kernels' arithmetic faults are edits of their source,
``f32_variants.FAULTS``, built beside it and put in place of the
library; so are the int8 block's and K3's int8 faults, ``INT8_FAULTS``:
the requantize by the reciprocal alone, the epilogue contracted to an
FMA, the pool keeping the last maximum of a tie, the input quantize by
the reciprocal; the int8 weights without
the K-major repack patch ``fused_conv_int8.pack_weights``), and phase 17's
checks of two ranks sharing the card (``dp_phase`` on UNet: the
data-parallel step against the one-process step, the ranks against each
other, and the H-sharded stage against the unsharded one). The ranks are
processes of their own, so their faults are functions each rank runs
first (``dp_phase``'s ``rank_setup``): rank 1 keeping its own gradients
after the all-reduce, sync-BN on each rank's own moments, the loss
divided by each rank's own sum of weights, the halo's top and bottom rows
swapped; and phase 18's (a) and (c) (``export_checks``: the bf16 UNet
Predictor's export, its maps after it and the program's launches and
maps; the int8 UNet's) under three faults of the export: K4's op with its
CUDA kernel registered to the plain version, the upsample matrices cached
while tracing (a plain ``lru_cache``), the int8 op's fake giving int8
where the kernel emits bf16. Prints each reading and the check that
failed; exits non-zero if the sound run fails a check or a fault passes
them all.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import itertools
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as smoke
from pytorch_camvid_tpu_torch import bench, f32_variants
from pytorch_camvid_tpu_torch import eval as eval_cli
from pytorch_camvid_tpu_torch import lr_finder
from pytorch_camvid_tpu_torch.data import augment
from pytorch_camvid_tpu_torch.data.pipeline import DeviceDataLoader, HostLoader
from pytorch_camvid_tpu_torch.models import common
from pytorch_camvid_tpu_torch.models.segnet import SegNet
from pytorch_camvid_tpu_torch.ops import (conv, conv_train, cuda_build,
                                          fused_conv, fused_conv_int8,
                                          fused_conv_pair, fused_pool,
                                          layout_probes, library, resize)
from pytorch_camvid_tpu_torch.parallel import mesh as mesh_mod
from pytorch_camvid_tpu_torch.parallel import spatial
from pytorch_camvid_tpu_torch.train import loop
from pytorch_camvid_tpu_torch.train import steps as steps_mod

# the 13th of a step's 26 dW launches (backward order): decoder5.0's
ZEROED_DW_CALL = 13


@contextlib.contextmanager
def planted(owner, name: str, value):
    """``owner.name`` (a module's function or a class's method, its own or
    inherited) replaced by ``value`` inside the block."""
    missing = object()
    saved = owner.__dict__.get(name, missing)
    setattr(owner, name, value)
    try:
        yield
    finally:
        if saved is missing:
            delattr(owner, name)   # the inherited one shows again
        else:
            setattr(owner, name, saved)


def k4_gain(x, w, a, b, relu=True):
    """The eval block's K4 launch with its output 1% too large."""
    out = fused_conv.conv3x3_bn_relu(x, w, a, b, relu)
    return (out.float() * 1.01).to(out.dtype)


_segnet_pools = SegNet._pools


def unpool_to_neighbour(self, plain):
    """The kernel path's K3 unpool puts each value at the other pixel of
    its window's row (flat index ^ 1: every SegNet plane is even-wide)."""
    pool, unpool = _segnet_pools(self, plain)
    if plain:
        return pool, unpool
    return pool, lambda x, idx, hw: unpool(x, idx ^ 1, hw)


def pool_backward_wrong_phase(ctx, g, _gk):
    """K2's pool backward unpooling the gradient at phase k ^ 1."""
    k, = ctx.saved_tensors
    return fused_pool.max_unpool_2x2_phase(g.contiguous(), k ^ 1, ctx.in_hw)


def unpool_backward_wrong_phase(ctx, g):
    """K2's unpool backward gathering at phase k ^ 1."""
    k, = ctx.saved_tensors
    return fused_pool.gather_phase(g.contiguous(), k ^ 1), None, None


_conv_forward = conv_train._Conv3x3Train.forward
_conv_backward = conv_train._Conv3x3Train.backward


def k1_gain(ctx, x, w):
    """K1's forward with its output 1% too large."""
    y = _conv_forward(ctx, x, w)
    return (y.float() * 1.01).to(y.dtype)


def zero_one_dw(ctx, g):
    """K1's backward with one block's dW zeroed (after its launch)."""
    dx, dw = _conv_backward(ctx, g)
    zero_one_dw.calls += 1
    if zero_one_dw.calls == ZEROED_DW_CALL:
        dw = torch.zeros_like(dw)
    return dx, dw


def stem_bgr(x, w, a, b, relu=True):
    """The eval stem's K4 launch (Cin 3, the packed path) with its weights'
    input channels 0 and 2 swapped (a copy): a BGR/RGB mix-up."""
    if x.shape[3] == 3:
        w = w[:, :, [2, 1, 0]].contiguous()
    return fused_conv.conv3x3_bn_relu(x, w, a, b, relu)


def dx_taps_not_reversed(x, w, a, b, relu=True, flip=False):
    """K1's dx launched with the tap reversal flag off: the same launch
    on the same path (the head's dx, Cin 12, on the packed one), its
    weights transposed (a copy) but read in forward tap order."""
    if flip:
        return fused_conv.conv3x3_bn_relu(
            x, w.transpose(2, 3).contiguous(), a, b, relu)
    return fused_conv.conv3x3_bn_relu(x, w, a, b, relu, flip)


_wgrad_launch = conv_train._wgrad_launch


def packed_dw_taps_transposed(x, g, path):
    """The packed dW launch with its taps transposed, dy and dx swapped
    (the packed M order read the wrong way round): dW[dx, dy] returned for
    dW[dy, dx], on the stem's and the head's calls."""
    out = _wgrad_launch(x, g, path)
    return out.transpose(0, 1).contiguous() if path == "packed" else out


def stem_dw_bgr(x, g, path):
    """The stem's dW launch (Cin 3, the packed path) with its input
    channels 0 and 2 swapped: a BGR/RGB mix-up in the gradient."""
    out = _wgrad_launch(x, g, path)
    return out[:, :, [2, 1, 0]].contiguous() if x.shape[3] == 3 else out


_f32_launch = fused_conv._f32_launch
_F32_LIBS = {}   # the fault variants of csrc/conv3x3_f32.cu, built once


@contextlib.contextmanager
def f32_variant(name: str):
    """The f32 kernels built from ``f32_variants.VARIANTS[name]`` (a fault:
    single-pass TF32, the lo*hi product dropped, a step sum started on the
    stale scratch, the dW's splits added by atomics, the packed dW's planes
    with the stem's x channels 0 and 2 swapped) in place of the source,
    for both callers of the library."""
    if not _F32_LIBS:
        libs, logs = f32_variants.build(f32_variants.FAULTS)
        for n, ok, log in logs:
            print(f"build f32 variant {n}: {'ok' if ok else 'FAILED'}; "
                  + " | ".join(log), flush=True)
        _F32_LIBS.update(libs)
    lib = _F32_LIBS[name]
    with planted(fused_conv, "f32_library", lambda: lib), \
            planted(conv_train, "f32_library", lambda: lib):
        yield


def f32_dx_tap_dropped(x, w, a, b, relu, flip):
    """The f32 dx on the packed route (``flip``, Cin % 4 != 0: VOC's 21 ->
    64) launched without its first tap (w[0, 0] zero in a copy); every
    other launch as it was."""
    if flip and fused_conv.f32_route(x.shape[3], w.shape[2]) == "f32_packed":
        w = w.clone()
        w[0, 0] = 0
    return _f32_launch(x, w, a, b, relu, flip)


def f32_out_through_bf16(x, w, a, b, relu, flip):
    """The f32 forward's output rounded through bf16."""
    return _f32_launch(x, w, a, b, relu, flip).bfloat16().float()


_pair_launch = fused_conv_pair._launch


def pair_rows_swapped(x, w, a, b, relu):
    """K5's launch with the two output rows of every pair swapped."""
    out = _pair_launch(x, w, a, b, relu)
    n, h, wd, c = out.shape
    return out.view(n, h // 2, 2, wd, c).flip(2).reshape(out.shape)


def pair_dx_tap_dropped(x, w, a, b, relu):
    """K5's launch with the dx = 2 taps dropped (their weights zero)."""
    w = w.clone()
    w[:, 2] = 0
    return _pair_launch(x, w, a, b, relu)


def pair_second_weight_tile_dropped(x, w, a, b, relu):
    """K5's launch past Cin 64 with input channels 64.. of x and w left
    out (copies of the first 64): the second resident weight tile's
    contribution is lost."""
    if x.shape[3] > 64:
        x = x[..., :64].contiguous()
        w = w[:, :, :64].contiguous()
    return _pair_launch(x, w, a, b, relu)


_probe_launch = layout_probes._launch


def m6_second_copy_at_offset_2(op, *args):
    """M6's launch with its second bulk copy at width offset 2, not 1."""
    if op == "sum_width_shifts":   # (xp, out, H, Wp, C, w, d0, d1, d2)
        args = args[:7] + (2,) + args[8:]
    return _probe_launch(op, *args)


def m4_at_row_offset_0(op, *args):
    """M4's launch reading its rows from offset 0, not 1."""
    if op == "slice_matmul":   # (x, w, out, rows, K, N, start, n)
        args = args[:6] + (args[6] - 1,) + args[7:]
    return _probe_launch(op, *args)


def m4_last_warp_k_part_dropped(op, *args):
    """M4's launch without the last warp's share of K: the k8 steps
    7, 15, 23, ... (w's rows 8 s .. 8 s + 7 zero in a copy)."""
    if op == "slice_matmul":
        w = args[1].clone()
        k = torch.arange(w.shape[0], device=w.device)
        w[(k // 8) % 8 == 7] = 0
        args = (args[0], w) + args[2:]
    return _probe_launch(op, *args)


def m4_second_block_dropped(op, *args):
    """M4's launch without the second 8-column block's contribution
    (w's columns 8 .. 15 zero in a copy)."""
    if op == "slice_matmul":
        w = args[1].clone()
        w[:, 8:16] = 0
        args = (args[0], w) + args[2:]
    return _probe_launch(op, *args)


def rows_one_row_early(op, *args):
    """rows_kernel's launch reading every output row from the row before
    it (offset - 1): the static start - 1 where it is past 0, the device
    start - 1 (a copy), the roll's shift + 1."""
    if op == "rows":   # (x, out, s_dev, mode, dtype, rows, cols, n, v)
        x, out, s_dev, mode, dtype, rows, cols, n, v = args
        if mode == layout_probes.ROWS_MODES["static"] and v > 0:
            v -= 1
        elif mode == layout_probes.ROWS_MODES["dynamic"]:
            s_dev = s_dev - 1
        elif mode == layout_probes.ROWS_MODES["roll"]:
            v = (v + 1) % rows
        args = (x, out, s_dev, mode, dtype, rows, cols, n, v)
    return _probe_launch(op, *args)


def rows_last_block_dropped(op, *args):
    """rows_kernel's static-start launch without its last block of output
    rows: n cut to the rows of the blocks before it, the rest of the output
    left as its allocation held it (NaN here, so that no earlier values
    can stand in for the rows that were not written)."""
    if op == "rows" and args[3] == layout_probes.ROWS_MODES["static"]:
        x, out, s_dev, mode, dtype, rows, cols, n, v = args
        keep = (n - 1) // layout_probes.ROWS_PER_BLOCK * \
            layout_probes.ROWS_PER_BLOCK
        out[keep:] = float("nan")
        if keep == 0:
            return None
        args = (x, out, s_dev, mode, dtype, rows, cols, keep, v)
    return _probe_launch(op, *args)


_load_checkpoint = loop.load_checkpoint


def resume_one_batch_late(path, state):
    """The loop's resume restarting one batch after the preemption
    point."""
    state, meta = _load_checkpoint(path, state)
    if "resume_batch_idx" in meta:
        meta = dict(meta, resume_batch_idx=meta["resume_batch_idx"] + 1)
    return state, meta


def resume_without_generator(path, state):
    """A resume whose checkpoint lacks the generator's state: the
    generator keeps its fresh seed."""
    fresh = state.generator.get_state()
    state, meta = _load_checkpoint(path, state)
    state.generator.set_state(fresh)
    return state, meta


_loader_epoch = DeviceDataLoader.epoch


def epoch_without_ragged_batch(self, epoch=None):
    """The loader's epoch without its last, short batch (the eval pass's
    ragged batch; training drops it anyway)."""
    for images, labels in _loader_epoch(self, epoch):
        if images.shape[0] == self.batch_size:
            yield images, labels


_make_eval_step = loop.make_eval_step


def eval_step_in_train_mode(*args, **kw):
    """An eval step whose model stays in train mode: batch statistics, and
    the running stats updated by every eval batch."""
    step = _make_eval_step(*args, **kw)

    def fn(state, batch):
        model = state.model
        model.train()
        model.eval = lambda: model   # the step's switch to eval mode
        try:
            return step(state, batch)
        finally:
            del model.eval
    return fn


@contextlib.contextmanager
def eval_steps_in_train_mode():
    """``eval_step_in_train_mode`` where the loop and the eval CLI build
    their eval steps."""
    with planted(loop, "make_eval_step", eval_step_in_train_mode), \
            planted(eval_cli, "make_eval_step", eval_step_in_train_mode):
        yield


def narrow_dx_tap_dropped(x, w, a, b, relu=True, flip=False):
    """K1's dx of the VOC head, the narrow 21-channel cotangent into 64
    channels (on the packed path), launched without its first tap (w[0,
    0] zero in a copy); every other launch, the 12-class head's dx among
    them, as it was."""
    if flip and w.shape[3] == smoke.VOC_CLASSES:
        w = w.clone()
        w[0, 0] = 0
    return fused_conv.conv3x3_bn_relu(x, w, a, b, relu, flip)


_make_train_step = loop.make_train_step


def train_step_with_255_in_the_loss(*args, **kw):
    """The loop's train step built without its ignore index: VOC's 255
    pixels (the letterbox rows) stay in the loss."""
    return _make_train_step(*args, **dict(kw, ignore_index=None))


def lr_recorded_before_the_step(lr_fn, it):
    """The LR finder recording the lr its step used, not the next one."""
    return float(lr_fn(it - 1))


_epoch_indices = HostLoader.epoch_indices
_host_gather = HostLoader.gather


def plan_recording_epoch_indices(self, epoch=None):
    self.fault_plan = _epoch_indices(self, epoch)
    return self.fault_plan


def gather_next_batch(self, idx):
    """HostLoader serving the plan's batch t + 1 at step t (the last
    step's own): the rows its epoch plan lists after ``idx``."""
    plan = getattr(self, "fault_plan", None)
    if plan is not None:
        rows = [i for i, r in enumerate(plan) if np.array_equal(r, idx)]
        if rows and rows[0] + 1 < len(plan):
            idx = plan[rows[0] + 1]
    return _host_gather(self, idx)


@contextlib.contextmanager
def host_loader_serving_next_batch():
    with planted(HostLoader, "epoch_indices", plan_recording_epoch_indices), \
            planted(HostLoader, "gather", gather_next_batch):
        yield


def pool_backward_zeroed(ctx, g, _gk):
    """K2's pool backward returning zeros (after its launch): only SegNet
    runs K2, so among phase 13's runs only the LR finder's SegNet sweep."""
    return torch.zeros_like(fused_pool.max_unpool_2x2_phase(
        g.contiguous(), ctx.saved_tensors[0], ctx.in_hw))


_quantize_factor = augment.quantize_factor


def card_factor_2pct_high(f):
    """The brightness and contrast factors 2% too large on the card (the
    CPU port's as they were): a pixel moves by up to 5 on the 0-255
    scale, under the full jitter's limit, over the LR finder recipe's."""
    return _quantize_factor(f * 1.02 if f.is_cuda else f)


def recompute_updates_bn_again():
    """``checkpoint``'s contexts without ``recomputing()``: the recompute
    moves every block's BN running stats and count a second time."""
    return contextlib.nullcontext(), contextlib.nullcontext()


# int8 faults that are edits of a kernel source: (the wrapper's module,
# whose ``SOURCE`` is edited and whose ``bind`` types the library, edits)
INT8_FAULTS = {
    # the requantize's product by 1/s_out everywhere: no IEEE division
    # where it rounds otherwise (near the half-integers)
    "reciprocal_requantize": (fused_conv_int8, [(
        "  near = fabsf(__fsub_rn(0.5f, fabsf(d))) <= q0 * 0x1p-22f && "
        "q0 < 127.f;",
        "  near = false;")]),
    # the dequantize's multiply and add contracted to one FMA
    "fmaf_epilogue": (fused_conv_int8, [(
        "  const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), "
        "bias);",
        "  const float y = fmaf(__int2float_rn(acc), scale, bias);")]),
    # K3's pool keeping the last maximum of a window at a tie
    "k3_last_max": (fused_pool, [("      if (v > m || isnan(v)) {",
                                  "      if (v >= m || isnan(v)) {")]),
    # the input quantize multiplying by 1/s instead of dividing by s
    "reciprocal_quantize": (fused_conv_int8, [(
        "  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), "
        "127.f);",
        "  const float q = fminf(fmaxf(rintf(__fmul_rn(v, __frcp_rn(s))), "
        "-127.f), 127.f);")]),
}
_INT8_LIBS = {}   # the fault variants, built once


def edited_source(name: str) -> str:
    """``INT8_FAULTS[name]``'s source: the kernel source with its edits
    (each must apply)."""
    module, edits = INT8_FAULTS[name]
    src = module.SOURCE.read_text()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"fault edit does not apply: {old!r}")
        src = src.replace(old, new)
    return src


def _build_fault(name: str):
    out = cuda_build.BUILD_DIR / "int8_faults"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"{name}.cu"
    src.write_text(edited_source(name))
    lib = src.with_suffix(".so")
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                        str(cuda_build.CSRC), "-o", str(lib), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"fault {name}: nvcc failed:\n{r.stderr[-3000:]}")
    return name, INT8_FAULTS[name][0].bind(ctypes.CDLL(str(lib)))


@contextlib.contextmanager
def int8_fault(name: str):
    """The kernel source of ``INT8_FAULTS[name]`` built with its edits and
    put in place of its library (every variant is built, in parallel, at
    the first use)."""
    if not _INT8_LIBS:
        with ThreadPoolExecutor(len(INT8_FAULTS)) as pool:
            _INT8_LIBS.update(pool.map(_build_fault, INT8_FAULTS))
    module = INT8_FAULTS[name][0]
    with planted(module, "_library", lambda: _INT8_LIBS[name]):
        yield


def weights_hwio(w_q):
    """conv3x3_int8's packed weights made of the HWIO bytes as they lie,
    without the K-major repack: the same bytes in the packed shape (zero
    padded to it on the packed path)."""
    want = _pack_weights(w_q).shape
    flat = w_q.contiguous().view(-1)
    pad = want.numel() - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(want).contiguous()


_pack_weights = fused_conv_int8.pack_weights


# ------------------------------------------- faults run inside the ranks

@contextlib.contextmanager
def op_kernel_plain():
    """``camvid::conv3x3_bn_relu``'s CUDA kernel registered to the plain
    version (cuDNN through ``F.conv2d``), a fallback nobody sees: eager
    calls keep the launcher, a loaded program launches no K4."""
    op = library.conv3x3_bn_relu
    op.register_kernel("cuda")(
        lambda x, w, a, b, relu, flip: fused_conv.conv3x3_bn_relu_plain(
            x, w, a, b, relu, flip).contiguous())
    try:
        yield
    finally:
        op.register_kernel("cuda")(op._init_fn)


def upsample_cache_kept_while_tracing():
    """``resize._upsample_matrices`` as a plain ``lru_cache`` (a fresh
    one), which keeps the tensors a trace builds."""
    return planted(resize, "_upsample_matrices", functools.lru_cache(
        maxsize=64)(resize._upsample_matrices.__wrapped__))


@contextlib.contextmanager
def int8_fake_says_int8():
    """``camvid::conv3x3_int8_block``'s fake giving an int8 output where
    the kernel emits the compute dtype (``s_out`` absent)."""
    op = library.conv3x3_int8_block
    fake = op._abstract_fn
    op.register_fake(lambda x, w_q, packed, s_w, s_x, b_eff, s_out,
                     out_dtype: x.new_empty(x.shape[:3] + w_q.shape[3:],
                                            dtype=torch.int8))
    try:
        yield
    finally:
        op.register_fake(fake)


def rank1_keeps_its_gradients():
    """Rank 1 takes part in the gradient all-reduce and keeps its own
    gradients."""
    sound = mesh_mod.Mesh.reduce_grads

    def reduce_grads(self, grads, mean):
        reduced = sound(self, grads, mean)
        return grads if self.rank == 1 else reduced
    mesh_mod.Mesh.reduce_grads = reduce_grads


def bn_on_local_moments():
    """Sync-BN off: every block normalizes by its rank's own moments."""
    conv.sync_mesh = lambda: None


def loss_over_local_weights():
    """The inferred step's loss divided by the rank's own sum of weights
    (``loss_and_grads`` without the mesh)."""
    sound = steps_mod.loss_and_grads
    steps_mod.loss_and_grads = lambda *args: sound(*args[:7])


def halo_rows_swapped():
    """Each rank's top and bottom halo rows swapped."""
    sound = spatial.exchange_rows
    spatial.exchange_rows = lambda top, bottom, mesh: sound(
        top, bottom, mesh)[::-1]


_rank_fault = [None]   # the fault dp_phase's ranks run first


@contextlib.contextmanager
def in_ranks(setup):
    """Inside the block phase 17's ranks run ``setup`` first."""
    _rank_fault[0] = setup
    try:
        yield
    finally:
        _rank_fault[0] = None


def failed_check(run, fault) -> str:
    """The message of the chip_smoke check that ``run`` fails under
    ``fault``, or '' when it passes."""
    try:
        with fault():
            run()
    except RuntimeError as e:
        if "chip_smoke check failed" not in str(e):
            raise
        return str(e)
    return ""


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_faults: no CUDA device", file=sys.stderr)
        return 1
    smoke.start()
    rng = np.random.default_rng(smoke.SEED)
    train = conv_train._Conv3x3Train
    cases = [
        ("serving", "K4 output x1.01 (every launch)",
         lambda: planted(conv, "conv3x3_bn_relu", k4_gain)),
        ("serving", "stem weights' input channels 0 and 2 swapped (BGR/RGB)",
         lambda: planted(conv, "conv3x3_bn_relu", stem_bgr)),
        ("serving", "K3 unpool at the neighbouring pixel",
         lambda: planted(SegNet, "_pools", unpool_to_neighbour)),
        ("training", "K2 pool backward at a wrong phase",
         lambda: planted(fused_pool._PoolPhaseTrain, "backward",
                         staticmethod(pool_backward_wrong_phase))),
        ("training", "K2 unpool backward (gather) at a wrong phase",
         lambda: planted(fused_pool._UnpoolPhaseTrain, "backward",
                         staticmethod(unpool_backward_wrong_phase))),
        ("training", f"K1 dW zeroed on one leaf (call {ZEROED_DW_CALL})",
         lambda: planted(train, "backward", staticmethod(zero_one_dw))),
        ("training", "K1 forward output x1.01 (every launch)",
         lambda: planted(train, "forward", staticmethod(k1_gain))),
        ("training", "K1 dx with the tap reversal flag off (every launch)",
         lambda: planted(conv_train, "conv3x3_bn_relu",
                         dx_taps_not_reversed)),
        ("training", "packed dW with its taps transposed (dy and dx "
         "swapped; the stem's and the head's)",
         lambda: planted(conv_train, "_wgrad_launch",
                         packed_dw_taps_transposed)),
        ("training", "the stem's dW with input channels 0 and 2 swapped "
         "(BGR/RGB)",
         lambda: planted(conv_train, "_wgrad_launch", stem_dw_bgr)),
        ("K5", "K5 output rows of each pair swapped",
         lambda: planted(fused_conv_pair, "_launch", pair_rows_swapped)),
        ("K5", "K5 with one dx tap dropped",
         lambda: planted(fused_conv_pair, "_launch", pair_dx_tap_dropped)),
        ("K5", "K5 past Cin 64 without input channels 64.. of x and w",
         lambda: planted(fused_conv_pair, "_launch",
                         pair_second_weight_tile_dropped)),
        ("probes", "M6's second copy at width offset 2 instead of 1",
         lambda: planted(layout_probes, "_launch",
                         m6_second_copy_at_offset_2)),
        ("probes", "M4 at row offset 0 instead of 1",
         lambda: planted(layout_probes, "_launch", m4_at_row_offset_0)),
        ("probes", "M4 without the last warp's share of K",
         lambda: planted(layout_probes, "_launch",
                         m4_last_warp_k_part_dropped)),
        ("probes", "M4 without the second 8-column block",
         lambda: planted(layout_probes, "_launch", m4_second_block_dropped)),
        ("probes", "rows_kernel reading one row early (M1-M3, M5)",
         lambda: planted(layout_probes, "_launch", rows_one_row_early)),
        ("probes", "rows_kernel without its last block of rows (M1, M2)",
         lambda: planted(layout_probes, "_launch",
                         rows_last_block_dropped)),
        ("training run", "resume one batch past the preemption point",
         lambda: planted(loop, "load_checkpoint", resume_one_batch_late)),
        ("training run", "resume without the generator's state",
         lambda: planted(loop, "load_checkpoint", resume_without_generator)),
        ("training run", "evaluate without the ragged last batch",
         lambda: planted(DeviceDataLoader, "epoch",
                         epoch_without_ragged_batch)),
        ("training run", "the eval step in train mode",
         eval_steps_in_train_mode),
        ("augment", "the card's brightness and contrast factors 2% high",
         lambda: planted(augment, "quantize_factor", card_factor_2pct_high)),
        ("data side", "K2 pool backward returning zeros (the SegNet LR "
         "sweep)",
         lambda: planted(fused_pool._PoolPhaseTrain, "backward",
                         staticmethod(pool_backward_zeroed))),
        ("data side", "HostLoader serving batch t + 1 in place of t",
         host_loader_serving_next_batch),
        ("data side", "the VOC head's dx (Cin 21) with one tap dropped",
         lambda: planted(conv_train, "conv3x3_bn_relu",
                         narrow_dx_tap_dropped)),
        ("data side", "VOC's 255 pixels left in the training loss",
         lambda: planted(loop, "make_train_step",
                         train_step_with_255_in_the_loss)),
        ("data side", "the LR finder recording the lr before the step",
         lambda: planted(lr_finder, "recorded_lr",
                         lr_recorded_before_the_step)),
        ("f32", "single-pass TF32 (hi*hi only; the wgmma and packed "
         "kernels, forward and dW)",
         lambda: f32_variant("single_pass")),
        ("f32", "the lo*hi product dropped (the wgmma and packed kernels)",
         lambda: f32_variant("lo_hi_dropped")),
        ("f32", "the f32 packed dx (Cin 21) without its first tap",
         lambda: planted(fused_conv, "_f32_launch", f32_dx_tap_dropped)),
        ("f32", "the f32 forward's output rounded through bf16",
         lambda: planted(fused_conv, "_f32_launch", f32_out_through_bf16)),
        ("f32", "the f32 dW's splits summed in launch order (atomics)",
         lambda: f32_variant("atomic_splits")),
        ("f32", "the f32 packed dW's planes built with the stem's x "
         "channels 0 and 2 swapped (BGR/RGB)",
         lambda: f32_variant("packed_dw_bgr")),
        ("f32", "a step sum's first product added onto the stale scratch "
         "(scale-d 1; the wgmma and packed kernels)",
         lambda: f32_variant("stale_scratch")),
        ("remat", "the recompute updating the BN running stats again",
         lambda: planted(common, "remat_contexts",
                         recompute_updates_bn_again)),
        ("int8", "the int8 requantize multiplying by 1/s_out (no IEEE "
         "division near the half-integers)",
         lambda: int8_fault("reciprocal_requantize")),
        ("int8", "the int8 weights read as HWIO, without the K-major repack",
         lambda: planted(fused_conv_int8, "pack_weights", weights_hwio)),
        ("int8", "the int8 epilogue's multiply and add contracted to fmaf",
         lambda: int8_fault("fmaf_epilogue")),
        ("int8", "K3's int8 pool taking the last maximum at a tie",
         lambda: int8_fault("k3_last_max")),
        ("int8", "the input quantize kernel multiplying by 1/s",
         lambda: int8_fault("reciprocal_quantize")),
        ("multi-GPU", "rank 1 keeping its own gradients after the "
         "all-reduce", lambda: in_ranks(rank1_keeps_its_gradients)),
        ("multi-GPU", "sync-BN on each rank's own moments",
         lambda: in_ranks(bn_on_local_moments)),
        ("multi-GPU", "the loss divided by the rank's own sum of weights "
         "(255 on one rank only)", lambda: in_ranks(loss_over_local_weights)),
        ("multi-GPU", "the halo's top and bottom rows swapped",
         lambda: in_ranks(halo_rows_swapped)),
        ("export", "the K4 op's CUDA kernel registered to the plain version",
         op_kernel_plain),
        ("export", "the upsample matrices cached while tracing",
         upsample_cache_kept_while_tracing),
        ("export", "the int8 op's fake giving int8 where the kernel emits "
         "bf16", int8_fake_says_int8),
    ]
    ok = True
    tmp = tempfile.TemporaryDirectory()
    for path in ("serving", "training", "K5", "probes", "training run",
                 "augment", "data side", "f32", "remat", "int8",
                 "multi-GPU", "export"):
        gen = torch.Generator().manual_seed(smoke.SEED)
        if path == "serving":
            model = bench.he_model("segnet", gen).cuda().eval()
            model.prepare(torch.bfloat16)
            x = torch.from_numpy(rng.integers(
                0, 256, (smoke.BATCH,) + smoke.HW + (3,), dtype=np.uint8)
            ).cuda()

            def run():
                smoke.logits_parity("segnet", model, x)
        elif path == "training":
            model, batch = smoke.train_setup("segnet", gen)

            def run():
                zero_one_dw.calls = 0
                smoke.train_parity("segnet", model, batch)
        elif path == "K5":   # K5's checks make their own inputs
            model = None

            def run():
                smoke.pair_checks(torch.Generator(device="cuda").manual_seed(
                    smoke.SEED))
        elif path == "probes":   # phase 11's checks, likewise
            model = None

            def run():
                smoke.probe_checks(torch.Generator(
                    device="cuda").manual_seed(smoke.SEED))
        elif path == "training run":   # phase 12 after its run A, which
            model = None                # no fault touches
            data = smoke.write_training_data(os.path.join(tmp.name, "data"))
            a = smoke.training_run_a(os.path.join(tmp.name, "a"), data)
            runs = itertools.count()

            def run():
                smoke.resume_checks(
                    os.path.join(tmp.name, f"b{next(runs)}"), data, a)
                smoke.predictor_checks(data, a, smoke.eval_checks(data, a))
        elif path == "augment":   # phase 13's first part
            model = None

            def run():
                smoke.augment_checks()
        elif path == "f32":   # phase 14's per-shape checks
            model = None

            def run():
                smoke.f32_kernel_checks(torch.Generator(
                    device="cuda").manual_seed(smoke.SEED))
        elif path == "remat":   # phase 15's first part, on UNet
            model, batch = smoke.train_setup("unet", gen)

            def run():
                smoke.remat_parity("unet", model, batch)
        elif path == "int8":   # phase 16's per-shape and K3 int8 checks
            model = None

            def run():
                g = torch.Generator(device="cuda").manual_seed(smoke.SEED)
                smoke.int8_kernel_checks(g, timed=False)
                smoke.int8_pool_checks(g, timed=False)
        elif path == "multi-GPU":   # phase 17 (a) on UNet and (e)
            model = None

            def run():
                smoke.dp_phase(nets=("unet",), rank_setup=_rank_fault[0])
        elif path == "export":   # phase 18 (a) and (c)
            model = None
            exports = itertools.count()

            def run():
                work = os.path.join(tmp.name, f"e{next(exports)}")
                os.makedirs(work)
                smoke.export_checks(work)
        else:   # phase 13's checks on phase 12's data and run A
            model = None

            def run():
                work = os.path.join(tmp.name, f"d{next(runs)}")
                os.makedirs(work)
                smoke.host_loader_checks(work, data, a)
                smoke.voc_checks(work)
                smoke.lr_finder_checks(data)
        print(f"{path}, sound:", flush=True)
        msg = failed_check(run, contextlib.nullcontext)
        print(f"{path}, sound: {'FAILED ' + msg if msg else 'passed'}",
              flush=True)
        ok &= not msg
        for _, what, fault in (c for c in cases if c[0] == path):
            print(f"{path}, fault: {what}", flush=True)
            msg = failed_check(run, fault)
            print(f"{path}, fault: {what}: "
                  f"{'caught: ' + msg if msg else 'NOT CAUGHT'}", flush=True)
            ok &= bool(msg)
        del model
        torch.cuda.empty_cache()
    tmp.cleanup()
    print(bench.card())
    print("chip_faults: " + ("every fault caught, sound runs pass" if ok
                             else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
