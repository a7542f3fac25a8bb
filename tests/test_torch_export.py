"""The port's export surface against the JAX package, on the CPU: the
``camvid::`` ops of ``ops/library.py`` (each against its plain version,
``torch.library.opcheck``, its CUDA kernel the launcher) and
``Predictor.export_program`` (the program's op nodes, the program loaded in
a process that imports only ``ops.library``, bit-equal to the live
Predictor and equal to the JAX Predictor away from near ties, the live
Predictor unchanged by the export, the int8 Predictor's program).

UNet and SegNet at width 1/16, 45x62, batch 2 (the sizes of
test_torch_unet_serving.py and test_torch_segnet.py); the int8 models at
the widths of test_torch_quant_models.py."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor

from pytorch_camvid_tpu.serving import Predictor as JaxPredictor

from pytorch_camvid_tpu_torch.config import settings
from pytorch_camvid_tpu_torch.data.normalize import to_tensor_normalize
from pytorch_camvid_tpu_torch.interop.weights import (
    state_dict_from_jax_variables)
from pytorch_camvid_tpu_torch.models import get_model
from pytorch_camvid_tpu_torch.ops import (fused_conv, fused_conv_int8,
                                          fused_pool, library, pooling, quant)
from pytorch_camvid_tpu_torch.serving import Predictor

import test_torch_segnet
import test_torch_unet_serving

HW = (45, 62)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIABLES = {"unet": test_torch_unet_serving._jax_variables,
             "segnet": test_torch_segnet._variables}
# op nodes of one eval forward: K4 per block, SegNet's K3 pools
NODES = {"unet": {"camvid::conv3x3_bn_relu": 23},
         "segnet": {"camvid::conv3x3_bn_relu": 26,
                    "camvid::max_pool_2x2_argmax": 5,
                    "camvid::max_unpool_2x2": 5}}
LIBRARY_OPS = ("aten::convolution", "aten::conv2d", "aten::_convolution",
               "aten::max_pool2d_with_indices", "aten::max_unpool2d")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny ops: one intra-op thread (several test workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ ops

def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _conv_args(dtype, flip):
    g = _gen()
    cin, cout = (16, 8) if flip else (8, 16)
    x = torch.randn(2, 5, 7, cin, generator=g).to(dtype)
    w = (0.3 * torch.randn(3, 3, cout, cin, generator=g) if flip
         else 0.3 * torch.randn(3, 3, cin, cout, generator=g)).to(dtype)
    a = torch.rand(cout, generator=g) + 0.5
    b = torch.randn(cout, generator=g)
    return (x, w, a, b, not flip, flip)


def _pool_input(dtype):
    """(2, 5, 7, 8) with ties: values on a coarse grid."""
    x = torch.randint(-3, 4, (2, 5, 7, 8), generator=_gen(1))
    return x.to(dtype)


def _int8_args(s_out):
    g = _gen(2)
    cin, cout = 8, 16
    x = torch.randint(-127, 128, (2, 5, 7, cin), generator=g).to(torch.int8)
    w_q = torch.randint(-127, 128, (3, 3, cin, cout),
                        generator=g).to(torch.int8)
    s_w = torch.rand(cout, generator=g) * 1e-2
    s_x = torch.tensor(0.05)
    b_eff = torch.randn(cout, generator=g)
    out = torch.tensor(0.2) if s_out else None
    dtype = torch.int8 if s_out else torch.bfloat16
    return (x, w_q, fused_conv_int8.pack_weights(w_q), s_w, s_x, b_eff, out,
            dtype)


def _cases():
    """{id: (op name, args, plain version on the same args)}."""
    pooled, idx = pooling.max_pool_2x2_with_argmax(
        _pool_input(torch.float32))
    phased, k = pooling.max_pool_2x2_argmax_phase(_pool_input(torch.float32))
    int8_plain = lambda x, w_q, packed, *rest: \
        fused_conv_int8.conv3x3_int8_block_plain(x, w_q, *rest)   # noqa
    return {
        "conv3x3_bn_relu-bf16": ("conv3x3_bn_relu",
                                 _conv_args(torch.bfloat16, False),
                                 fused_conv.conv3x3_bn_relu_plain),
        "conv3x3_bn_relu-f32-flip": ("conv3x3_bn_relu",
                                     _conv_args(torch.float32, True),
                                     fused_conv.conv3x3_bn_relu_plain),
        "max_pool_2x2_argmax-bf16": ("max_pool_2x2_argmax",
                                     (_pool_input(torch.bfloat16),),
                                     pooling.max_pool_2x2_with_argmax),
        "max_pool_2x2_argmax-int8": ("max_pool_2x2_argmax",
                                     (_pool_input(torch.int8),),
                                     pooling.max_pool_2x2_with_argmax),
        "max_unpool_2x2-f32": ("max_unpool_2x2", (pooled, idx, [5, 7]),
                               pooling.max_unpool_2x2),
        "max_pool_2x2_phase-bf16": ("max_pool_2x2_phase",
                                    (_pool_input(torch.bfloat16),),
                                    pooling.max_pool_2x2_argmax_phase),
        "max_unpool_2x2_phase-f32": ("max_unpool_2x2_phase",
                                     (phased, k, [5, 7]),
                                     pooling.max_unpool_2x2_from_phase),
        "conv3x3_int8_block-int8_out": ("conv3x3_int8_block",
                                        _int8_args(True), int8_plain),
        "conv3x3_int8_block-bf16_out": ("conv3x3_int8_block",
                                        _int8_args(False), int8_plain),
        "quantize_int8-bf16": ("quantize_int8",
                               (torch.randn(2, 5, 7, 8, generator=_gen(3))
                                .to(torch.bfloat16), torch.tensor(0.01)),
                               fused_conv_int8.quantize_plain),
        "quantize_int8-f32": ("quantize_int8",
                              (torch.randn(3, 33, generator=_gen(4)),
                               torch.tensor(0.02)),
                              fused_conv_int8.quantize_plain),
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_passes_opcheck_and_equals_plain(case):
    name, args, plain = CASES[case]
    op = getattr(torch.ops.camvid, name)
    torch.library.opcheck(op, args)
    got, want = op(*args), plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.is_contiguous()
        assert torch.equal(g, w)


# the launcher behind each op's CUDA kernel: (module, attribute)
LAUNCHERS = {
    "conv3x3_bn_relu": (fused_conv, "launch"),
    "max_pool_2x2_argmax": (fused_pool, "launch_pool_argmax"),
    "max_unpool_2x2": (fused_pool, "launch_unpool"),
    "max_pool_2x2_phase": (fused_pool, "launch_pool_phase"),
    "max_unpool_2x2_phase": (fused_pool, "launch_unpool_phase"),
    "conv3x3_int8_block": (fused_conv_int8, "launch"),
    "quantize_int8": (fused_conv_int8, "launch_quantize"),
}


def test_every_op_is_in_the_table():
    assert sorted(library.OPS) == sorted(f"camvid::{n}" for n in LAUNCHERS)


@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_op_cuda_kernel_is_the_launcher(name, monkeypatch):
    """The op's CUDA kernel, reached through the dispatcher with the CUDA
    key on CPU tensors, hands its arguments to the launcher and returns
    what the launcher returns."""
    qualname = f"camvid::{name}"
    for key in ("CUDA", "CPU"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qualname, key)
    module, attr = LAUNCHERS[name]
    case = next(c for c in CASES.values() if c[0] == name)
    args = case[1]
    seen = []
    multi = name in ("max_pool_2x2_argmax", "max_pool_2x2_phase")
    marker = tuple(torch.full((1,), 7.0 + i) for i in range(1 + multi))

    def launcher(*a):
        seen.append(a)
        return marker if multi else marker[0]

    monkeypatch.setattr(module, attr, launcher)
    op = getattr(torch.ops.camvid, name).default
    out = op.redispatch(torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA),
                        *args)
    assert len(seen) == 1 and seen[0][0] is args[0]
    out = out if isinstance(out, tuple) else (out,)
    assert all(torch.equal(o, m) for o, m in zip(out, marker))


# ------------------------------------------------------------ programs

def _images(n=2, seed=5):
    return np.random.default_rng(seed).integers(0, 256, (n,) + HW + (3,),
                                                dtype=np.uint8)


@pytest.fixture(scope="module", params=["unet", "segnet"])
def exported(request, tmp_path_factory):
    """A fresh f32 Predictor (it has not predicted) exports, then
    predicts; a second one from the same weights never exports."""
    net = request.param
    v = VARIABLES[net](seed=3)
    sd = state_dict_from_jax_variables(v)
    images = _images()
    path = str(tmp_path_factory.mktemp(net) / f"{net}.pt2")
    kw = dict(batch_size=2, image_hw=HW, device="cpu",
              compute_dtype=torch.float32)
    with Predictor(net, sd, **kw) as p, Predictor(net, sd, **kw) as q:
        program = p.export_program(path)
        maps = p.predict(images)
        never = q.predict(images)
        with torch.no_grad():
            logits = p.model(to_tensor_normalize(
                torch.from_numpy(images), settings.MEAN, settings.STD))
        prepared = [t for blk in p.model.blocks() for t in blk._kernel_args]
    return {"net": net, "v": v, "path": path, "program": program,
            "images": images, "maps": maps, "never": never,
            "logits": logits, "prepared": prepared}


def test_program_holds_the_ops_and_no_library_conv_or_pool(exported):
    counts = library.op_counts(exported["program"].graph)
    net = exported["net"]
    for name, n in NODES[net].items():
        assert counts[name] == n, (name, counts)
    assert not any(counts[op] for op in LIBRARY_OPS), counts
    # UNet's own 2x2 pool is the plain one (the JAX package's XLA
    # reduce_window; no TPU kernel): 4 of them, none in SegNet
    assert counts["aten::max_pool2d"] == (4 if net == "unet" else 0)
    assert os.path.getsize(exported["path"]) > 1e5


def test_export_leaves_the_predictor_as_it_was(exported):
    np.testing.assert_array_equal(exported["maps"], exported["never"])
    assert not any(isinstance(t, FakeTensor) for t in exported["prepared"])


LOADER = r"""
import sys
import numpy as np
import torch
from pytorch_camvid_tpu_torch.ops import library

def foreign():
    return sorted(m for m in sys.modules if m.split(".")[0] == "jax"
                  or m == "pytorch_camvid_tpu"
                  or m.startswith(("pytorch_camvid_tpu.",
                                   "pytorch_camvid_tpu_torch.models",
                                   "pytorch_camvid_tpu_torch.serving")))

path, images, out = sys.argv[1:4]
assert not foreign(), foreign()
program = library.load_program(path, "cpu")
with torch.inference_mode():
    maps = program(torch.from_numpy(np.load(images)))
assert not foreign(), foreign()
np.save(out, maps.numpy())
"""


def test_loaded_program_without_the_model_code_matches(exported, tmp_path):
    """The program, loaded in a process that imports only ``ops.library``,
    gives the live port Predictor's maps bit for bit, and the JAX
    Predictor's (f32, the same weights) wherever the top-2 logit gap
    exceeds 1e-3 (test_torch_unet_serving.py's rule)."""
    images = tmp_path / "images.npy"
    out = tmp_path / "maps.npy"
    np.save(images, exported["images"])
    r = subprocess.run([sys.executable, "-c", LOADER, exported["path"],
                        str(images), str(out)],
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = np.load(out)
    assert got.shape == (2,) + HW and got.dtype == np.uint8
    np.testing.assert_array_equal(got, exported["maps"])
    net, v = exported["net"], exported["v"]
    want = JaxPredictor(net, jax.tree.map(jnp.asarray, v), batch_size=2,
                        image_hw=HW, compute_dtype=jnp.float32
                        ).predict(exported["images"])
    top2 = torch.topk(exported["logits"], 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1] > 1e-3).numpy()
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got[clear], want[clear])


@pytest.mark.parametrize("predicted_first", [False, True],
                         ids=["fresh", "predicted_first"])
def test_bf16_export_keeps_the_eager_maps(predicted_first, tmp_path):
    """bf16 UNet: exporting before or after a first prediction leaves the
    Predictor's maps bit-equal to those of one that never exported, and
    the program's maps equal them."""
    sd = get_model("unet", 3, 12, width_mult=1 / 16,
                   generator=_gen(6)).state_dict()
    images = _images(seed=7)
    kw = dict(batch_size=2, image_hw=HW, device="cpu")
    with Predictor("unet", sd, **kw) as p, Predictor("unet", sd, **kw) as q:
        if predicted_first:
            p.predict(images)
        p.export_program(str(tmp_path / "u.pt2"))
        got = p.predict(images)
        want = q.predict(images)
    np.testing.assert_array_equal(got, want)
    program = library.load_program(str(tmp_path / "u.pt2"), "cpu")
    with torch.inference_mode():
        np.testing.assert_array_equal(
            program(torch.from_numpy(images)).numpy(), want)


INT8_WIDTH = {"unet": 1 / 4, "segnet": 1 / 8}
INT8_HW = (32, 48)   # SegNet pools five times


@pytest.mark.parametrize("net", ["unet", "segnet"])
def test_int8_predictor_program(net, tmp_path):
    """``quantize_int8``, then export: one int8 op node per quantized
    block, one quantize per block whose input comes float, K4 for the
    float blocks (the head), K3 on SegNet's pools; the loaded program's
    maps bit-equal to the live int8 Predictor's."""
    sd = get_model(net, 3, 12, width_mult=INT8_WIDTH[net],
                   generator=_gen(8)).state_dict()
    rng = np.random.default_rng(9)
    calib = rng.integers(0, 256, (2,) + INT8_HW + (3,), dtype=np.uint8)
    images = rng.integers(0, 256, (2,) + INT8_HW + (3,), dtype=np.uint8)
    with Predictor(net, sd, batch_size=2, image_hw=INT8_HW,
                   device="cpu") as p:
        p.quantize_int8(calib)
        qb = quant.quantized_blocks(p.model)
        fused = sum(b.s_out is not None for b in qb)
        path = str(tmp_path / f"{net}_int8.pt2")
        counts = library.op_counts(p.export_program(path).graph)
        want = p.predict(images)
        n_blocks = len(p.model.blocks())
    assert qb and fused
    assert counts["camvid::conv3x3_int8_block"] == len(qb)
    assert counts["camvid::quantize_int8"] == len(qb) - fused
    assert counts["camvid::conv3x3_bn_relu"] == n_blocks - len(qb)
    pools = 5 if net == "segnet" else 0
    assert counts["camvid::max_pool_2x2_argmax"] == pools
    assert counts["camvid::max_unpool_2x2"] == pools
    assert not any(counts[op] for op in LIBRARY_OPS), counts
    program = library.load_program(path, "cpu")
    with torch.inference_mode():
        np.testing.assert_array_equal(
            program(torch.from_numpy(images)).numpy(), want)


def test_load_program_on_a_missing_card_raises(exported):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        library.load_program(exported["path"], "cuda")
