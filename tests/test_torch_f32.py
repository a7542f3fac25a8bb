"""float32 on the card, on the CPU: the precision model of the f32 kernels
(csrc/conv3x3_f32.cu's split-TF32 product, emulated bit for bit in its
operand rounding), the f32 dW's split rule held to the source, the
wrappers' f32 routes and checks, and the f32 defaults of the port's CLIs
against the JAX package's: the train CLI with no -dtype equals its
-dtype float32 run bit for bit, and ``predict.main`` (float32 like JAX's
predict.py) equals JAX's predict.py arithmetic on the same .pth."""

import dataclasses
import functools
import importlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from pytorch_camvid_tpu.config import settings as jax_settings  # noqa
from pytorch_camvid_tpu.data.augment import make_eval_normalize  # noqa
from pytorch_camvid_tpu.interop import load_torch_checkpoint  # noqa: E402
from pytorch_camvid_tpu.models import get_model as jax_get_model  # noqa

from pytorch_camvid_tpu_torch import (f32_variants, predict,  # noqa
                                     serving)
from pytorch_camvid_tpu_torch.data import camvid  # noqa: E402
from pytorch_camvid_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_arrays)
from pytorch_camvid_tpu_torch.interop.weights import (  # noqa: E402
    state_dict_from_jax_variables)
from pytorch_camvid_tpu_torch.models import get_model  # noqa: E402
from pytorch_camvid_tpu_torch.ops import (conv_train,  # noqa: E402
                                          cuda_build, fused_conv)
from pytorch_camvid_tpu_torch.train import loop  # noqa: E402

train_cli = importlib.import_module("pytorch_camvid_tpu_torch.train.__main__")

WIDTH = 1 / 16


# ------------------------------------------------------ precision model

def tf32_rna(v: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` on an int32 view: round the magnitude to 10
    mantissa bits, ties away from zero (add half of the dropped 13 bits'
    range, then clear them)."""
    u = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split_tf32(v: np.ndarray) -> tuple:
    """v = hi + lo, both TF32 (the kernels' ``split_tf32``)."""
    hi = tf32_rna(v)
    return hi, tf32_rna(v.astype(np.float32) - hi)


def emulated_product(a: np.ndarray, b: np.ndarray,
                     single_pass: bool = False) -> np.ndarray:
    """a (M,K) @ b (K,N) as the f32 kernels form it: per k8 step the
    products of the split operands (lo*hi + hi*lo + hi*hi, or hi*hi alone
    for single-pass TF32), exact, summed and rounded to f32 (the tensor
    core's sum from zero), then added to an f32 accumulator."""
    ah, al = (t.astype(np.float64) for t in split_tf32(a))
    bh, bl = (t.astype(np.float64) for t in split_tf32(b))
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        step = ah[:, s] @ bh[s]
        if not single_pass:
            step = al[:, s] @ bh[s] + ah[:, s] @ bl[s] + step
        acc = (acc + step.astype(np.float32)).astype(np.float32)
    return acc


def rule(got, plain, ref) -> tuple:
    """(err(got), its limit) by chip_smoke's phase 14 error rule,
    ``f32_variants.error_rule``: err(t) = max|t - f64|, the limit
    max(4 err(plain f32), 2e-6 max|f64|)."""
    err, _, _, limit = f32_variants.error_rule(
        *(torch.from_numpy(np.asarray(t)) for t in (got, plain, ref)))
    return err, limit


@pytest.mark.parametrize("m,k,n", [(64, 27, 64), (32, 4608, 32),
                                   (16, 2 * 90 * 120, 16)])
def test_split_tf32_passes_the_rule_and_single_pass_fails(m, k, n):
    """At the stem's K = 9 x 3, the 512-channel blocks' K = 9 x 512 and a
    dW-sized sum over the pixels of a b2 90x120 block, the split product
    meets the error rule against float64 (the plain f32 side: torch's CPU
    matmul) and single-pass TF32 does not: the limit tells the two
    apart."""
    rng = np.random.default_rng(k)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = (rng.normal(size=(k, n)) * (2.0 / k) ** 0.5).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    plain = (torch.from_numpy(a) @ torch.from_numpy(b)).numpy()
    err, limit = rule(emulated_product(a, b), plain, ref)
    assert err <= limit, (err, limit)
    err1, _ = rule(emulated_product(a, b, single_pass=True), plain, ref)
    assert err1 > 10 * limit, (err1, limit)


def test_tf32_rounding_and_split_are_exact_where_they_should_be():
    """rna rounds half away from zero at bit 13; hi + lo reproduces an
    f32 to within its last 2 of 24 bits (the residual's own rounding)."""
    one = np.float32(1.0)
    ulp = 2.0 ** -10   # TF32's ulp at 1
    v = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                  3.0], np.float32)
    assert list(tf32_rna(v)) == [1 + ulp, -(1 + ulp), one, 3.0]
    x = np.random.default_rng(0).normal(size=10000).astype(np.float32)
    hi, lo = split_tf32(x)
    assert np.all((hi.view(np.uint32) & 0x1FFF) == 0)
    assert np.all((lo.view(np.uint32) & 0x1FFF) == 0)
    rel = np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -21


# ------------------------------------------------------ the dW's splits

def _cu_int(name: str) -> int:
    src = (cuda_build.CSRC / "conv3x3_f32.cu").read_text()
    m = re.search(rf"\b{name} == (\d+)", src) or re.search(
        rf"constexpr int [^;]*\b{name} = (\d+)", src)
    return int(m.group(1))


def test_f32_dw_split_rule():
    """Chunks of 32 pixels, 64 x 64 output tiles of (tap, Cin) rows x Cout,
    as the .cu's constants; the splits fill 4 blocks on each SM, at most
    one per chunk; 4 blocks of the dW's shared memory fit an SM."""
    assert conv_train.F32_CHUNK == _cu_int("BK") == 32
    assert conv_train.F32_TILE == _cu_int("WM") == _cu_int("WN") == 64
    assert (conv_train.F32_BLOCKS_PER_SM * (_cu_int("WG_SMEM") + 1024)
            <= conv_train.SM_SMEM)
    chunks, tiles = (conv_train.wgrad_f32_pixel_chunks,
                     conv_train.wgrad_f32_out_tiles)
    assert chunks(10, 360, 480) == 54000 and chunks(1, 2, 3) == 1
    assert chunks(2, 45, 61) == 172   # 5490 pixels, a ragged last chunk
    assert tiles(64, 64) == 9 and tiles(3, 64) == 1 and tiles(64, 12) == 9
    assert tiles(512, 512) == 72 * 8 and tiles(64, 21) == 9
    splits = conv_train.wgrad_f32_splits
    assert splits(10, 360, 480, 64, 64, 132) == 59   # ceil(528 / 9)
    assert splits(10, 360, 480, 3, 64, 132) == 528
    assert splits(10, 22, 30, 512, 512, 132) == 1
    assert splits(1, 2, 3, 64, 64, 132) == 1          # one chunk
    assert splits(10, 45, 60, 512, 256, 132) == 2     # ceil(528 / 288)


# ------------------------------------------------- routes and checks

def test_f32_routes_and_checks():
    """float32 x and w take the f32 kernels on every (Cin, Cout); mixed
    dtypes are refused; the f32 kernels take any alignment and at most
    2**31 - 128 pixels."""
    f32, bf16 = torch.float32, torch.bfloat16
    for cin, cout in ((3, 64), (64, 12), (64, 21), (512, 512)):
        assert fused_conv.route(f32, cin, cout) == "f32"
        assert conv_train.wgrad_route(f32, cin, cout) == "f32"
        assert fused_conv.route(bf16, cin, cout) == fused_conv.conv_path(
            cin, cout)
        assert conv_train.wgrad_route(bf16, cin, cout) == \
            conv_train.wgrad_path(cin, cout)
    x, w = torch.zeros(1, 4, 5, 3), torch.zeros(3, 3, 3, 8)
    a, b = torch.ones(8), torch.zeros(8)
    odd = torch.zeros(x.numel() + 1)[1:].view(x.shape)
    assert odd.data_ptr() % 16
    fused_conv._check(odd, w, a, b)              # any alignment at f32
    conv_train._check_wgrad(odd, torch.zeros(1, 4, 5, 8))
    with pytest.raises(TypeError, match="one dtype"):
        fused_conv._check(x, w.bfloat16(), a, b)
    with pytest.raises(TypeError, match="one dtype"):
        conv_train._check_wgrad(x, torch.zeros(1, 4, 5, 8).bfloat16())
    meta = [t.to("meta") for t in (w, a, b)]
    with pytest.raises(ValueError, match="pixels"):
        fused_conv._check(torch.empty(4096, 1024, 512, 3, device="meta"),
                          *meta)
    assert fused_conv.ROUTES == ("narrow", "wgmma", "packed", "f32")


def test_f32_blocks_keep_f32_through_both_models(monkeypatch):
    """At float32 every conv block of UNet and SegNet hands the kernels f32
    x and w, in eval (K4) and in a train step (K1 forward, dx, dW): nothing
    on the model paths casts to bf16."""
    seen = set()

    def spy(name, fn):
        def wrapped(*args, **kw):
            seen.update((name, t.dtype) for t in args
                        if isinstance(t, torch.Tensor)
                        and t.is_floating_point())
            return fn(*args, **kw)
        return wrapped

    from pytorch_camvid_tpu_torch.ops import conv as conv_mod
    monkeypatch.setattr(conv_mod, "conv3x3_bn_relu",
                        spy("k4", fused_conv.conv3x3_bn_relu))
    for name in ("conv3x3_fwd", "conv3x3_dgrad", "conv3x3_wgrad"):
        monkeypatch.setattr(conv_train, name,
                            spy(name, getattr(conv_train, name)))
    torch.set_num_threads(1)
    x = torch.randn(2, 36, 44, 3, generator=torch.Generator().manual_seed(0))
    for net in ("unet", "segnet"):
        model = get_model(net, 3, 12, width_mult=WIDTH,
                          generator=torch.Generator().manual_seed(1))
        model.train()(x).square().mean().backward()
        with torch.no_grad():
            model.eval()(x)
    assert {d for _, d in seen} == {torch.float32}
    assert {n for n, _ in seen} == {"k4", "conv3x3_fwd", "conv3x3_dgrad",
                                    "conv3x3_wgrad"}


# ---------------------------------------------------------- the CLIs

def _caches(root, hw=(45, 60)):
    for split, (n, seed) in {"train": (4, 1), "val": (3, 2)}.items():
        images, labels = synthetic_arrays(n, hw, seed=seed)
        camvid.write_cache(camvid.cache_path(root, split, hw[::-1]), images,
                           labels, [f"{split}{i}.png" for i in range(n)])
    return str(root)


def _leaves(path):
    z = np.load(path, allow_pickle=False)
    return {k: z[k] for k in z.files}


def test_train_cli_default_is_its_float32_run(tmp_path, monkeypatch):
    """The train CLI with no -dtype runs float32, as the JAX CLI does: its
    checkpoint equals a ``-dtype float32`` run's bit for bit (UNet at
    width 1/16, 45x60, one epoch, on the CPU), and differs from the
    ``-dtype bfloat16`` run's."""
    monkeypatch.setitem(__import__("sys").modules, "tensorflow", None)
    monkeypatch.setattr(loop, "get_model",
                        functools.partial(get_model, width_mult=WIDTH))
    torch.set_num_threads(1)
    data = _caches(tmp_path / "data")
    argv = ["-net", "unet", "-b", "2", "-e", "1", "-quiet", "-data", data,
            "-image_size", "60", "45", "-device", "cpu"]
    got = {}
    for name, extra in (("default", []), ("f32", ["-dtype", "float32"]),
                        ("bf16", ["-dtype", "bfloat16"])):
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        train_cli.main(argv + extra)
        (run,) = os.listdir(work / "checkpoints")
        (ckpt,) = os.listdir(work / "checkpoints" / run)
        got[name] = _leaves(work / "checkpoints" / run / ckpt)
    assert got["default"].keys() == got["f32"].keys()
    for k in got["f32"]:
        assert np.array_equal(got["default"][k], got["f32"][k]), k
    assert any(not np.array_equal(got["bf16"][k], got["f32"][k])
               for k in got["f32"] if k.startswith("leaf_"))


def test_predict_cli_is_jax_predict_in_f32(tmp_path, monkeypatch):
    """``predict.main`` on the CPU (float32, through the Predictor) and
    JAX's predict.py arithmetic (cv2 resize, eval normalize, the model's
    default float32 apply, argmax, nearest resize back) on the same .pth
    and image give the same class map."""
    from test_torch_unet_serving import _jax_variables
    torch.set_num_threads(1)
    hw = (45, 62)
    v = _jax_variables(3)
    pth = str(tmp_path / "unet.pth")
    torch.save(state_dict_from_jax_variables(v), pth)
    src = np.random.default_rng(4).integers(0, 256, (50, 70, 3), np.uint8)
    img = str(tmp_path / "src.png")
    cv2.imwrite(img, src)
    dtypes = []
    init = serving.Predictor.__init__

    def record(self, *args, **kw):
        dtypes.append(kw.get("compute_dtype"))
        init(self, *args, **kw)

    monkeypatch.setattr(serving.Predictor, "__init__", record)
    monkeypatch.setattr(predict, "settings", dataclasses.replace(
        predict.settings, IMAGE_SIZE=hw[::-1]))
    monkeypatch.chdir(tmp_path)
    got = predict.main(["-img", img, "-weight", pth, "-device", "cpu"])
    assert dtypes == [torch.float32]

    # JAX's predict.py, its steps on the same .pth and image
    _, apply_fn = jax_get_model("unet", 3, 12)
    variables = load_torch_checkpoint(pth, "unet",
                                      jax.tree.map(jnp.asarray, v))
    image = cv2.resize(cv2.imread(img), hw[::-1])
    x = make_eval_normalize(jax_settings.MEAN, jax_settings.STD)(
        jnp.asarray(image)[None])
    logits, _ = jax.jit(lambda v, x: apply_fn(v, x, train=False))(
        variables, x)
    want = np.asarray(jnp.argmax(logits, axis=-1))[0].astype(np.uint8)
    want = cv2.resize(want, src.shape[:2][::-1],
                      interpolation=cv2.INTER_NEAREST)
    assert got.shape == want.shape == src.shape[:2]
    assert (got == want).mean() >= 0.999


@pytest.mark.parametrize("name", sorted(f32_variants.VARIANTS))
def test_f32_variant_edits_apply_to_the_source(name):
    """Each variant f32_variants.py builds is an edit that still applies
    to the kernels' source, and changes it (but "kept")."""
    src = f32_variants._edited(f32_variants.VARIANTS[name])
    assert (src == fused_conv.F32_SOURCE.read_text()) == (name == "kept")
    assert set(f32_variants.FAULTS) < set(f32_variants.VARIANTS)


def test_f32_variants_without_a_card_fails(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert f32_variants.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
