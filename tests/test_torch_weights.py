"""Weight interchange of the PyTorch port: JAX variables <-> the port's
state_dict, reference-named .pth loading, and the checkpoint formats the
port does not read yet."""

import numpy as np
import jax
import pytest
import torch

from pytorch_camvid_tpu.interop import (state_dict_from_variables,
                                        variables_from_state_dict)
from pytorch_camvid_tpu_torch.interop.weights import (
    state_dict_from_jax_variables)
from pytorch_camvid_tpu_torch.models.unet import UNet, scaled_spec
from pytorch_camvid_tpu_torch.serving import Predictor

WIDTH = 1 / 8


def _variables(seed=0):
    rng = np.random.default_rng(seed)
    params, state = {}, {}
    for stage, pairs in scaled_spec(3, 12, WIDTH):
        params[stage] = [{"w": rng.normal(size=(3, 3, ci, co)),
                          "b": rng.normal(size=co),
                          "scale": rng.normal(size=co),
                          "bias": rng.normal(size=co)} for ci, co in pairs]
        state[stage] = [{"mean": rng.normal(size=co),
                         "var": rng.uniform(0.5, 2, co)} for _, co in pairs]
    return jax.tree.map(lambda a: a.astype(np.float32),
                        {"params": params, "state": state})


def test_jax_variables_roundtrip_through_strict_load():
    v = _variables()
    sd = state_dict_from_jax_variables(v)
    model = UNet(3, 12, width_mult=WIDTH)
    model.load_state_dict(sd, strict=True)
    # the same names, shapes and values as the JAX package's own export
    ref = state_dict_from_variables("unet", v)
    assert set(sd) == set(ref) == set(model.state_dict())
    for k, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), ref[k], err_msg=k)
    # and back through the JAX package's importer: the exact pytree
    back = variables_from_state_dict("unet", model.state_dict(), v)
    for a, b in zip(jax.tree.leaves(v), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_reference_pth_loads_through_predictor(tmp_path):
    """A reference-style checkpoint (torch.save of a state_dict with the
    reference's names) loads; the width is read from its shapes."""
    v = _variables(seed=1)
    ref = state_dict_from_variables("unet", v)
    path = str(tmp_path / "unet.pth")
    torch.save({k: torch.from_numpy(np.array(a)) for k, a in ref.items()},
               path)
    with Predictor.from_checkpoint("unet", path, batch_size=2,
                                   image_hw=(16, 24), device="cpu",
                                   compute_dtype=torch.float32) as p:
        for k, t in p.model.state_dict().items():
            np.testing.assert_array_equal(t.numpy(), ref[k], err_msg=k)
        out = p.predict(np.zeros((1, 16, 24, 3), np.uint8))
    assert out.shape == (1, 16, 24)


def test_native_checkpoint_is_not_read_yet(tmp_path):
    """``.ckpt.npz`` files are read now (tests/test_torch_checkpoint.py);
    one that holds no checkpoint payload of either package is refused."""
    path = str(tmp_path / "1-regular.ckpt.npz")
    np.savez(path, x=np.zeros(1))
    with pytest.raises(ValueError, match="not a checkpoint"):
        Predictor.from_checkpoint("unet", path, device="cpu")
