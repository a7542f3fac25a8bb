"""The port's H-sharded conv3x3 and encoder stage (``parallel/spatial.py``)
against the JAX package's ``make_spatial_conv`` / ``make_spatial_stage``
on the CPU.

Three ranks (gloo, spawned once for the module by ``parallel/launch.py``)
each hold 16 of 48 rows, so the middle rank takes halo rows from both
neighbours and the edge ranks get the image's zero pad; the stage's two
blocks widen the halo to two rows a side. On the JAX side the same numpy
inputs run on a 3-device mesh of the 8 virtual CPU devices. The port's
convs are K4's plain version here (CPU tensors), one pad-1 conv of the
extended block per block, its two extra rows dropped."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from pytorch_camvid_tpu.ops.conv import conv_bn_relu_apply, conv_bn_relu_init
from pytorch_camvid_tpu.ops.pooling import max_pool_2x2 as jax_pool
from pytorch_camvid_tpu.parallel.mesh import DATA_AXIS, make_mesh
from pytorch_camvid_tpu.parallel.spatial import (make_spatial_conv,
                                                 make_spatial_stage)

from pytorch_camvid_tpu_torch.ops.fused_conv import conv3x3_bn_relu
from pytorch_camvid_tpu_torch.ops.pooling import max_pool_2x2
from pytorch_camvid_tpu_torch.parallel import launch, make_mesh as port_mesh
from pytorch_camvid_tpu_torch.parallel import spatial

import torch_rank_programs as programs

RANKS = 3
RNG = np.random.default_rng(1)
X = RNG.normal(size=(2, 48, 16, 8)).astype(np.float32)
W = RNG.normal(size=(3, 3, 8, 4)).astype(np.float32)


def _blocks():
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    blocks = [conv_bn_relu_init(keys[0], 8, 8),
              conv_bn_relu_init(keys[1], 8, 8)]
    rng = np.random.default_rng(2)
    params, states = [], []
    for p, s in blocks:
        params.append(jax.tree.map(np.asarray, p))
        states.append({"mean": rng.normal(size=8).astype(np.float32),
                       "var": rng.uniform(0.5, 2.0, 8).astype(np.float32)})
    return params, states


PARAMS, STATES = _blocks()


@pytest.fixture(scope="module")
def ranks():
    """Each rank's rows of the conv and of the stage."""
    return launch.spawn(programs.halo_case, RANKS, X, W, PARAMS, STATES)


def _jax_sharded(fn, args):
    mesh = make_mesh(RANKS, devices=jax.devices()[:RANKS])
    xs = jax.device_put(jnp.asarray(X), NamedSharding(mesh, P(None,
                                                              DATA_AXIS)))
    return np.asarray(fn(mesh)(*args(xs)))


def test_halo_conv_matches_jax_spatial_conv(ranks):
    got = np.concatenate([r["conv"] for r in ranks], axis=1)
    want = _jax_sharded(make_spatial_conv, lambda xs: (xs, jnp.asarray(W)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    # and the unsharded pad-1 conv of the whole image, on one rank
    one = torch.ones(4)
    whole = conv3x3_bn_relu(torch.from_numpy(X), torch.from_numpy(W), one,
                            torch.zeros(4), relu=False).numpy()
    np.testing.assert_allclose(got, whole, atol=1e-5, rtol=1e-5)


def test_halo_stage_matches_jax_spatial_stage(ranks):
    got = np.concatenate([r["stage"] for r in ranks], axis=1)
    want = _jax_sharded(make_spatial_stage,
                        lambda xs: (PARAMS, STATES, xs))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    # JAX's unsharded stage (conv + BN + ReLU twice, then the pool)
    ref = jnp.asarray(X)
    for p, s in zip(PARAMS, STATES):
        ref, _ = conv_bn_relu_apply(p, s, ref, train=False)
    np.testing.assert_allclose(got, np.asarray(jax_pool(ref)), atol=1e-4,
                               rtol=1e-4)
    # the port's unsharded stage on K4's path: within its f32 rounding
    blocks = [programs.block_from_jax(p, s) for p, s in zip(PARAMS, STATES)]
    with torch.no_grad():
        y = torch.from_numpy(X)
        for blk in blocks:
            y = blk(y)
        np.testing.assert_allclose(got, max_pool_2x2(y).numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_one_rank_has_zero_halos_and_checks_its_rows():
    """Without a process group the halos are the image's zero pad, so the
    conv is the unsharded one; odd rows cannot pool, and a rank cannot
    lend more rows than it has."""
    mesh = port_mesh()
    x = torch.from_numpy(X)
    top, bottom = spatial.exchange_rows(x[:, :2], x[:, -2:], mesh)
    assert not top.any() and not bottom.any()
    np.testing.assert_array_equal(
        spatial.shard_height(x, mesh).numpy(), X)
    with pytest.raises(ValueError, match="even"):
        spatial.encoder_stage_halo([], x[:, :47], mesh)
    with pytest.raises(ValueError, match="cannot lend"):
        spatial.halo_rows(x[:, :1], 2, mesh)
