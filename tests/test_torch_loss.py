"""The port's cross-entropy (pytorch_camvid_tpu_torch/ops/loss.py) against
the JAX package's on labels outside [0, C) that are not ignored: JAX's
one-hot contraction gives such a label an all-zero row, so its picked logit
is 0, its nll ``logsumexp``, its weight 1, or 0 under class weights; the
port follows that rule instead of raising. Inputs come from numpy with a
fixed seed and go to both packages in f32, on the CPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pytorch_camvid_tpu.ops.loss import cross_entropy_loss as jax_loss
from pytorch_camvid_tpu_torch.ops.loss import cross_entropy_loss

C = 12


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(2, 5, 7, C)).astype(np.float32)
    labels = rng.integers(0, C, size=(2, 5, 7)).astype(np.int32)
    # out-of-range labels: the pad sentinel, a negative one, one past C
    labels[0, 0, :3] = 255
    labels[0, 1, :2] = -1
    labels[1, 2, :4] = C
    weights = rng.uniform(0.5, 2.0, size=C).astype(np.float32)
    return logits, labels, weights


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("ignore", [None, 255, (11, 255)],
                         ids=["no_ignore", "ignore_255", "ignore_11_255"])
def test_out_of_range_labels_match_jax(weighted, ignore):
    logits, labels, weights = _inputs()
    w = weights if weighted else None
    want = float(jax_loss(jnp.asarray(logits), jnp.asarray(labels),
                          None if w is None else jnp.asarray(w), ignore))
    got = cross_entropy_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels).long(),
                             None if w is None else torch.from_numpy(w),
                             ignore)
    assert got.dtype == torch.float32 and np.isfinite(want)
    # f32 on both sides; the same per-pixel terms summed in another order
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)


def test_out_of_range_rule_by_hand():
    """Without class weights every out-of-range pixel adds logsumexp to
    the sum and one to the count; with them it adds nothing."""
    logits, labels, weights = _inputs(seed=1)
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels).long()
    lse = torch.logsumexp(lt, dim=-1)
    inside = (yt >= 0) & (yt < C)
    picked = lt.gather(-1, yt.clamp(0, C - 1).unsqueeze(-1)).squeeze(-1)
    nll = torch.where(inside, lse - picked, lse)
    torch.testing.assert_close(cross_entropy_loss(lt, yt), nll.mean(),
                               rtol=1e-6, atol=0)
    wt = torch.from_numpy(weights)
    wpix = torch.where(inside, wt[yt.clamp(0, C - 1)], torch.zeros(()))
    torch.testing.assert_close(cross_entropy_loss(lt, yt, wt),
                               (nll * wpix).sum() / wpix.sum(),
                               rtol=1e-6, atol=0)
