"""The port's batch-hard mining (K3's plain version and the backward the
kernel path uses) held against agrl_tpu's Pallas kernel (interpret mode)
and its jnp twin, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrl_torch.ops import triplet
from agrl_tpu.losses import hard_mine as jax_hard_mine
from agrl_tpu.losses import pairwise_euclidean as jax_pairwise
from agrl_tpu.ops.triplet import hard_mine_pallas

D = 2048


def _batch(B, seed=0, K=4):
    """P x K labels (a ragged B cuts the last identity short) and features
    spread enough that no two distances of a row tie."""
    rng = np.random.RandomState(seed)
    labels = np.repeat(np.arange(-(-B // K)), K)[:B].astype(np.int32)
    feats = (rng.randn(B, D) * 0.5 + labels[:, None] * 0.05).astype(np.float32)
    return feats, labels


def _jax_mine(feats, labels):
    dist = jax_pairwise(jnp.asarray(feats))
    d_ap, d_an = jax_hard_mine(dist, jnp.asarray(labels))
    return np.asarray(dist), np.asarray(d_ap), np.asarray(d_an)


@pytest.mark.parametrize("B", [16, 15])
def test_plain_mining_matches_pallas_and_jnp(B):
    feats, labels = _batch(B)
    got_ap, got_an = triplet.hard_mine_fused(torch.from_numpy(feats), torch.from_numpy(labels))
    pal_ap, pal_an = hard_mine_pallas(jnp.asarray(feats), jnp.asarray(labels), interpret=True)
    _, want_ap, want_an = _jax_mine(feats, labels)
    for got, want in ((got_ap, pal_ap), (got_an, pal_an), (got_ap, want_ap), (got_an, want_an)):
        # fp32 both ways: only the Gram's summation order differs
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("B", [16, 15])
def test_plain_picks_match_jnp_argmax(B):
    feats, labels = _batch(B, seed=1)
    d_ap, d_an, i_ap, i_an = triplet.hard_mine_reference(
        torch.from_numpy(feats), torch.from_numpy(labels)
    )
    dist, _, _ = _jax_mine(feats, labels)
    pos = labels[:, None] == labels[None, :]
    np.testing.assert_array_equal(i_ap.numpy(), np.where(pos, dist, -np.inf).argmax(1))
    np.testing.assert_array_equal(i_an.numpy(), np.where(pos, np.inf, dist).argmin(1))
    rows = np.arange(B)
    np.testing.assert_allclose(d_ap.numpy(), dist[rows, i_ap.numpy()], atol=1e-4)
    np.testing.assert_allclose(d_an.numpy(), dist[rows, i_an.numpy()], atol=1e-4)


def _jax_soft_grad(feats, labels):
    def loss(f):
        d_ap, d_an = jax_hard_mine(jax_pairwise(f), jnp.asarray(labels))
        return jax.nn.softplus(d_ap - d_an).mean()

    return np.asarray(jax.grad(loss)(jnp.asarray(feats)))


def _heads_path(f, labels):
    """The kernel path's autograd.Function with H = 1, its plain twins
    injected for the two kernels."""
    d_ap, d_an = triplet._HardMineHeads.apply(
        labels, triplet.hard_mine_heads_reference, triplet.hard_mine_backward_reference, f)
    return d_ap[0], d_an[0]


@pytest.mark.parametrize("path", ["plain", "kernel_backward"])
def test_feature_gradient_matches_jax(path):
    """The plain path's autograd, and the kernel path's hand-written
    backward fed by the plain picks, against jax.grad (tie-free input)."""
    feats, labels = _batch(16, seed=2)
    f = torch.from_numpy(feats).requires_grad_(True)
    lab = torch.from_numpy(labels)
    if path == "plain":
        d_ap, d_an = triplet.hard_mine_fused(f, lab)
    else:
        d_ap, d_an = _heads_path(f, lab)
    torch.nn.functional.softplus(d_ap - d_an).mean().backward()
    np.testing.assert_allclose(f.grad.numpy(), _jax_soft_grad(feats, labels), atol=1e-5, rtol=0)


def test_tied_duplicates_give_the_same_parameter_gradient():
    """Rows 1 and 2 are the same clip, so anchor 0's hardest positive
    ties. JAX (and the plain path's amax) split the gradient between the
    twins; the kernel path gives it all to the lower index. The gradient
    of a parameter that maps inputs to features is the same."""
    rng = np.random.RandomState(3)
    x = rng.randn(8, 64).astype(np.float32)
    x[2] = x[1]
    x[3] = x[0] + 0.01 * x[3]  # anchor 0's farthest positive is a twin
    labels = np.repeat(np.arange(2), 4).astype(np.int32)
    w = (rng.randn(64, 256) * 0.1).astype(np.float32)

    def torch_grad(mine):
        wt = torch.from_numpy(w).requires_grad_(True)
        f = torch.from_numpy(x) @ wt
        d_ap, d_an = mine(f, torch.from_numpy(labels))
        torch.nn.functional.softplus(d_ap - d_an).mean().backward()
        return wt.grad.numpy()

    def jax_loss(wj):
        d_ap, d_an = jax_hard_mine(jax_pairwise(jnp.asarray(x) @ wj), jnp.asarray(labels))
        return jax.nn.softplus(d_ap - d_an).mean()

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(w)))
    _, _, i_ap, _ = triplet.hard_mine_reference(
        torch.from_numpy(x @ w), torch.from_numpy(labels)
    )
    assert int(i_ap[0]) in (1, 2)  # a tie the picks resolve to one twin
    for mine in (triplet.hard_mine_fused, _heads_path):
        np.testing.assert_allclose(torch_grad(mine), want, atol=1e-5, rtol=0)


def test_anchor_without_negative_carries_no_gradient():
    feats = np.random.RandomState(4).randn(4, 8).astype(np.float32)
    f = torch.from_numpy(feats).requires_grad_(True)
    lab = torch.zeros(4, dtype=torch.int32)
    d_ap, d_an = _heads_path(f, lab)
    assert torch.all(d_an == torch.finfo(torch.float32).max)
    d_an.sum().backward()
    assert torch.all(f.grad == 0)


def test_hard_mine_fused_refuses_other_devices():
    with pytest.raises(ValueError):
        triplet.hard_mine_fused(torch.zeros(4, 8, device="meta"), torch.zeros(4, device="meta"))
