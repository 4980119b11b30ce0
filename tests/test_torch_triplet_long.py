"""K3 past the cluster schedule's limits (a long batch, many heads, a wide
or ragged width) held against agrl_tpu on the same numpy inputs: the
port's multi-head loss (its plain twins on CPU tensors, and the kernel
path's structure, `_HardMineHeads` with the plain forward and backward
twins) against jax.value_and_grad of deep_supervision(batch_hard_triplet,
...), and the plain forward twin against the Pallas kernel in interpret
mode at a batch above 256.

The shapes: a long batch (5, 300, 64), msppgn's 94 heads at --num-split 16
(94, 16, 32; narrow), ganet's 10240-d heads at --num-gb 4 (2, 16, 10240)
and the smallest long batch at a width that is no multiple of 4 (1, 257,
6). agrl_tpu's deep_supervision is a mean over heads: one jitted
value_and_grad of one head's batch_hard_triplet serves every head of a
shape, the loss the heads' mean in deep_supervision's order and each
gradient its head's over H.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrl_torch import losses as tl
from agrl_torch.ops import triplet
from agrl_tpu import losses as jl
from agrl_tpu.ops.triplet import hard_mine_pallas

SHAPES = [(5, 300, 64), (94, 16, 32), (2, 16, 10240), (1, 257, 6)]


def _heads(H, B, D, seed, K=4, scale=0.05):
    """H heads over one P x K batch (a ragged B cuts the last identity
    short): identity centres plus noise, norms that do not grow with the
    label (the quadratic form cancels the norms, so norms far above the
    distances would magnify the Gram's fp32 rounding); entries of ~0.05,
    the scale of tests/test_torch_triplet_heads.py, where the loss is
    held (the hinge's d_ap - d_an cancels too)."""
    rng = np.random.RandomState(seed)
    labels = np.repeat(np.arange(-(-B // K)), K)[:B].astype(np.int32)
    heads = [((rng.randn(B, D) + rng.randn(labels[-1] + 1, D)[labels] * 0.3) * scale)
             .astype(np.float32) for _ in range(H)]
    return heads, labels


@partial(jax.jit, static_argnames=("soft",))
def _jax_head(x, y, soft):
    return jax.value_and_grad(lambda f: jl.batch_hard_triplet(f, y, 0.3, soft=soft))(x)


def _jax_loss_and_grads(heads, labels, soft):
    """deep_supervision(batch_hard_triplet, heads, labels) and its gradient
    in every head, one compile a shape."""
    y = jnp.asarray(labels)
    total, grads = 0.0, []
    for h in heads:
        value, grad = _jax_head(jnp.asarray(h), y, soft)
        total = total + value
        grads.append(np.asarray(grad) / len(heads))
    return float(total / len(heads)), grads


def _twins(heads, labels):
    """The kernel path's structure with the plain twins in the kernels' place."""
    return triplet._HardMineHeads.apply(
        labels, triplet.hard_mine_heads_reference, triplet.hard_mine_backward_reference, *heads)


@pytest.mark.parametrize("soft", [True, False])
@pytest.mark.parametrize("H,B,D", SHAPES)
def test_multi_head_loss_matches_agrl_tpu(H, B, D, soft):
    """batch_hard_triplet_heads on CPU tensors (deep_supervision over the
    plain mining) and the kernel path's structure with the plain twins:
    the loss within rtol 1e-5 of agrl_tpu's, every head's gradient within
    atol 1e-5."""
    heads, labels = _heads(H, B, D, seed=H + B + D)
    want_loss, want_grads = _jax_loss_and_grads(heads, labels, soft)
    y = torch.from_numpy(labels).long()
    for loss_of in (lambda xs: tl.batch_hard_triplet_heads(xs, y, soft=soft),
                    lambda xs: tl.mean_over_heads(tl.triplet_from_distances(
                        *_twins(xs, y), soft=soft))):
        xs = [torch.from_numpy(h).requires_grad_(True) for h in heads]
        loss = loss_of(xs)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5, atol=0)
        for x, want in zip(xs, want_grads):
            np.testing.assert_allclose(x.grad.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("D", [64, 6])
def test_heads_reference_matches_pallas_at_a_long_batch(D):
    """The plain forward twin at B = 300 (past the cluster schedule) against
    agrl_tpu's Pallas kernel in interpret mode, per head: d_ap and d_an
    within atol 1e-5."""
    H, B = 3, 300
    heads, labels = _heads(H, B, D, seed=D, scale=0.5)
    d_ap, d_an, _, _ = triplet.hard_mine_heads_reference(
        [torch.from_numpy(h) for h in heads], torch.from_numpy(labels).long())
    assert d_ap.shape == d_an.shape == (H, B)
    for h, f in enumerate(heads):
        pal_ap, pal_an = hard_mine_pallas(jnp.asarray(f), jnp.asarray(labels), interpret=True)
        np.testing.assert_allclose(d_ap[h].numpy(), np.asarray(pal_ap), atol=1e-5, rtol=0)
        np.testing.assert_allclose(d_an[h].numpy(), np.asarray(pal_an), atol=1e-5, rtol=0)


@pytest.mark.parametrize("H,B,D", SHAPES)
def test_backward_twin_is_the_plain_autograd(H, B, D):
    """The backward twin (what the long backward kernel is held against on
    the card) against autograd through the plain mining, for random
    incoming gradients on every head: atol 1e-5 and 1e-5 of max."""
    heads, labels = _heads(H, B, D, seed=7 * H + B + D, scale=0.5)
    rng = np.random.RandomState(B)
    g_ap, g_an = (torch.from_numpy(rng.rand(H, B).astype(np.float32)) for _ in range(2))
    y = torch.from_numpy(labels).long()
    xs = [torch.from_numpy(h).requires_grad_(True) for h in heads]
    d_ap, d_an = (torch.stack(d) for d in zip(*(
        triplet.hard_mine(triplet.pairwise_euclidean(x), y) for x in xs)))
    want = torch.autograd.grad([d_ap, d_an], xs, [g_ap, g_an])
    fs = [torch.from_numpy(h) for h in heads]
    got = triplet.hard_mine_backward_reference(
        fs, *triplet.hard_mine_heads_reference(fs, y), g_ap, g_an)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("H,B,D", SHAPES)
def test_kernel_wrappers_take_any_shape_up_to_the_device_check(H, B, D):
    """Each shape passes every check of both kernel wrappers and stops at
    the device check on CPU tensors: nothing refuses a long batch, many
    heads or any width."""
    fs = [torch.zeros(B, D) for _ in range(H)]
    y = torch.zeros(B, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        triplet.hard_mine_heads_kernel(fs, y)
    ids = torch.zeros(H, B, dtype=torch.int64)
    dist = torch.ones(H, B)
    with pytest.raises(ValueError, match="CUDA tensors"):
        triplet.hard_mine_heads_backward_kernel(fs, dist, dist, ids, ids, dist, dist)


@pytest.mark.parametrize("D", [6, 1030])
def test_zero_columns_change_no_distance(D):
    """The kernel wrappers pad D to a multiple of 4 with zero columns
    (`_padded`): on the padded heads the plain twins give the same picks
    and distances (within 1e-6 of max: the padded product may sum in
    another order), the gradient's first D columns are the unpadded one's
    (1e-6 of max) and its pad columns exactly 0."""
    heads, labels = _heads(2, 300, D, seed=D, scale=0.5)
    fs = [torch.from_numpy(h) for h in heads]
    padded = triplet._padded(fs, D)
    assert all(p.shape == (300, D + (-D % 4)) and torch.equal(p[:, :D], f)
               for p, f in zip(padded, fs))
    y = torch.from_numpy(labels).long()
    got, want = (triplet.hard_mine_heads_reference(x, y) for x in (padded, fs))
    for k in (0, 1):
        assert float((got[k] - want[k]).abs().max()) <= 1e-6 * float(want[k].abs().max())
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    g = torch.from_numpy(np.random.RandomState(D).rand(2, 300).astype(np.float32))
    for a, b in zip(triplet.hard_mine_backward_reference(padded, *want, g, g),
                    triplet.hard_mine_backward_reference(fs, *want, g, g)):
        assert float((a[:, :D] - b).abs().max()) <= 1e-6 * float(b.abs().max())
        assert torch.all(a[:, D:] == 0)


@pytest.mark.parametrize("H,B,want", [
    (5, 16, 0),                           # the paper step: the cluster schedule
    (3, 256, 0),                          # its largest batch
    (1, 257, 5 * 257 * 16),               # the smallest long batch: 5 tiles of 64
    (5, 2048, 5 * 32 * 2048 * 16),        # 5.2 MB
    (1, 600000, 9375 * 600000 * 16),      # 90 GB: past an 80 GB card
])
def test_scratch_bytes_are_the_long_partials(H, B, want):
    """The long forward's partials (a float2 and an int2 per head, 64-column
    tile and anchor) are what the pre-flight holds against the card's
    memory; csrc/triplet.cu states the same formula."""
    assert triplet.hard_mine_scratch_bytes(H, B) == want
    from agrl_torch.kernels.build import CSRC_DIR

    src = (CSRC_DIR / "triplet.cu").read_text()
    assert "return B <= kShortBatch ? 0 : (long long)H * long_tiles(B) * B * 16;" in src
    assert "constexpr int kMinTile = 64;" in src
