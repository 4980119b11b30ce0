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

Beside them, torch models of csrc/triplet.cu's long schedule as it
orders its work (tile by tile, the norms from the diagonal tiles, upper
tiles mined by rows and mirrored columns, partials merged in tile order;
the backward's pick lists by a stable counting sort, walked row by row),
held against the Pallas kernel, the plain twins and jax's gradient: the
card runs the same steps, so a fault in the schedule shows here.
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
    (5, 16, 0),                                # the paper step: the cluster schedule
    (3, 256, 0),                               # its largest batch
    (1, 257, 257 * (5 * 16 + 4)),              # the smallest long batch: 5 tiles of 64
    (5, 2048, 5 * 2048 * (32 * 16 + 4)),       # 5.3 MB
    (1, 600000, 600000 * (9375 * 16 + 4)),     # 90 GB: past an 80 GB card
])
def test_scratch_bytes_are_the_long_partials(H, B, want):
    """The long forward's partials (a float2 and an int2 per head, 64-row
    tile and anchor) and its norms (a float per head and anchor) are what
    the pre-flight holds against the card's memory; csrc/triplet.cu states
    the same formula, and its backward's pick lists take less."""
    assert triplet.hard_mine_scratch_bytes(H, B) == want
    from agrl_torch.kernels.build import CSRC_DIR

    src = (CSRC_DIR / "triplet.cu").read_text()
    assert ("return B <= kShortBatch ? 0 : (long long)H * B * (16 * (long long)long_tiles(B) + 4);"
            in src)
    assert "return B <= kShortBackwardBatch ? 0 : (long long)H * (48ll * B + 4);" in src
    assert "constexpr int kMinTile = 64;" in src
    assert B <= 256 or H * (48 * B + 4) < want


# ---- models of csrc/triplet.cu's long schedule --------------------------------

def _keep(v, k, v2, k2, larger):
    """keep_max (larger) or keep_min of csrc/triplet.cu, elementwise: the
    better value, the lower index on a tie."""
    take = ((v2 > v) if larger else (v2 < v)) | ((v2 == v) & (k2 < k))
    return torch.where(take, v2, v), torch.where(take, k2, k)


def _long_forward_model(f, y, T):
    """The long forward on one head (B, D) fp32 with T-row tiles, in the
    kernels' steps: the diagonal tiles' Grams give the norms (their own
    diagonal), each upper tile (ti <= tj) turns its Gram into distances
    with them and mines its rows over its columns into slot tj and, above
    the diagonal, its columns over its rows into slot ti (a diagonal tile
    from its upper triangle, mirrored), each partial a masked max and min
    with the lowest index on ties; then the partials merge in tile order
    from the sentinels (-inf / +inf at index B)."""
    B = f.shape[0]
    nt = -(-B // T)
    tiles = [torch.arange(t * T, min(B, (t + 1) * T)) for t in range(nt)]
    sq = torch.cat([(f[t] @ f[t].T).diagonal() for t in tiles])
    big = triplet._BIG
    pv = torch.empty(2, nt, B)
    pk = torch.empty(2, nt, B, dtype=torch.int64)
    for ti in range(nt):
        for tj in range(ti, nt):
            r, c = tiles[ti], tiles[tj]
            g = f[r] @ f[c].T
            if ti == tj:
                g = torch.triu(g) + torch.triu(g, 1).T
            dist = torch.sqrt(torch.clamp(sq[r][:, None] + sq[c][None, :] - 2.0 * g, min=1e-12))
            for d, own, other, slot in [(dist, r, c, tj)] + ([(dist.T, c, r, ti)] if tj > ti else []):
                pos = y[own][:, None] == y[other][None, :]
                ap, an = torch.where(pos, d, -big), torch.where(pos, big, d)
                pv[0, slot, own], pk[0, slot, own] = ap.amax(1), other[ap.argmax(1)]
                pv[1, slot, own], pk[1, slot, own] = an.amin(1), other[an.argmin(1)]
    v_ap, v_an = torch.full((B,), -float("inf")), torch.full((B,), float("inf"))
    k_ap = k_an = torch.full((B,), B, dtype=torch.int64)
    for t in range(nt):
        v_ap, k_ap = _keep(v_ap, k_ap, pv[0, t], pk[0, t], larger=True)
        v_an, k_an = _keep(v_an, k_an, pv[1, t], pk[1, t], larger=False)
    return v_ap, v_an, k_ap, k_an


def _tied_heads(H, B, D, seed):
    """Integer features (exact Grams in any order) over P x 4 labels, a
    fifth of the rows copies of earlier rows of their own label or of
    another's: equal distances, whose picks must go to the lowest index."""
    rng = np.random.RandomState(seed)
    labels = np.repeat(np.arange(-(-B // 4)), 4)[:B]
    heads = []
    for _ in range(H):
        f = rng.randint(-2, 3, (B, D)).astype(np.float32)
        for i in rng.choice(np.arange(1, B), B // 5, replace=False):
            f[i] = f[rng.randint(i)]
        heads.append(f)
    return heads, labels


@pytest.mark.parametrize("H,B,D", [(3, 300, 64), (1, 257, 8)])
def test_long_forward_model_matches_pallas(H, B, D):
    """The long forward's schedule on tied integer features, at both tile
    sizes: values equal to agrl_tpu's Pallas kernel (interpret mode; atol
    1e-5), picks the lowest-index ones of the plain twin, each pick's
    distance the value, and both tile sizes the same outputs."""
    heads, labels = _tied_heads(H, B, D, seed=B + D)
    y = torch.from_numpy(labels)
    ties = 0
    for f in heads:
        x = torch.from_numpy(f)
        got64, got128 = (_long_forward_model(x, y, T) for T in (64, 128))
        assert all(torch.equal(a, b) for a, b in zip(got64, got128))
        pal_ap, pal_an = hard_mine_pallas(jnp.asarray(f), jnp.asarray(labels), interpret=True)
        np.testing.assert_allclose(got64[0].numpy(), np.asarray(pal_ap), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got64[1].numpy(), np.asarray(pal_an), atol=1e-5, rtol=0)
        want = triplet.hard_mine_reference(x, y)
        assert torch.equal(got64[2], want[2]) and torch.equal(got64[3], want[3])
        dist = triplet.pairwise_euclidean(x)
        rows = torch.arange(B)
        assert torch.equal(dist[rows, got64[2]], got64[0])
        assert torch.equal(dist[rows, got64[3]], got64[1])
        pos = y[:, None] == y[None, :]
        ties += int(((torch.where(pos, dist, -1.0) == got64[0][:, None]).sum(1) > 1).sum())
        ties += int(((torch.where(pos, 1e30, dist) == got64[1][:, None]).sum(1) > 1).sum())
    assert ties > 0  # the lowest-index rule was exercised


def _pick_lists_model(B, w, k):
    """The backward's pick lists for one head: w, k (2, B), the weight and
    the target row of each anchor's pick p (0 where it carries no
    gradient). Each row's entries are its gradient's terms (source row,
    weight): its own live picks first (pick 0, then 1), then every live
    pick landing on it, in (anchor, pick) order. A stable counting sort on
    the target: each row's own and incoming live picks counted, an
    exclusive scan into each row's start, then a fill in (anchor, pick)
    order. Returns (start (B + 1,), entries [(source, w)])."""
    live = [(a, p) for a in range(B) for p in (0, 1) if w[p, a] != 0]
    own, incoming = np.zeros(B, np.int64), np.zeros(B, np.int64)
    for a, p in live:
        own[a] += 1
        incoming[k[p, a]] += 1
    start = np.concatenate([[0], np.cumsum(own + incoming)])
    cursor, entries = start[:-1] + own, [None] * (2 * len(live))
    for a, p in live:
        entries[start[a] + (p == 1 and w[0, a] != 0)] = (int(k[p, a]), w[p, a])
        entries[cursor[k[p, a]]] = (a, w[p, a])
        cursor[k[p, a]] += 1
    return start, entries


def _long_backward_model(f, d, i, g):
    """The long backward on one head, row by row: its entries of the pick
    lists in order, acc += w f_src, rs += w; grad_r = rs f_r - acc. d, i,
    g: (2, B) of the forward's distances and picks and the incoming
    gradients (a row of g None: zero)."""
    B = f.shape[0]
    rows = torch.arange(B)
    w = torch.zeros(2, B, dtype=f.dtype)
    for p in (0, 1):
        if g[p] is not None:
            live = (d[p] > triplet._DIST_MIN) & (d[p] < triplet._BIG) & (i[p] != rows)
            w[p] = torch.where(live, g[p] / d[p], torch.zeros_like(d[p]))
    start, entries = _pick_lists_model(B, w.numpy(), i.numpy())
    grad = torch.empty_like(f)
    for r in range(B):
        acc, rs = torch.zeros_like(f[r]), 0.0
        for src, wt in entries[start[r]:start[r + 1]]:
            acc = acc + float(wt) * f[src]
            rs += float(wt)
        grad[r] = rs * f[r] - acc
    return grad, start, entries


@pytest.mark.parametrize("B,D,hub", [(300, 64, False), (257, 8, False), (300, 64, True)])
def test_long_backward_model_matches_the_twin_and_jax(B, D, hub):
    """The one-pass backward on continuous features (float64): each row's
    entries are its own picks, then the picks landing on it in anchor
    order, each live pick in two rows' lists; the gradient equals hard_mine_backward_reference (rtol 1e-6), with g_an
    None too, and agrl_tpu's gradient of g_ap . d_ap + g_an . d_an
    (jax.grad through pairwise_euclidean and hard_mine; atol 1e-5). `hub`:
    row 0 at the batch's centre, most anchors' hardest negative, so one
    row's list holds most entries."""
    heads, labels = _heads(1, B, D, seed=B + D, scale=0.5)
    f = heads[0].astype(np.float64)
    if hub:
        f[0] = f.mean(axis=0)
    x, y = torch.from_numpy(f), torch.from_numpy(labels).long()
    d_ap, d_an, i_ap, i_an = triplet.hard_mine_reference(x, y)
    rng = np.random.RandomState(B)
    g_ap, g_an = (torch.from_numpy(rng.rand(B)) for _ in range(2))
    d, i = torch.stack([d_ap, d_an]), torch.stack([i_ap, i_an])
    grad, start, entries = _long_backward_model(x, d, i, (g_ap, g_an))
    rows = torch.arange(B)
    live = ((d > triplet._DIST_MIN) & (d < triplet._BIG) & (i != rows)).numpy()
    assert len(entries) == 2 * live.sum()
    for r in range(B):
        mine = [int(i[p, r]) for p in (0, 1) if live[p, r]]
        srcs = [a for a, _ in entries[start[r] + len(mine):start[r + 1]]]
        assert [s for s, _ in entries[start[r]:start[r] + len(mine)]] == mine
        assert srcs == sorted(srcs) and all(r in (int(i_ap[a]), int(i_an[a])) for a in srcs)
    if hub:
        assert start[1] - start[0] > B // 2
    want = triplet.hard_mine_backward_reference([x], d_ap[None], d_an[None], i_ap[None],
                                                i_an[None], g_ap[None], g_an[None])[0]
    torch.testing.assert_close(grad, want, rtol=1e-6, atol=0)
    only_ap = _long_backward_model(x, d, i, (g_ap, None))[0]
    torch.testing.assert_close(only_ap, triplet.hard_mine_backward_reference(
        [x], d_ap[None], d_an[None], i_ap[None], i_an[None], g_ap[None], None)[0],
        rtol=1e-6, atol=0)

    def loss(v):
        ap, an = jl.hard_mine(jl.pairwise_euclidean(v), jnp.asarray(labels))
        return jnp.sum(jnp.asarray(g_ap.numpy(), jnp.float32) * ap
                       + jnp.asarray(g_an.numpy(), jnp.float32) * an)

    jax_grad = np.asarray(jax.grad(loss)(jnp.asarray(f, jnp.float32)))
    np.testing.assert_allclose(grad.numpy(), jax_grad, atol=1e-5, rtol=0)
