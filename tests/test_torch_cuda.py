"""Port kernels on the card against their plain PyTorch versions.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without
one. The file imports no JAX, so it also runs where JAX is not
installed; there, skip the repo's JAX conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from agrl_torch.metrics.rerank import sparse_min_sum
from agrl_torch.ops import distmat, graph_conv, minsum, rerank, triplet

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    # the plain version's matmuls must run in full fp32 to be a reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, V, C, seed=0, relu_like=False):
    rng = np.random.RandomState(seed)
    f = rng.rand(B, V, C) * 2.0 if relu_like else rng.randn(B, V, C) * 0.1
    return dict(
        f=f.astype(np.float32),
        adj=(rng.rand(B, V, V) > 0.5).astype(np.float32),
        W=(rng.randn(C, C) * 0.01).astype(np.float32),
        scale=(rng.rand(C) + 0.5).astype(np.float32),
        bias=(rng.randn(C) * 0.1).astype(np.float32),
        mean=(rng.randn(C) * 0.1).astype(np.float32),
        var=(rng.rand(C) + 0.5).astype(np.float32),
    )


def _to(dev, arrs):
    return {k: torch.from_numpy(v).to(dev) for k, v in arrs.items()}


@pytest.mark.parametrize(
    "B,V,C,relu_like",
    [
        (16, 56, 2048, False),  # the serving path's shape
        (16, 56, 2048, True),   # ReLU-like features: large distances
        (3, 40, 2048, False),   # ragged batch and V
        (2, 64, 256, False),    # largest V of the 4-row tile
        (2, 65, 384, False),    # smallest V of the 8-row tile
        (1, 128, 128, False),   # largest V, one column tile
        (2, 1, 128, False),     # a single vertex
        (5, 17, 384, False),    # C / 32 not a multiple of 8: 4 Gram slices
    ],
)
@pytest.mark.parametrize("weight_view", [False, True])
def test_kernel_matches_plain(cuda, B, V, C, relu_like, weight_view):
    """W row-major (in, out), or the transpose view of a contiguous torch
    Linear weight, as GraphConvLayer passes it (same values)."""
    t = _to(cuda, _inputs(B, V, C, relu_like=relu_like))
    W = t["W"].t().contiguous().t() if weight_view else t["W"]
    assert W.is_contiguous() != weight_view
    args = (t["f"], t["adj"], W, t["scale"], t["bias"], t["mean"], t["var"])
    before = graph_conv.launches
    got = graph_conv.graph_propagate(*args)
    torch.cuda.synchronize()
    assert graph_conv.launches == before + 1
    want = graph_conv.graph_propagate_reference(*args)
    # fp32 both ways; only the summation order differs
    torch.testing.assert_close(got, want, atol=2e-4, rtol=0)


def test_v2_matches_plain_on_bf16_rounded_inputs(cuda):
    t = _to(cuda, _inputs(16, 56, 2048, seed=1))
    args = (t["W"], t["scale"], t["bias"], t["mean"], t["var"])
    got = graph_conv.graph_propagate_v2(t["f"], t["adj"], *args)
    want = graph_conv.graph_propagate_reference(
        graph_conv.round_bf16(t["f"]), graph_conv.round_bf16(t["adj"]), *args
    )
    torch.testing.assert_close(got, want, atol=2e-3, rtol=0)


def test_kernel_within_fp32_of_float64(cuda):
    """The 3xTF32 product keeps fp32 accuracy: within 1e-6 of max|output|
    of the float64 plain version at the serving shape (ReLU-like features,
    where fp32 itself is ~1e-7 away); one TF32 pass would be ~2e-4 away,
    and the wgmma accumulators without the kernel's per-chunk promotion
    ~3e-6."""
    t = _to(cuda, _inputs(16, 56, 2048, seed=2, relu_like=True))
    args = (t["f"], t["adj"], t["W"], t["scale"], t["bias"], t["mean"], t["var"])
    got = graph_conv.graph_propagate(*args)
    exact = graph_conv.graph_propagate_reference(*(x.double() for x in args))
    assert float((got.double() - exact).abs().max()) <= 1e-6 * float(exact.abs().max())


def _frame_mask(B, V, per_frame=7, seed=0):
    """(B, V) 0/1 vertex mask of the bucketed `all` eval: each clip's
    trailing frames (per_frame vertices each) are padding; clip 0 keeps one
    real frame, the others a seeded count."""
    rng = np.random.RandomState(seed)
    frames = V // per_frame
    real = rng.randint(1, frames + 1, size=B)
    real[0] = 1
    mask = (np.arange(V)[None, :] < real[:, None] * per_frame).astype(np.float32)
    return mask


def _masked_case(dev, B, V, C, masked, seed=0):
    """Inputs of one graph call in the `all` eval's layout: a padded
    clip's features, pose rows and columns past its real frames are 0."""
    t = _to(dev, _inputs(B, V, C, seed=seed, relu_like=True))
    mask = torch.from_numpy(_frame_mask(B, V, seed=seed)).to(dev) if masked else None
    if masked:
        t["adj"] = t["adj"] * graph_conv.pair_mask(mask)
    return (t["f"], t["adj"], t["W"], t["scale"], t["bias"], t["mean"], t["var"]), mask


@pytest.mark.parametrize(
    "B,V,masked",
    [
        (64, 56, True),    # the `all` bucket Sp = 8 at its batch of 64 tracklets
        (32, 112, True),   # Sp = 16
        (3, 129, False),   # the smallest long clip
        (3, 129, True),
        (21, 168, True),   # Sp = 24
        (9, 392, True),    # Sp = 56: clip boundaries inside the 128-row product blocks
    ],
)
def test_masked_and_long_kernel_matches_plain(cuda, B, V, masked):
    """One launch per call; within 1e-5 of max|plain| (fp32 both ways,
    another summation order; padded rows included: both sides give them
    a zero graph row)."""
    args, mask = _masked_case(cuda, B, V, 2048, masked, seed=V)
    before = graph_conv.launches
    got = graph_conv.graph_propagate(*args, vertex_mask=mask)
    torch.cuda.synchronize()
    assert graph_conv.launches == before + 1
    want = graph_conv.graph_propagate_reference(*args, vertex_mask=mask)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("mode", graph_conv.GRAPH_MODES)
@pytest.mark.parametrize("B,V,masked", [(16, 56, False), (64, 56, True), (3, 129, True),
                                        (9, 392, False)])
def test_graph_modes_match_plain(cuda, mode, B, V, masked):
    """Each graph mode (both, pose, learned) on both schedules, with
    and without a vertex mask: one launch per call, within 1e-5 of
    max|plain|."""
    args, mask = _masked_case(cuda, B, V, 2048, masked, seed=V + 1)
    before = graph_conv.launches
    got = graph_conv.graph_propagate(*args, vertex_mask=mask, mode=mode)
    torch.cuda.synchronize()
    assert graph_conv.launches == before + 1
    want = graph_conv.graph_propagate_reference(*args, vertex_mask=mask, mode=mode)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    with pytest.raises(ValueError):
        graph_conv.graph_propagate(*args, mode="dot")


def test_graph_modes_through_the_layer(cuda):
    """GraphConvLayer by flags (pose only, learned only) takes the kernel in
    its mode in eval, and its bf16 input takes K2's entry in the same mode."""
    from agrl_torch.models.layers import GraphConvLayer

    t = _to(cuda, _inputs(4, 56, 2048, seed=3, relu_like=True))
    for use_pose, learn_graph, mode in ((True, False, "pose"), (False, True, "learned")):
        layer = GraphConvLayer(2048, 2048, use_pose=use_pose, learn_graph=learn_graph)
        layer = layer.to(cuda).eval()
        before = graph_conv.launches
        with torch.no_grad():
            got = layer(t["f"], t["adj"])
            want = graph_conv.graph_propagate_reference(
                t["f"], t["adj"], layer.linear.weight.t(), layer.bn.weight, layer.bn.bias,
                layer.bn.running_mean, layer.bn.running_var, layer.gamma, mode=mode)
        assert layer.mode == mode and graph_conv.launches == before + 1
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_kernel_rejects_what_it_does_not_take(cuda):
    t = _to(cuda, _inputs(2, 56, 256))
    rest = (t["W"], t["scale"], t["bias"], t["mean"], t["var"])
    with pytest.raises(ValueError):  # a mask of the wrong shape
        graph_conv.graph_propagate(t["f"], t["adj"], *rest, vertex_mask=torch.ones(2, 55,
                                                                                   device=cuda))
    with pytest.raises(ValueError):  # C not a multiple of the column tile
        t2 = _to(cuda, _inputs(2, 56, 200))
        graph_conv.graph_propagate(*t2.values())
    with pytest.raises(ValueError):  # float64
        graph_conv.graph_propagate(t["f"].double(), t["adj"], *rest)
    with pytest.raises(ValueError):  # non-contiguous features
        graph_conv.graph_propagate(t["f"].transpose(0, 1), t["adj"], *rest)


def _triplet_batch(B, D, dev, seed=0, K=4):
    """P x K labels and features with no tied distances in a row."""
    rng = np.random.RandomState(seed)
    labels = np.repeat(np.arange(-(-B // K)), K)[:B]
    feats = rng.randn(B, D) * 0.5 + labels[:, None] * 0.05
    return (torch.from_numpy(feats.astype(np.float32)).to(dev),
            torch.from_numpy(labels.astype(np.int64)).to(dev))


@pytest.mark.parametrize("B", [4, 15, 16, 64])
def test_hard_mine_kernel_matches_plain(cuda, B):
    """Values (fp32 Gram in another summation order: atol 1e-4), the picks
    (equal on tie-free input) and the feature gradient of the soft-margin
    loss (atol 1e-5) at the train step's width D=2048."""
    f, labels = _triplet_batch(B, 2048, cuda, seed=B)
    before = triplet.launches
    d_ap, d_an, i_ap, i_an = triplet.hard_mine_kernel(f, labels)
    torch.cuda.synchronize()
    assert triplet.launches == before + 1
    w_ap, w_an, wi_ap, wi_an = triplet.hard_mine_reference(f, labels)
    torch.testing.assert_close(d_ap, w_ap, atol=1e-4, rtol=0)
    torch.testing.assert_close(d_an, w_an, atol=1e-4, rtol=0)
    assert torch.equal(i_ap, wi_ap) and torch.equal(i_an, wi_an)

    grads = []
    for fn in (triplet.hard_mine_fused, lambda x, y: triplet.hard_mine_reference(x, y)[:2]):
        x = f.clone().requires_grad_(True)
        a, n = fn(x, labels)
        torch.nn.functional.softplus(a - n).mean().backward()
        grads.append(x.grad)
    torch.testing.assert_close(grads[0], grads[1], atol=1e-5, rtol=0)


def test_hard_mine_kernel_self_distance_is_exact(cuda):
    """One label: every anchor's hardest positive may be itself only when
    all rows are equal; d2_ii is exactly 0, so d_ap is the clamp's floor
    and d_an is FLT_MAX (no negatives), as in the plain version."""
    f = torch.randn(1, 256, device=cuda).repeat(8, 1) * 10
    labels = torch.zeros(8, dtype=torch.int64, device=cuda)
    d_ap, d_an, i_ap, _ = triplet.hard_mine_kernel(f, labels)
    assert torch.all(d_ap == float(torch.sqrt(torch.tensor(1e-12))))
    assert torch.all(d_an == torch.finfo(torch.float32).max)
    assert torch.equal(i_ap, torch.zeros_like(i_ap))


def test_hard_mine_kernel_rejects_what_it_does_not_take(cuda):
    f, labels = _triplet_batch(16, 2048, cuda)
    with pytest.raises(ValueError):  # B above the kernel's maximum
        triplet.hard_mine_kernel(torch.zeros(257, 8, device=cuda),
                                 torch.zeros(257, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):  # more heads than the kernel takes
        triplet.hard_mine_heads_kernel([f] * 9, labels)
    with pytest.raises(ValueError):  # heads of different shapes
        triplet.hard_mine_heads_kernel([f, f[:, :1024].contiguous()], labels)
    with pytest.raises(ValueError):  # D not a multiple of 4
        triplet.hard_mine_kernel(f[:, :2046].contiguous(), labels)
    with pytest.raises(ValueError):  # float64
        triplet.hard_mine_kernel(f.double(), labels)
    with pytest.raises(ValueError):  # non-contiguous
        triplet.hard_mine_kernel(f[:, ::2], labels)
    with pytest.raises(ValueError):  # labels on the CPU
        triplet.hard_mine_kernel(f, labels.cpu())
    with pytest.raises(ValueError):  # labels of another length
        triplet.hard_mine_kernel(f, labels[:8])


def _heads_batch(H, B, D, dev, seed=0, K=4, scale=0.5):
    """H heads over one P x K batch: identity centres plus noise, no tied
    distances in a row, norms that do not grow with the label."""
    rng = np.random.RandomState(seed)
    labels = np.repeat(np.arange(-(-B // K)), K)[:B]
    heads = [(rng.randn(B, D) + rng.randn(labels[-1] + 1, D)[labels] * 0.3) * scale
             for _ in range(H)]
    return ([torch.from_numpy(h.astype(np.float32)).to(dev) for h in heads],
            torch.from_numpy(labels.astype(np.int64)).to(dev))


@pytest.mark.parametrize("H,B,D", [
    (5, 16, 2048),   # the train step: one chunk per block
    (1, 15, 2048),   # ragged band
    (5, 64, 2048),   # 4 bands, a 3-chunk ring
    (3, 256, 2048),  # the largest B: 16 bands, 10 chunks per block
    (2, 16, 256),    # 8 columns per block
    (2, 20, 260),    # slices of 8 and 9 float4 columns
    (2, 16, 16),     # D < 32: blocks with no columns
    (1, 16, 8192),   # the widest D: 2 chunks
    (8, 16, 2048),   # the most heads
])
def test_hard_mine_heads_kernels_match_plain(cuda, H, B, D):
    """One forward launch for all heads: values atol 1e-4, picks equal
    (tie-free input); one backward launch: the gradients of random incoming
    g_ap, g_an against the plain S-matrix backward (atol 1e-5); both
    bit-equal across two calls."""
    heads, labels = _heads_batch(H, B, D, cuda, seed=H * B + D)
    before = (triplet.launches, triplet.backward_launches)
    got = triplet.hard_mine_heads_kernel(heads, labels)
    torch.cuda.synchronize()
    assert triplet.launches == before[0] + 1
    want = triplet.hard_mine_heads_reference(heads, labels)
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=0)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    again = triplet.hard_mine_heads_kernel(heads, labels)
    assert all(torch.equal(a, b) for a, b in zip(got, again))

    gen = torch.Generator(device=cuda).manual_seed(B)
    g_ap, g_an = (torch.randn(H, B, generator=gen, device=cuda) for _ in range(2))
    grads = triplet.hard_mine_heads_backward_kernel(heads, *got, g_ap, g_an)
    torch.cuda.synchronize()
    assert triplet.backward_launches == before[1] + 1
    plain = triplet.hard_mine_backward_reference(heads, *got, g_ap, g_an)
    for a, b in zip(grads, plain):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    grads_again = triplet.hard_mine_heads_backward_kernel(heads, *got, g_ap, g_an)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_again))
    only_ap = triplet.hard_mine_heads_backward_kernel(heads, *got, g_ap, None)
    plain_ap = triplet.hard_mine_backward_reference(heads, *got, g_ap, None)
    for a, b in zip(only_ap, plain_ap):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("soft", [True, False])
def test_batch_hard_triplet_heads_one_launch_each_way(cuda, soft):
    """The multi-head loss of a train step (5 heads of (16, 2048)): one
    forward and one backward launch per call; loss and every head's
    gradient against deep_supervision over the plain mining. Entries of
    ~0.05 (distances ~3): the hinge's d_ap - d_an cancels, so larger
    distances would magnify the Grams' fp32 rounding past the loss's bar."""
    from agrl_torch import losses

    heads, labels = _heads_batch(5, 16, 2048, cuda, seed=7, scale=0.05)
    xs = [h.clone().requires_grad_(True) for h in heads]
    before = (triplet.launches, triplet.backward_launches)
    loss = losses.batch_hard_triplet_heads(xs, labels, soft=soft)
    loss.backward()
    torch.cuda.synchronize()
    assert (triplet.launches, triplet.backward_launches) == (before[0] + 1, before[1] + 1)

    def plain(f, y, margin, soft):
        d_ap, d_an = triplet.hard_mine(triplet.pairwise_euclidean(f), y)
        return losses.triplet_from_distances(d_ap, d_an, margin, soft).mean()

    ys = [h.clone().requires_grad_(True) for h in heads]
    want = losses.deep_supervision(plain, ys, labels, margin=0.3, soft=soft)
    want.backward()
    assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want))
    for x, y in zip(xs, ys):
        torch.testing.assert_close(x.grad, y.grad, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(37, 53, 100), (130, 260, 515), (8, 8, 8),
                                   (129, 257, 33), (300, 1000, 257)])
def test_min_sum_kernel_matches_plain(cuda, shape):
    """The JAX package's bar (atol 1e-4); the last two shapes cross every
    tile edge (128 rows, 16-column chunks, 32-column partial sums) with
    ragged remainders."""
    Q, J, C = shape
    rng = np.random.RandomState(Q)
    a = torch.from_numpy(rng.rand(Q, C).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.rand(J, C).astype(np.float32)).to(cuda)
    before = minsum.launches
    got = minsum.min_sum(a, b)
    torch.cuda.synchronize()
    assert minsum.launches == before + 1
    assert got.shape == (Q, J)
    torch.testing.assert_close(got, minsum.min_sum_reference(a, b), atol=1e-4, rtol=0)


def test_min_sum_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.rand(4, 16, device=cuda)
    with pytest.raises(ValueError):  # C differs
        minsum.min_sum_kernel(a, torch.rand(5, 17, device=cuda))
    with pytest.raises(ValueError):  # float64
        minsum.min_sum_kernel(a.double(), a.double())
    with pytest.raises(ValueError):  # non-contiguous
        minsum.min_sum_kernel(a[:, ::2], a[:, ::2])
    with pytest.raises(ValueError):  # b on the CPU
        minsum.min_sum_kernel(a, a.cpu())


def _sparse_operand(rng, rows, cols, density):
    return (rng.rand(rows, cols) * (rng.rand(rows, cols) < density)).astype(np.float32)


@pytest.mark.parametrize("Q,J,C,density", [
    (40, 300, 257, 0.01),
    (40, 300, 257, 0.1),
    (7, 1000, 64, 0.5),
    (3, 16384 + 300, 200, 0.05),  # J beyond one accumulation range (16,384 columns)
])
def test_min_sum_sparse_kernel_matches_plain(cuda, Q, J, C, density):
    """Random densities with empty rows and columns; fp32 sums in another
    order than the plain version's: atol 1e-5. Two calls are bit-equal
    (no atomics in the sums), and each counts one launch."""
    rng = np.random.RandomState(J + Q)
    a, b = _sparse_operand(rng, Q, C, density), _sparse_operand(rng, J, C, density)
    a[1], a[:, 3], b[5], b[:, 2] = 0, 0, 0, 0
    a, b = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    before = minsum.sparse_launches
    got = minsum.min_sum_sparse(a, b)
    torch.cuda.synchronize()
    assert minsum.sparse_launches == before + 1
    assert got.shape == (Q, J)
    assert torch.equal(got, minsum.min_sum_sparse(a, b))
    torch.testing.assert_close(got, minsum.min_sum_reference(a, b), atol=1e-5, rtol=0)


def test_min_sum_sparse_kernel_on_re_ranking_v(cuda):
    """Re-ranking's own membership matrix at N = 1,000 (Q = 200): the plain
    version within 1e-5, the host algorithm's fp32 accumulation within
    1e-6 (the kernels keep its order: ascending c), bit-equal across two
    calls."""
    rng = np.random.RandomState(11)
    centres = rng.randn(50, 128)
    feats = centres[rng.randint(0, 50, 1000)] + rng.randn(1000, 128) * 0.5
    x = torch.from_numpy(feats.astype(np.float32)).to(cuda)
    qf, gf = x[:200], x[200:]
    dists = [distmat.compute_distmat(p, g, "euclidean") for p, g in ((qf, gf), (qf, qf), (gf, gf))]
    v = rerank.expanded_membership(rerank.original_dist(*dists))
    a, b = v[:200], v
    got = minsum.min_sum_sparse(a, b)
    assert torch.equal(got, minsum.min_sum_sparse(a, b))
    torch.testing.assert_close(got, minsum.min_sum_reference(a, b), atol=1e-5, rtol=0)
    host = sparse_min_sum(a.cpu().numpy(), b.cpu().numpy())
    np.testing.assert_allclose(got.cpu().numpy(), host, atol=1e-6, rtol=0)


def test_min_sum_sparse_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.rand(4, 16, device=cuda)
    with pytest.raises(ValueError):  # CPU tensors: the kernel entry takes the card's only
        minsum.min_sum_sparse_kernel(a.cpu(), a.cpu())
    with pytest.raises(ValueError):  # b on the CPU
        minsum.min_sum_sparse_kernel(a, a.cpu())
    with pytest.raises(ValueError):  # C differs
        minsum.min_sum_sparse_kernel(a, torch.rand(5, 17, device=cuda))
    with pytest.raises(ValueError):  # float64
        minsum.min_sum_sparse_kernel(a.double(), a.double())
    with pytest.raises(ValueError):  # non-contiguous
        minsum.min_sum_sparse_kernel(a[:, ::2], a[:, ::2])
    for value in (-1e-3, float("nan")):
        bad = a.clone()
        bad[2, 3] = value
        with pytest.raises(ValueError, match="non-negative"):
            minsum.min_sum_sparse(a, bad)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_re_ranking_card_matches_cpu(cuda, metric):
    """Identity-clustered features; one sparse min-sum call per re-rank; the
    JAX package's device-vs-host bar (2e-4). The neighbour sets must not
    differ between devices: this seed leaves every gap at a set boundary
    (between ranks k - 1 and k, k = 6, 11, 21) >= 3e-6, ~30x the fp32
    distance differences between the card and the CPU."""
    rng = np.random.RandomState(7)
    centres = rng.randn(30, 256)
    qf = centres[rng.randint(0, 30, 60)] + rng.randn(60, 256) * 0.5
    gf = centres[rng.randint(0, 30, 240)] + rng.randn(240, 256) * 0.5
    qf, gf = (torch.from_numpy(x.astype(np.float32)) for x in (qf, gf))
    dists = [distmat.compute_distmat(x, y, metric) for x, y in ((qf, gf), (qf, qf), (gf, gf))]
    rows = torch.sort(rerank.original_dist(*dists), dim=1).values
    assert min(float((rows[:, k] - rows[:, k - 1]).min()) for k in (6, 11, 21)) >= 3e-6
    before = minsum.sparse_launches
    got = rerank.re_ranking_from_features(qf.to(cuda), gf.to(cuda), metric)
    torch.cuda.synchronize()
    assert minsum.sparse_launches == before + 1
    want = rerank.re_ranking_from_features(qf, gf, metric)
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("kw", [dict(return_distmat=True), dict(metric_protocol="dukev")])
def test_evaluator_host_scoring_re_ranks_on_the_card(cuda, kw, monkeypatch):
    """The distmat export and dukev score on the host, but re-rank the
    card's features on the card: one K4 launch, no host re-ranking."""
    from agrl_torch.engine import evaluator as ev
    from agrl_torch.models import build_model
    from agrl_torch.utils.avgmeter import AverageMeter

    rng = np.random.RandomState(3)
    centres = rng.randn(6, 64)
    splits = {}
    for name, n, cam in (("query", 12, 0), ("gallery", 36, 1)):
        pids = np.arange(n) % 6
        feats = torch.from_numpy((centres[pids] + 0.3 * rng.randn(n, 64)).astype(np.float32))
        splits[name] = (feats.to(cuda), pids, np.full(n, cam), AverageMeter())
    evaluator = ev.Evaluator(build_model("vmgn_tiny", num_classes=6), device=cuda)
    monkeypatch.setattr(evaluator, "extract", lambda loader, name: splits[name])

    def no_host_re_ranking(*args, **kwargs):
        raise AssertionError("the host re-ranking ran although the features are on the card")

    monkeypatch.setattr(ev, "re_ranking", no_host_re_ranking)
    before = minsum.sparse_launches
    out = evaluator.evaluate("query", "gallery", dist_metric="cosine", re_rank=True, **kw)
    assert minsum.sparse_launches == before + 1
    if kw.get("return_distmat"):
        assert isinstance(out, np.ndarray) and out.shape == (12, 36) and np.isfinite(out).all()
    else:
        assert all(0.0 <= x <= 1.0 for x in out)


def test_cli_trains_and_evaluates_through_the_kernels(cuda, tmp_path):
    """The training CLI's main on the card at vmgn_tiny, in a process of
    its own: 2 train steps (one K3 forward and one backward launch each)
    and one eval (2 K1 launches per batch of 16), and no JAX module loaded."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    argv = [
        "--root", str(tmp_path / "data"), "-d", "synthetic", "-a", "vmgn_tiny",
        "--height", "128", "--width", "64", "--seq-len", "8", "--train-batch", "16",
        "--num-instances", "4", "--train-sampler", "RandomIdentitySamplerV1",
        "--test-sample", "evenly", "--test-batch", "16", "--num-split", "4", "--pyramid-part",
        "--use-pose", "--learn-graph", "--num-gb", "2", "--consistent-loss", "--soft-margin",
        "--flip-aug", "--max-epoch", "1", "--print-freq", "1", "-j", "4",
        "--save-dir", str(tmp_path / "log"),
    ]
    code = (
        "import json, sys\n"
        "from agrl_torch.cli import train_vidreid_xent_htri as cli\n"
        "from agrl_torch.ops import graph_conv as gc, triplet as tri\n"
        f"cli.main({argv!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'agrl_tpu')]\n"
        "print(json.dumps(dict(k3=tri.launches, k3_backward=tri.backward_launches,\n"
        "                      k1=gc.launches, jax_modules=bad)))\n"
    )
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    # the synthetic catalog: 8 ids x K=4 = 32 clips (2 steps of 16); 24 query
    # and 24 gallery tracklets (2 + 2 eval batches of 16)
    assert counts == dict(k3=2, k3_backward=2, k1=8, jax_modules=[])
    assert (tmp_path / "log" / "checkpoint_ep1.pth.tar").exists()
    assert proc.stdout.count("\tXent ") == 2


def test_all_extraction_matches_the_plain_path(cuda, monkeypatch):
    """The bucketed `all` Evaluator at vmgn_tiny, 64x32, on tracklets of 3,
    12, 20 and 40 frames (buckets 8, 16, 24, 40: up to V = 280, the long
    schedule): 2 K1 launches per device batch, features within 1e-5 of
    max|plain| of the plain graph op's path, and each padded row within
    2e-4 of its tracklet's unpadded forward."""
    from agrl_torch.engine import evaluator as ev
    from agrl_torch.models import build_model
    from agrl_torch.models import layers

    rng = np.random.RandomState(0)
    batches = []
    for t, num in enumerate((3, 12, 20, 40)):
        V = num * 7
        batches.append(((rng.rand(1, num, 64, 32, 3) * 255).astype(np.uint8), np.asarray([t]),
                        np.asarray([0]), (rng.rand(1, V, V) > 0.5).astype(np.float32)))
    torch.manual_seed(0)
    evaluator = ev.Evaluator(build_model("vmgn_tiny", num_classes=4), test_sample="all",
                             clip_batch=4, device=cuda)
    before = graph_conv.launches
    got = evaluator.extract(batches, "query")[0]
    assert graph_conv.launches - before == 2 * 4  # one batch per bucket, 2 graph layers
    monkeypatch.setattr(layers, "graph_propagate", graph_conv.graph_propagate_reference)
    plain = evaluator.extract(batches, "query")[0]
    assert float((got - plain).abs().max()) <= 1e-5 * float(plain.abs().max())
    monkeypatch.undo()
    for (imgs, _, _, adj), row in zip(batches, got):
        alone = evaluator._fwd(imgs, adj)[0]
        assert float((row - alone).abs().max()) <= 2e-4


def test_graph_kernel_vertex_limit_is_the_cli_preflight_limit(cuda):
    """Neither has a vertex limit any more: past the short schedule's 128
    vertices the kernel takes its long one, so the CLI pre-flight lets any
    --seq-len through. V = 129 and V = 1064 (a 152-frame bucket) launch and
    agree with the plain twin, unmasked and masked."""
    for B, V, masked in ((2, 129, False), (3, 1064, True)):
        args, mask = _masked_case(cuda, B, V, 2048, masked, seed=B)
        before = graph_conv.launches
        got = graph_conv.graph_propagate(*args, vertex_mask=mask)
        torch.cuda.synchronize()
        assert graph_conv.launches == before + 1
        want = graph_conv.graph_propagate_reference(*args, vertex_mask=mask)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_bf16_graph_layer_inputs_take_k1_and_k2(cuda):
    """The eval graph layer on the bf16 eval's inputs: float32 vertex
    features with bf16-rounded weights, BN vectors and adjacency go to K1
    (widened, float32 math), bf16 vertex features to K2's entry; both agree
    with the plain version on the same inputs."""
    from agrl_torch.models.layers import GraphConvLayer

    layer = GraphConvLayer(2048, 2048)
    layer.init_weights(torch.Generator().manual_seed(0))
    layer = layer.to(cuda).eval()
    t = _to(cuda, _inputs(16, 56, 2048, seed=3))
    state = {k: v.to(torch.bfloat16) for k, v in layer.state_dict().items()
             if v.is_floating_point()}
    adj = t["adj"].to(torch.bfloat16)
    for x, counter in ((t["f"], "launches"), (t["f"].to(torch.bfloat16), "v2_launches")):
        before = (graph_conv.launches, graph_conv.v2_launches)
        with torch.inference_mode():
            got = torch.func.functional_call(layer, state, (x, adj))
        torch.cuda.synchronize()
        after = (graph_conv.launches, graph_conv.v2_launches)
        assert [b - a for a, b in zip(before, after)] == (
            [1, 0] if counter == "launches" else [0, 1])
        bn = {k: v.float() for k, v in state.items()}
        var = torch.rsqrt(state["bn.running_var"] + 1e-5).float().pow(-2) - 1e-5
        want = graph_conv.graph_propagate_reference(
            x.float(), adj.float(), bn["linear.weight"].t(), bn["bn.weight"], bn["bn.bias"],
            bn["bn.running_mean"], var)
        assert got.dtype == torch.float32
        # fp32 both ways, only the summation order differs (as in
        # test_kernel_matches_plain)
        torch.testing.assert_close(got, want, atol=2e-4, rtol=0)


def test_bf16_eval_forward_through_k1(cuda, monkeypatch):
    """make_eval_forward(bf16=True) of a float32-dtype VMGN (1,1,1,1) at
    128x64, S=8 on the card: 2 K1 launches per batch, no K2 launch (the
    pooled vertex features are float32, as in agrl_tpu), features within
    1e-4 of max of the plain graph op's path."""
    from agrl_torch.engine.evaluator import make_eval_forward
    from agrl_torch.models import layers
    from agrl_torch.models.vmgn import VMGN

    model = VMGN(num_classes=4, layers=(1, 1, 1, 1), dtype=torch.float32)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(cuda)
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (4, 8, 128, 64, 3)).astype(np.uint8)
    adjs = (rng.rand(4, 56, 56) > 0.5).astype(np.float32)
    fwd = make_eval_forward(model, cuda, bf16=True)
    before = (graph_conv.launches, graph_conv.v2_launches)
    got = fwd(imgs, adjs)
    torch.cuda.synchronize()
    assert (graph_conv.launches - before[0], graph_conv.v2_launches - before[1]) == (2, 0)
    monkeypatch.setattr(layers, "graph_propagate", graph_conv.graph_propagate_reference)
    plain = fwd(imgs, adjs)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert float((got - plain).abs().max()) <= 1e-4 * float(plain.abs().max())


def test_artifact_on_the_card(cuda, tmp_path):
    """An artifact exported on the card (vmgn_tiny, 128x64, S=8, batch 4,
    bf16), saved and loaded: a 6-clip request launches K1 twice per chunk
    and gives the live forward's features within 1e-5 of max (TF32 off on
    both paths)."""
    from agrl_torch.engine.export import (
        FeatureExtractor,
        export_eval_forward,
        load_exported,
        save_exported,
    )
    from agrl_torch.models import init_model

    model = init_model("vmgn_tiny", num_classes=4, device=cuda, seed=1)
    path = str(tmp_path / "vmgn_tiny_eval.pt2")
    save_exported(path, export_eval_forward(model, model.state_dict(), 4, 8, 128, 64,
                                            device=cuda))
    fx = FeatureExtractor.from_exported(load_exported(path), model.state_dict())
    assert fx.device.type == "cuda"
    rng = np.random.RandomState(1)
    imgs = rng.randint(0, 256, (6, 8, 128, 64, 3)).astype(np.uint8)
    before = graph_conv.launches
    got = fx(imgs)
    assert graph_conv.launches - before == 2 * 2
    want = FeatureExtractor(model, batch_size=4, seq_len=8, device=cuda)(imgs)
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())


def test_bf16_train_step_on_the_card(cuda):
    """One --bf16-train step at VMGN (1,1,1,1), 128x64, S=8, 16 clips with
    the consistent loss: one K3 forward and one backward launch, a finite
    loss, float32 parameters and gradients."""
    from agrl_torch.engine.trainer import make_train_step
    from agrl_torch.models.vmgn import VMGN
    from agrl_torch.optim import init_optim

    model = VMGN(num_classes=4, layers=(1, 1, 1, 1), consistent_loss=True,
                 dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(cuda)
    opt = init_optim("adam", model.parameters(), 1e-4, weight_decay=5e-4)
    step = make_train_step(model, opt, lambda s: 1e-4, aug={"flip_aug": True})
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (16, 8, 128, 64, 3)).astype(np.uint8)
    adjs = (rng.rand(16, 56, 56) > 0.5).astype(np.float32)
    before = (triplet.launches, triplet.backward_launches)
    metrics = step(imgs, np.repeat(np.arange(4), 4), adjs, generator=torch.Generator())
    torch.cuda.synchronize()
    assert (triplet.launches - before[0], triplet.backward_launches - before[1]) == (1, 1)
    assert np.isfinite(float(metrics["loss"]))
    assert all(p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
               for p in model.parameters())


@pytest.mark.parametrize("optim,remat", [("adam", "none"), ("amsgrad", "dots"), ("sgd", "full"),
                                         ("nesterov", "none"), ("rmsprop", "dots"),
                                         ("adabound", "full"), ("radam", "dots")])
def test_train_surface_on_the_card(cuda, optim, remat):
    """Two steps at VMGN (1,1,1,1), 128x64, S=8, 16 clips with the
    consistent loss and every augmentation, under each optimizer and a
    remat policy: one K3 forward and one backward launch a step, finite
    losses, parameters that moved, and the running statistics updated
    once a step."""
    from agrl_torch.engine.trainer import make_train_step
    from agrl_torch.models.vmgn import VMGN
    from agrl_torch.optim import init_optim

    model = VMGN(num_classes=4, layers=(1, 1, 1, 1), consistent_loss=True)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(cuda)
    before_w = model.conv1.weight.detach().clone()
    opt = init_optim(optim, model.parameters(), 1e-4, weight_decay=5e-4)
    aug = dict(flip_aug=True, rand_erase=True, misalign_aug=True, rand_translate=True)
    step = make_train_step(model, opt, lambda s: 1e-4, aug=aug, remat=remat)
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (16, 8, 128, 64, 3)).astype(np.uint8)
    adjs = (rng.rand(16, 56, 56) > 0.5).astype(np.float32)
    gen = torch.Generator().manual_seed(1)
    before = (triplet.launches, triplet.backward_launches)
    losses = [float(step(imgs, np.repeat(np.arange(4), 4), adjs, generator=gen)["loss"])
              for _ in range(2)]
    assert (triplet.launches - before[0], triplet.backward_launches - before[1]) == (2, 2)
    assert all(np.isfinite(losses))
    assert not torch.equal(model.conv1.weight, before_w)
    assert int(model.bn1.num_batches_tracked) == 2
