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
        (3, 1064, True),   # Sp = 152
        (1, 2128, True),   # Sp = 304
        (2, 130, False),   # V % 4 != 0: G and h^T rows padded to a 16-byte stride
        (2, 131, True),
        (1, 257, True),
        (2, 1063, True),
    ],
)
def test_masked_and_long_kernel_matches_plain(cuda, B, V, masked):
    """One launch per call; within 1e-5 of max|plain| (fp32 both ways,
    another summation order; padded rows included: both sides give them
    a zero graph row). The long schedule's scratch rows are V rounded up
    to 4 floats; the columns past V are never read."""
    args, mask = _masked_case(cuda, B, V, 2048, masked, seed=V)
    before = graph_conv.launches
    got = graph_conv.graph_propagate(*args, vertex_mask=mask)
    torch.cuda.synchronize()
    assert graph_conv.launches == before + 1
    want = graph_conv.graph_propagate_reference(*args, vertex_mask=mask)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _long_call(args, mask, **kw):
    """One K1 call (one launch) and its plain twin's output."""
    before = graph_conv.launches
    got = graph_conv.graph_propagate(*args, vertex_mask=mask, **kw)
    torch.cuda.synchronize()
    assert graph_conv.launches == before + 1
    return got, graph_conv.graph_propagate_reference(*args, vertex_mask=mask, **kw)


def _near_duplicate_case(dev, B, V, C, seed):
    """The `all` eval's masked layout with video-like features: each of a
    frame's 7 parts is its clip's part base (ReLU-like) plus 1e-3-scale
    noise, so every vertex has near-duplicates at distance ~0.06 in the
    other frames, where the affinity is sharpest and the Gram cancels
    (|f|^2 ~ 2700)."""
    rng = np.random.RandomState(seed)
    base = rng.rand(B, 1, 7, C) * 2.0
    f = (base + rng.randn(B, V // 7, 7, C) * 1e-3).reshape(B, V, C).astype(np.float32)
    args, mask = _masked_case(dev, B, V, C, True, seed=seed)
    return (torch.from_numpy(f).to(dev), *args[1:]), mask


@pytest.mark.parametrize("B,V", [(9, 392), (1, 2128)])
def test_long_kernel_near_duplicate_vertices(cuda, B, V):
    """Near-duplicate vertices (consecutive frames) on the long schedule:
    the 3xTF32 Gram keeps the plain twin's fp32 arithmetic's outcome,
    within 1e-5 of max|plain| (both fp32, another summation order)."""
    args, mask = _near_duplicate_case(cuda, B, V, 2048, seed=V + 11)
    got, want = _long_call(args, mask)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("mask_diag,additive", [(True, True), (True, False), (False, True)])
def test_long_ganet_flags_match_plain(cuda, mask_diag, additive):
    """ganet's flags, alone and together, on the long schedule (masked
    (9, 392), gamma 0.3): within 1e-5 of max|plain|."""
    args, mask = _masked_case(cuda, 9, 392, 2048, True, seed=23)
    got, want = _long_call((*args, 0.3), mask, mask_diag=mask_diag, additive=additive)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_long_kernel_within_fp32_of_float64(cuda):
    """The long schedule's three 3xTF32 products keep fp32 accuracy: at
    the masked (3, 392) packing the kernel lies no further from the float64
    plain version than twice the fp32 plain twin does."""
    args, mask = _masked_case(cuda, 3, 392, 2048, True, seed=5)
    got, want = _long_call(args, mask)
    exact = graph_conv.graph_propagate_reference(*(x.double() for x in args),
                                                 vertex_mask=mask.double())
    kernel_err = float((got.double() - exact).abs().max())
    plain_err = float((want.double() - exact).abs().max())
    assert kernel_err <= 2.0 * plain_err


@pytest.mark.parametrize("mode", graph_conv.GRAPH_MODES)
@pytest.mark.parametrize("B,V,masked", [(16, 56, False), (64, 56, True), (3, 129, True),
                                        (9, 392, False), (3, 1064, True)])
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
    big = triplet.MAX_BATCH + 1
    with pytest.raises(ValueError):  # B above the kernel's maximum (its grid's)
        triplet.hard_mine_kernel(torch.zeros(big, 4, device=cuda),
                                 torch.zeros(big, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):  # more heads than the kernel takes
        triplet.hard_mine_heads_kernel([f] * (triplet.MAX_HEADS + 1), labels)
    with pytest.raises(ValueError):  # heads of different shapes
        triplet.hard_mine_heads_kernel([f, f[:, :1024].contiguous()], labels)
    with pytest.raises(ValueError):  # no columns
        triplet.hard_mine_kernel(f[:, :0].contiguous(), labels)
    with pytest.raises(ValueError):  # float64
        triplet.hard_mine_kernel(f.double(), labels)
    with pytest.raises(ValueError):  # non-contiguous
        triplet.hard_mine_kernel(f[:, ::2], labels)
    with pytest.raises(ValueError):  # labels on the CPU
        triplet.hard_mine_kernel(f, labels.cpu())
    with pytest.raises(ValueError):  # labels of another length
        triplet.hard_mine_kernel(f, labels[:8])


def _heads_batch(H, B, D, dev, seed=0, K=4, scale=0.5, integer=False):
    """H heads over one P x K batch: identity centres plus noise, no tied
    distances in a row, norms that do not grow with the label. `integer`:
    small integers (centres in [-1, 1] plus noise in [-3, 3]), whose Grams
    every summation order gives exactly, so tied distances tie exactly and
    go to the lowest index in the kernel and its plain twin alike (a long
    batch of continuous features holds near-ties closer than fp32's
    rounding of one order against another)."""
    rng = np.random.RandomState(seed)
    labels = np.repeat(np.arange(-(-B // K)), K)[:B]
    if integer:
        heads = [rng.randint(-3, 4, (B, D)) + rng.randint(-1, 2, (labels[-1] + 1, D))[labels]
                 for _ in range(H)]
    else:
        heads = [(rng.randn(B, D) + rng.randn(labels[-1] + 1, D)[labels] * 0.3) * scale
                 for _ in range(H)]
    return ([torch.from_numpy(h.astype(np.float32)).to(dev) for h in heads],
            torch.from_numpy(labels.astype(np.int64)).to(dev))


@pytest.mark.parametrize("H,B,D", [
    (5, 16, 2048),   # the train step: one chunk per block
    (1, 15, 2048),   # ragged band
    (5, 64, 2048),   # 4 bands, a 3-chunk ring
    (5, 96, 2048),   # the S-matrix backward's largest B
    (5, 97, 260),    # the pick-based backward's smallest, D padded
    (3, 256, 2048),  # the cluster schedule's largest B: 16 bands, 10 chunks a block
    (2, 16, 256),    # 8 columns per block
    (2, 20, 260),    # slices of 8 and 9 float4 columns
    (2, 16, 16),     # D < 32: blocks with no columns
    (1, 16, 8192),   # a wide D: 2 chunks
    (8, 16, 2048),   # eight heads
])
def test_hard_mine_heads_kernels_match_plain(cuda, H, B, D, integer=False):
    """One forward launch for all heads: values atol 1e-4, picks equal
    (tie-free input); one backward launch: the gradients of random incoming
    g_ap, g_an against the plain S-matrix backward (atol 1e-5); both
    bit-equal across two calls."""
    heads, labels = _heads_batch(H, B, D, cuda, seed=H * B + D, integer=integer)
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


# the long schedule (B > 256), many heads, wide and ragged D: chip_smoke.py
# phases 8 and 25's shapes and their edges
LONG_SHAPES = [
    (1, 257, 64),      # the smallest long batch: 64-row tiles, one of them ragged
    (3, 300, 1030),    # D padded to 1032 (zero columns), ragged 64-row tiles
    (5, 320, 2048),    # VMGN at --train-batch 320
    (5, 2048, 2048),   # 128-row tiles, a segment of 2048 anchors
    (1, 4096, 2048),   # two segments of the backward's scan
    (94, 16, 1536),    # msppgn at --num-split 16: the device head table
    (2, 16, 10240),    # ganet at --num-gb 4: D past 8192
    (2, 16, 1030),     # the cluster schedule with D padded
]


@pytest.mark.parametrize("H,B,D", LONG_SHAPES)
def test_hard_mine_heads_long_and_wide_match_plain(cuda, H, B, D):
    """K3 at any batch, head count and width: one call each way against
    the plain twins (values atol 1e-4, picks equal, gradients atol 1e-5,
    two calls bit-equal); integer features above B = 256."""
    test_hard_mine_heads_kernels_match_plain(cuda, H, B, D, integer=B > 256)


def test_hard_mine_long_self_distance_is_exact(cuda):
    """The long schedule's norms are its Gram's own diagonal: 300 equal
    rows of one label give d2 exactly 0 in every tile, so d_ap is the
    clamp's floor with pick 0 and d_an is FLT_MAX, as the plain version."""
    f = torch.randn(1, 512, device=cuda).repeat(300, 1) * 10
    labels = torch.zeros(300, dtype=torch.int64, device=cuda)
    d_ap, d_an, i_ap, _ = triplet.hard_mine_kernel(f, labels)
    assert torch.all(d_ap == float(torch.sqrt(torch.tensor(1e-12))))
    assert torch.all(d_an == torch.finfo(torch.float32).max)
    assert torch.equal(i_ap, torch.zeros_like(i_ap))


def test_hard_mine_long_backward_one_row_picked_by_all(cuda):
    """Row 0 at the centre of a long batch is nearly every other anchor's
    hardest negative: one band's list holds ~B entries. The gradient
    against the plain S-matrix backward (atol 1e-5, and 1e-5 of max)."""
    heads, labels = _heads_batch(2, 600, 256, cuda, seed=5)
    for h in heads:
        h[0] = h.mean(dim=0)
    got = triplet.hard_mine_heads_kernel(heads, labels)
    want = triplet.hard_mine_heads_reference(heads, labels)
    assert torch.equal(got[3], want[3])
    assert int((got[3] == 0).sum()) > 500
    g = torch.rand(2, 600, device=cuda)
    grads = triplet.hard_mine_heads_backward_kernel(heads, *got, g, g)
    plain = triplet.hard_mine_backward_reference(heads, *got, g, g)
    for a, b in zip(grads, plain):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("D", [2048, 64])
def test_hard_mine_long_small_tiles_are_bit_stable(cuda, D):
    """B = 320 over 5 heads fills less than a wave of the card with
    128-row upper tiles, so the long forward takes 64-row ones (at D = 2048
    with K split over a cluster): against the plain twins on integer
    features (values atol 1e-4, picks equal, gradients atol 1e-5); on
    continuous ones two calls bit-equal each way; and on integer features,
    whose Grams are exact in any order and split, the same heads mined
    among 65 (128-row tiles, no split, the device table) give the same
    bits."""
    H, B = 5, 320
    test_hard_mine_heads_kernels_match_plain(cuda, H, B, D, integer=True)
    heads, labels = _heads_batch(H, B, D, cuda, seed=B + D)
    got = triplet.hard_mine_heads_kernel(heads, labels)
    again = triplet.hard_mine_heads_kernel(heads, labels)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    g = torch.rand(H, B, device=cuda)
    grads = triplet.hard_mine_heads_backward_kernel(heads, *got, g, g)
    grads_again = triplet.hard_mine_heads_backward_kernel(heads, *got, g, g)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_again))
    exact, labels = _heads_batch(H, B, D, cuda, seed=B + D, integer=True)
    few = triplet.hard_mine_heads_kernel(exact, labels)
    many = triplet.hard_mine_heads_kernel(exact * 13, labels)
    assert all(torch.equal(a, m[:H]) for a, m in zip(few, many))


def test_hard_mine_long_batch_past_the_parameter_table(cuda):
    """A long batch at 65 heads (the device table) on integer features:
    one call each way against the plain twins, two calls bit-equal."""
    test_hard_mine_heads_kernels_match_plain(cuda, 65, 300, 64, integer=True)


def test_hard_mine_long_backward_lists_past_shared_memory(cuda):
    """B = 16,400: the pick lists' counts no longer fit in shared memory,
    so one block a head keeps them in the scratch. Integer features: the
    picks against the plain twin's, the gradient against the twin's on the
    same picks (1e-5 of max), two calls bit-equal."""
    H, B, D = 1, 16400, 8
    heads, labels = _heads_batch(H, B, D, cuda, seed=B, integer=True)
    got = triplet.hard_mine_heads_kernel(heads, labels)
    want = triplet.hard_mine_heads_reference(heads, labels)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    g = torch.rand(H, B, device=cuda) / B
    grads = triplet.hard_mine_heads_backward_kernel(heads, *got, g, g)
    again = triplet.hard_mine_heads_backward_kernel(heads, *got, g, g)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    for a, b in zip(grads, triplet.hard_mine_backward_reference(heads, *got, g, g)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("H", [65, 94])
def test_hard_mine_device_table_equals_param_table(cuda, H):
    """The two forms of the head table run one kernel: H heads in one call
    (more than 64: the device table) give, bit for bit, the outputs and
    gradients of their first 64 in one call (the parameter table) and the
    rest in another, at B = 16 and at B = 320."""
    for B in (16, 320):
        heads, labels = _heads_batch(H, B, 256, cuda, seed=H + B)
        g = torch.rand(H, B, device=cuda)
        whole = triplet.hard_mine_heads_kernel(heads, labels)
        parts = [triplet.hard_mine_heads_kernel(heads[s], labels)
                 for s in (slice(64), slice(64, H))]
        assert all(torch.equal(a, torch.cat([p[k] for p in parts]))
                   for k, a in enumerate(whole))
        grads = triplet.hard_mine_heads_backward_kernel(heads, *whole, g, g)
        split = [triplet.hard_mine_heads_backward_kernel(heads[s], *(x[s] for x in whole),
                                                         g[s], g[s])
                 for s in (slice(64), slice(64, H))]
        assert all(torch.equal(a, b) for a, b in zip(grads, split[0] + split[1]))


def _near_tie_gap(heads, got, want, slots=(2, 3)):
    """(picks that differ, the largest float64 gap of their squared
    distances from the anchor over sq_i + sq_j): fp32 orders round the
    quadratic form at the scale of sq_i + sq_j, so picks closer than that
    may swap between the kernel and its twin."""
    differ, gap = 0, 0.0
    for k in slots:
        for h, i in (got[k] != want[k]).nonzero().tolist():
            f = heads[h].double()
            a, b = int(got[k][h, i]), int(want[k][h, i])
            d2 = ((f[[a, b]] - f[i]) ** 2).sum(dim=1)
            sq = (f[[i, a, b]] ** 2).sum(dim=1)
            differ += 1
            gap = max(gap, float((d2[0] - d2[1]).abs() / (sq[0] + sq[1:].max())))
    return differ, gap


@pytest.mark.parametrize("H,B,D", [
    (1, 257, 64),      # 64-row tiles
    (3, 300, 1030),    # D padded
    (5, 2048, 2048),   # 128-row tiles
    (65, 320, 256),    # 128-row tiles, the device head table
])
def test_hard_mine_long_continuous_picks_are_near_ties(cuda, H, B, D):
    """The long schedule on continuous features, whose Grams fp32 orders
    round apart: values atol 1e-4 against the plain twin; a pick that
    differs must be a near-tie within 1e-5 of sq_i + sq_j; the backward on
    the kernel's picks against its twin (1e-5 of max); two calls
    bit-equal."""
    heads, labels = _heads_batch(H, B, D, cuda, seed=H * B + D)
    got = triplet.hard_mine_heads_kernel(heads, labels)
    want = triplet.hard_mine_heads_reference(heads, labels)
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=0)
    assert _near_tie_gap(heads, got, want)[1] <= 1e-5
    again = triplet.hard_mine_heads_kernel(heads, labels)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    g = torch.rand(H, B, device=cuda) / B
    grads = triplet.hard_mine_heads_backward_kernel(heads, *got, g, g)
    for a, b in zip(grads, triplet.hard_mine_backward_reference(heads, *got, g, g)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("H,B,D", [(1, 300, 512), (5, 2048, 2048)])
def test_hard_mine_long_self_distance_of_distinct_rows_is_exact(cuda, H, B, D):
    """Continuous, distinct rows, every anchor its own label: its one
    positive is itself, so d_ap is exactly the clamp's floor at pick i only
    if d2_ii is exactly 0 in the tile that holds the diagonal (64-row tiles
    at (1, 300), 128-row ones at (5, 2048)); d_an as the plain twin's
    (atol 1e-4, a differing pick a near-tie within 1e-5 of sq_i + sq_j)."""
    heads, _ = _heads_batch(H, B, D, cuda, seed=B + D)
    own = torch.arange(B, device=cuda)
    got = triplet.hard_mine_heads_kernel(heads, own)
    want = triplet.hard_mine_heads_reference(heads, own)
    assert torch.all(got[0] == float(torch.sqrt(torch.tensor(1e-12))))
    assert torch.equal(got[2], own.expand(H, B))
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=0)
    assert _near_tie_gap(heads, got, want, slots=(3,))[1] <= 1e-5


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


@pytest.mark.parametrize("gamma", [0.3, 0.0])
@pytest.mark.parametrize("mode", graph_conv.GRAPH_MODES)
@pytest.mark.parametrize("B,V,masked", [(16, 56, False), (64, 56, True), (1, 2128, True),
                                        (3, 129, False)])
def test_ganet_flags_match_plain(cuda, mode, gamma, B, V, masked):
    """K1 with ganet's diagonal mask and additive residual, on both
    schedules, with and without a vertex mask: one launch per call, within
    1e-5 of max|plain|; at gamma 0 the output is f exactly."""
    args, mask = _masked_case(cuda, B, V, 2048, masked, seed=V + 7)
    args = (*args[:7], gamma)
    before = graph_conv.launches
    got = graph_conv.graph_propagate(*args, vertex_mask=mask, mode=mode, mask_diag=True,
                                     additive=True)
    torch.cuda.synchronize()
    assert graph_conv.launches == before + 1
    want = graph_conv.graph_propagate_reference(*args, vertex_mask=mask, mode=mode,
                                                mask_diag=True, additive=True)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    if gamma == 0.0:
        assert torch.equal(got, args[0])


@pytest.mark.parametrize("H,B,D", [(2, 16, 6144), (2, 16, 2048), (1, 16, 2048), (1, 16, 1024)])
def test_hard_mine_heads_at_the_single_scale_archs_shapes(cuda, H, B, D):
    """K3 at the train steps of ganet (H=2, D=6144), gsta (2, 2048),
    res50tp / resnet50_s1 (1, 2048) and sta / simple_sta (1, 1024)."""
    test_hard_mine_heads_kernels_match_plain(cuda, H, B, D)


@pytest.mark.parametrize("arch", ["gsta", "ganet", "res50tp", "resnet50_s1", "sta",
                                  "simple_sta"])
def test_single_scale_arch_on_the_card(cuda, arch):
    """Each arch at depth (1,1,1,1), 128x64, S=8: the eval forward
    launches K1 twice for gsta and ganet (num_gb 2) and never for the
    others, and equals the plain path (1e-5 of max); two train steps
    launch K3 once each way per step with finite losses."""
    from agrl_torch.engine.trainer import make_train_step
    from agrl_torch.models import layers as layers_mod
    from agrl_torch.models.ganet import GANet
    from agrl_torch.models.gsta import GSTA
    from agrl_torch.models.res50tp import ResNet50S1, ResNet50TP
    from agrl_torch.models.sta import STA
    from agrl_torch.optim import init_optim

    ctor = {"gsta": GSTA, "ganet": GANet, "res50tp": ResNet50TP, "resnet50_s1": ResNet50S1,
            "sta": STA, "simple_sta": lambda **kw: STA(simple=True, **kw)}[arch]
    kw = dict(consistent_loss=True) if arch in ("gsta", "ganet") else {}
    model = ctor(num_classes=4, layers=(1, 1, 1, 1), **kw)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (16, 8, 128, 64, 3)).astype(np.uint8)
    adjs = (rng.rand(16, 56, 56) > 0.5).astype(np.float32)
    x = torch.from_numpy(imgs).to(cuda).float() / 255.0
    a = torch.from_numpy(adjs).to(cuda)
    with torch.no_grad():
        before = graph_conv.launches
        got = model(x, a)
        torch.cuda.synchronize()
        launched = graph_conv.launches - before
        layers_mod.graph_propagate = graph_conv.graph_propagate_reference
        try:
            want = model(x, a)
        finally:
            layers_mod.graph_propagate = graph_conv.graph_propagate
    assert launched == (2 if arch in ("gsta", "ganet") else 0)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    opt = init_optim("adam", model.parameters(), 1e-4, weight_decay=5e-4)
    step = make_train_step(model, opt, lambda s: 1e-4, aug={"flip_aug": True})
    gen = torch.Generator().manual_seed(1)
    before = (triplet.launches, triplet.backward_launches)
    losses = [float(step(imgs, np.repeat(np.arange(4), 4), adjs, generator=gen)["loss"])
              for _ in range(2)]
    assert (triplet.launches - before[0], triplet.backward_launches - before[1]) == (2, 2)
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("H,B,D", [(22, 16, 512), (22, 16, 1536), (46, 16, 1536),
                                   (64, 16, 64)])
def test_hard_mine_heads_at_the_multi_scale_archs_shapes(cuda, H, B, D):
    """K3 at the train steps of msppn (H=22, D=512) and msppgn at --num-gb
    2 (22, 1536), msppgn at --num-split 8 (46, 1536), and 64 heads, the
    most the launch's parameter table holds: one launch each way, against
    the plain twins."""
    test_hard_mine_heads_kernels_match_plain(cuda, H, B, D)


@pytest.mark.parametrize("arch", ["msppn", "msppgn"])
def test_multi_scale_arch_on_the_card(cuda, arch):
    """Each arch at depth (1,1,1,1), 128x64, S=8, --num-split 4 (V = 168):
    the eval forward launches K1 never (GraphBlock is torch ops, as it is
    XLA ops in agrl_tpu) and is finite; two train steps over 22 heads
    launch K3 once each way per step with finite losses; the padded `all`
    forward equals the unpadded one."""
    from agrl_torch.engine.trainer import make_train_step
    from agrl_torch.models.graphnet import MSPyraPartGraphNet, MSPyraPartNet
    from agrl_torch.optim import init_optim

    model = (MSPyraPartNet(num_classes=4, num_split=4, layers=(1, 1, 1, 1)) if arch == "msppn"
             else MSPyraPartGraphNet(num_classes=4, num_split=4, num_gb=2, layers=(1, 1, 1, 1)))
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (16, 8, 128, 64, 3)).astype(np.uint8)
    adjs = (rng.rand(16, 168, 168) > 0.5).astype(np.float32)
    x = torch.from_numpy(imgs).to(cuda).float() / 255.0
    a = torch.from_numpy(adjs).to(cuda)
    with torch.no_grad():
        before = graph_conv.launches
        got = model(x, a)
        torch.cuda.synchronize()
        assert graph_conv.launches == before and torch.isfinite(got).all()
        Sp = 16
        xp = torch.cat([x[:1], torch.zeros_like(x[:1])], dim=1)
        ap = torch.from_numpy(model.pad_eval_adjacency(adjs[0], 8, Sp))[None].to(cuda)
        fm = torch.cat([torch.ones(1, 8), torch.zeros(1, 8)], dim=1).to(cuda)
        padded = model(xp, ap, frame_mask=fm)
        assert float((padded - got[:1]).abs().max()) <= 1e-4 * float(got[:1].abs().max())
    opt = init_optim("adam", model.parameters(), 1e-4, weight_decay=5e-4)
    step = make_train_step(model, opt, lambda s: 1e-4, aug={"flip_aug": True})
    gen = torch.Generator().manual_seed(1)
    before = (triplet.launches, triplet.backward_launches)
    losses = [float(step(imgs, np.repeat(np.arange(4), 4), adjs, generator=gen)["loss"])
              for _ in range(2)]
    assert (triplet.launches - before[0], triplet.backward_launches - before[1]) == (2, 2)
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("H,B,D", [(1, 16, 512), (1, 16, 2048)])
def test_hard_mine_heads_at_the_legacy_archs_shapes(cuda, H, B, D):
    """K3 at the train steps of res50rnn (H=1, D=512; resnet3d at depth
    <= 34 too) and of res50tp_legacy, res50ta and resnet3d50 (1, 2048)."""
    test_hard_mine_heads_kernels_match_plain(cuda, H, B, D)


@pytest.mark.parametrize("arch", ["res50tp_legacy", "res50ta", "res50rnn", "resnet3d50"])
def test_legacy_arch_on_the_card(cuda, arch):
    """Each legacy video arch at depth (1,1,1,1) (resnet3d at depth 10),
    128x64, S=8: the eval forward launches K1 never and equals the same
    model's on the CPU (1e-4 of max); two train steps launch K3 once each
    way per step with finite losses."""
    import copy

    from agrl_torch.engine.trainer import make_train_step
    from agrl_torch.models.resnet3d import ResNet3D
    from agrl_torch.models.resnet_temporal import ResNet50RNN, ResNet50TA, ResNet50TPLegacy
    from agrl_torch.optim import init_optim

    xh, tiny = {"xent", "htri"}, (1, 1, 1, 1)
    model = {"res50tp_legacy": lambda: ResNet50TPLegacy(4, loss=xh, layers=tiny),
             "res50ta": lambda: ResNet50TA(4, loss=xh, layers=tiny, height=128, width=64),
             "res50rnn": lambda: ResNet50RNN(4, loss=xh, layers=tiny),
             "resnet3d50": lambda: ResNet3D(4, loss=xh, depth=10)}[arch]()
    model.init_weights(torch.Generator().manual_seed(0))
    cpu = copy.deepcopy(model).eval()
    model = model.to(cuda).eval()
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (16, 8, 128, 64, 3)).astype(np.uint8)
    x = torch.from_numpy(imgs).float() / 255.0
    with torch.no_grad():
        before = graph_conv.launches
        got = model(x.to(cuda))
        torch.cuda.synchronize()
        assert graph_conv.launches == before
        want = cpu(x)
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())
    opt = init_optim("adam", model.parameters(), 1e-4, weight_decay=5e-4)
    step = make_train_step(model, opt, lambda s: 1e-4, aug={"flip_aug": True})
    gen = torch.Generator().manual_seed(1)
    adjs = np.ones((16, 8, 8), np.float32)
    before = (triplet.launches, triplet.backward_launches)
    losses = [float(step(imgs, np.repeat(np.arange(4), 4), adjs, generator=gen)["loss"])
              for _ in range(2)]
    assert (triplet.launches - before[0], triplet.backward_launches - before[1]) == (2, 2)
    assert all(np.isfinite(losses))


def test_world_one_nccl_step_equals_the_step_without_a_group(cuda):
    """A data-parallel step in an NCCL group of world 1 (every collective
    still runs: BN moments, the gathered mining, the gradient average)
    against the step without a group, two steps each from one state at
    VMGN (1,1,1,1), 128x64, S=8, 16 clips with the consistent loss and
    flips, SGD lr 1e-3: losses within rtol 1e-5, each parameter within 2e-2
    of its update (Frobenius; the BN moments combine in another order), one
    K3 forward and one backward launch a step on the grouped path."""
    import copy
    import socket

    import torch.distributed as dist

    from agrl_torch.engine.trainer import make_train_step
    from agrl_torch.models.vmgn import VMGN
    from agrl_torch.optim import init_optim
    from agrl_torch.parallel import initialize_distributed, make_mesh

    model = VMGN(num_classes=4, layers=(1, 1, 1, 1), consistent_loss=True)
    model.init_weights(torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (16, 8, 128, 64, 3)).astype(np.uint8)
    adjs = (rng.rand(16, 56, 56) > 0.5).astype(np.float32)
    pids = np.repeat(np.arange(4), 4)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    def run(mesh):
        m = copy.deepcopy(model).to(cuda)
        m.load_state_dict(init)
        opt = init_optim("sgd", m.parameters(), 1e-3, weight_decay=5e-4)
        step = make_train_step(m, opt, lambda s: 1e-3, aug={"flip_aug": True}, mesh=mesh)
        gen = torch.Generator().manual_seed(1)
        before = (triplet.launches, triplet.backward_launches)
        losses = [float(step(imgs, pids, adjs, generator=gen)["loss"]) for _ in range(2)]
        launches = (triplet.launches - before[0], triplet.backward_launches - before[1])
        return losses, launches, {n: p.detach().cpu() for n, p in m.named_parameters()}

    plain = run(None)
    initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        mesh = make_mesh()
        assert mesh.dp == 1 and mesh.device.type == "cuda"
        grouped = run(mesh)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(grouped[0], plain[0], rtol=1e-5)
    assert grouped[1] == plain[1] == (2, 2)
    for name, p in plain[2].items():
        update = (p - init[name]).norm()
        if update > 0:
            assert float((grouped[2][name] - p).norm() / update) <= 2e-2, name


# one rank of the dp 1 x mp 2 group below: gloo on the one card (NCCL refuses
# two ranks on one card), the port's mesh over it with the card as its device
_MP_RANK = r"""
import dataclasses, sys
import numpy as np, torch, torch.distributed as dist
from agrl_torch.engine.evaluator import Evaluator
from agrl_torch.engine.trainer import make_train_step
from agrl_torch.models.vmgn import VMGN
from agrl_torch.ops import graph_conv, triplet
from agrl_torch.optim import init_optim
from agrl_torch.parallel import gather_state, make_mesh, place_state

rank, port, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cuda = torch.device("cuda", 0)
torch.cuda.set_device(cuda)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
mesh = dataclasses.replace(make_mesh(mp=2), devices=(cuda,))
inp = torch.load(work + "/in.pt", weights_only=False)
model = VMGN(num_classes=4, layers=(1, 1, 1, 1), consistent_loss=True).to(cuda)
model.load_state_dict(inp["state"])
opt = init_optim("sgd", model.parameters(), 1e-3, weight_decay=5e-4)
plan = place_state(mesh, model, opt, min_size=1024)
ev = Evaluator(model, test_sample="evenly", device=cuda)
k1 = graph_conv.launches
batch = (inp["imgs"][:4], np.zeros(4), np.zeros(4), inp["adjs"][:4])
feats = ev.extract([batch], "query", mesh=mesh)[0].cpu()
k1 = graph_conv.launches - k1
step = make_train_step(model, opt, lambda s: 1e-3, aug={"flip_aug": True}, mesh=mesh)
gen = torch.Generator().manual_seed(1)
before = (triplet.launches, triplet.backward_launches)
losses = [float(step(inp["imgs"], inp["pids"], inp["adjs"], generator=gen)["loss"])
          for _ in range(2)]
k3 = (triplet.launches - before[0], triplet.backward_launches - before[1])
state, _ = gather_state(model)
torch.save(dict(plan=plan, feats=feats, k1=k1, losses=losses, k3=k3,
                state={k: v.cpu() for k, v in state.items()}), f"{work}/rank{rank}.pt")
dist.destroy_process_group()
"""


def test_dp_one_mp_two_over_gloo_on_the_card(cuda, tmp_path):
    """Two processes on the one card in a gloo group (its CUDA collectives
    staged through the host) under the port's dp 1 x mp 2 mesh, VMGN
    (1,1,1,1) at 128x64, S=8, 16 clips, min_size 1024 (both graph linears
    and both 4-class classifiers shard): the mp Evaluator's features of a
    4-clip batch equal the one-process Evaluator's within 1e-6 of max with
    K1 2 launches a rank (the whole W); two SGD steps at lr 1e-3 against
    the same steps without a group: losses within rtol 1e-5, each
    parameter (the blocks gathered) within 2e-2 of its update, one K3
    launch each way a step on each rank."""
    import os
    import socket
    import subprocess
    import sys

    from agrl_torch.engine.evaluator import Evaluator
    from agrl_torch.engine.trainer import make_train_step
    from agrl_torch.models.vmgn import VMGN
    from agrl_torch.optim import init_optim

    model = VMGN(num_classes=4, layers=(1, 1, 1, 1), consistent_loss=True)
    model.init_weights(torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (16, 8, 128, 64, 3)).astype(np.uint8)
    adjs = (rng.rand(16, 56, 56) > 0.5).astype(np.float32)
    pids = np.repeat(np.arange(4), 4)
    torch.save(dict(state=init, imgs=imgs, adjs=adjs, pids=pids), tmp_path / "in.pt")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen([sys.executable, "-c", _MP_RANK, str(r), str(port), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], [o[-2000:] for o in outs]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]

    model = model.to(cuda)
    batch = (imgs[:4], np.zeros(4), np.zeros(4), adjs[:4])
    want_feats = Evaluator(model, test_sample="evenly", device=cuda).extract([batch])[0].cpu()
    opt = init_optim("sgd", model.parameters(), 1e-3, weight_decay=5e-4)
    step = make_train_step(model, opt, lambda s: 1e-3, aug={"flip_aug": True})
    gen = torch.Generator().manual_seed(1)
    losses = [float(step(imgs, pids, adjs, generator=gen)["loss"]) for _ in range(2)]
    for r in ranks:
        assert set(r["plan"]) == {"graph_layers.0.linear.weight", "graph_layers.1.linear.weight",
                                  "global_classifier.weight", "att_classifier.weight"}
        assert float((r["feats"] - want_feats).abs().max()) <= 1e-6 * float(want_feats.abs().max())
        assert r["k1"] == 2 and r["k3"] == (2, 2)
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
    for name, p in model.named_parameters():
        p = p.detach().cpu()
        update = (p - init[name]).norm()
        if update > 0:
            assert float((ranks[0]["state"][name] - p).norm() / update) <= 2e-2, name
