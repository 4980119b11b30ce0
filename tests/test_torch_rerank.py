"""The port's min-plus product, k-reciprocal re-ranking and host metrics
copies held against agrl_tpu (JAX on the CPU), on small seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrl_torch import metrics as torch_metrics
from agrl_torch.ops import minsum, rerank
from agrl_tpu import metrics as jax_metrics
from agrl_tpu.ops import rerank as jax_rerank
from agrl_tpu.ops.distmat import compute_distmat as jax_distmat
from agrl_tpu.ops.minsum import min_sum_pallas

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.mark.parametrize("shape", [(37, 53, 100), (130, 260, 515), (8, 8, 8)])
def test_min_sum_reference_matches_pallas(shape, monkeypatch):
    """The JAX package's kernel bar (tests/test_ops_pallas.py:111-121)."""
    Q, J, C = shape
    rng = np.random.RandomState(0)
    a = rng.rand(Q, C).astype(np.float32)
    b = rng.rand(J, C).astype(np.float32)
    want = np.asarray(min_sum_pallas(a, b, tq=16, tj=16, tc=32, interpret=True))
    got = minsum.min_sum_reference(_t(a), _t(b)).numpy()
    assert got.shape == (Q, J)
    np.testing.assert_allclose(got, want, atol=1e-4)
    # the CPU dispatch is the plain version; a small temporary tiles j too
    np.testing.assert_array_equal(minsum.min_sum(_t(a), _t(b)).numpy(), got)
    monkeypatch.setattr(minsum, "BLOCK_ELEMS", 64 * C)
    np.testing.assert_allclose(minsum.min_sum_reference(_t(a), _t(b)).numpy(), got, atol=1e-5)


def test_min_sum_reference_matches_rerank_scan():
    rng = np.random.RandomState(1)
    vq = rng.rand(11, 40).astype(np.float32)
    v = rng.rand(40, 40).astype(np.float32)
    want = np.asarray(jax_rerank._min_sum(jnp.asarray(vq), jnp.asarray(v)))  # CPU -> scan
    np.testing.assert_allclose(minsum.min_sum_reference(_t(vq), _t(v)).numpy(), want, atol=1e-5)


def test_min_sum_dispatch_refuses_other_devices():
    with pytest.raises(ValueError):
        minsum.min_sum(torch.zeros(2, 3, device="meta"), torch.zeros(2, 3, device="meta"))
    with pytest.raises(ValueError):
        minsum.min_sum_reference(torch.zeros(2, 3), torch.zeros(2, 4))


def make_dists(rng, num_q=15, num_g=45, num_pids=8, dim=16):
    """tests/test_rerank.py's identity-clustered euclidean distances."""
    centers = rng.randn(num_pids, dim) * 3
    qf = centers[rng.randint(0, num_pids, num_q)] + rng.randn(num_q, dim) * 0.7
    gf = centers[rng.randint(0, num_pids, num_g)] + rng.randn(num_g, dim) * 0.7

    def d(a, b):
        return ((a[:, None] - b[None]) ** 2).sum(-1) ** 0.5

    return d(qf, gf), d(qf, qf), d(gf, gf)


@pytest.mark.parametrize("seed,k1,k2", [(0, 8, 3), (1, 8, 3), (2, 6, 1), (3, 10, 4)])
def test_re_ranking_device_matches_jax_and_host(seed, k1, k2):
    """The JAX device-vs-host bar (tests/test_rerank.py:93-103)."""
    qg, qq, gg = make_dists(np.random.RandomState(seed))
    got = rerank.re_ranking_device(_t(qg), _t(qq), _t(gg), k1=k1, k2=k2).numpy()
    want_jax = np.asarray(jax_rerank.re_ranking_device(qg, qq, gg, k1=k1, k2=k2))
    want_host = jax_metrics.re_ranking(qg, qq, gg, k1=k1, k2=k2)
    assert got.shape == qg.shape
    np.testing.assert_allclose(got, want_jax, atol=2e-4)
    np.testing.assert_allclose(got, want_host, atol=2e-4)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_re_ranking_from_features_matches_jax(metric):
    rng = np.random.RandomState(4)
    qf = rng.randn(12, 16).astype(np.float32)
    gf = rng.randn(40, 16).astype(np.float32)
    got = rerank.re_ranking_from_features(_t(qf), _t(gf), metric=metric, k1=8, k2=3).numpy()
    want = np.asarray(jax_rerank.re_ranking_from_features(qf, gf, metric=metric, k1=8, k2=3))
    np.testing.assert_allclose(got, want, atol=2e-4)
    # and the host algorithm on the host distances of the same features
    host = [torch_metrics.compute_distance_matrix(x, y, metric) for x, y in
            ((qf, gf), (qf, qf), (gf, gf))]
    np.testing.assert_allclose(got, torch_metrics.re_ranking(*host, k1=8, k2=3), atol=2e-4)


def test_tied_distances_keep_lax_top_k_order():
    """Duplicated feature rows give exactly equal distances; the port's
    neighbour table must be lax.top_k's (lowest index first), and the
    re-ranked matrix agrees with agrl_tpu's."""
    rng = np.random.RandomState(5)
    base = rng.randn(10, 8).astype(np.float32)
    qf = base[[0, 1, 2, 0, 3, 1]]
    gf = base[rng.randint(0, 10, 30)]  # every base row several times
    qg, qq, gg = (np.asarray(jax_distmat(x, y, "euclidean")) for x, y in
                  ((qf, gf), (qf, qf), (gf, gf)))
    dist_t = rerank.original_dist(_t(qg), _t(qq), _t(gg))
    kmax = 11
    got = rerank.nearest(dist_t, kmax).numpy()
    _, want = jax.lax.top_k(-jnp.asarray(dist_t.numpy()), kmax)
    np.testing.assert_array_equal(got, np.asarray(want))
    row_sorted = np.sort(dist_t.numpy(), axis=1)[:, :kmax]
    assert (row_sorted[:, 1:] == row_sorted[:, :-1]).any()  # ties inside the top-k

    k1, k2 = 10, 3
    out = rerank.re_ranking_device(_t(qg), _t(qq), _t(gg), k1=k1, k2=k2).numpy()
    want_rr = np.asarray(jax_rerank.re_ranking_device(qg, qq, gg, k1=k1, k2=k2))
    np.testing.assert_allclose(out, want_rr, atol=2e-4)


def test_bool_counts_reach_their_maximum():
    """Clusters of k1 + 1 points around a centre point: every k-reciprocal
    set is full (|R(i)| = k1 + 1) and both 0/1 products reach their
    largest count, half_k + 1 (the bound in expanded_membership); the
    result still matches agrl_tpu and the host algorithm."""
    k1, k2 = 8, 3
    half_k = round(k1 / 2)
    rng = np.random.RandomState(6)
    centres = rng.randn(4, 32) * 50
    pts = []
    for c in centres:
        pts.append(c)
        pts.extend(c + rng.randn(k1, 32))
    feats = np.asarray(pts, np.float32)  # 4 clusters of k1 + 1
    qf, gf = feats[::4], feats[np.arange(len(feats)) % 4 != 0]
    d = lambda x, y: np.sqrt(((x[:, None] - y[None]) ** 2).sum(-1))  # noqa: E731
    qg, qq, gg = d(qf, gf), d(qf, qf), d(gf, gf)

    dist = rerank.original_dist(_t(qg), _t(qq), _t(gg))
    n = dist.shape[0]
    nn_idx = rerank.nearest(dist, k1 + 1)
    f_full = rerank._membership(nn_idx, k1 + 1, n)
    r_full = f_full & f_full.T
    f_half = rerank._membership(nn_idx, half_k + 1, n)
    r_half = f_half & f_half.T
    overlap = rerank._bool_matmul(r_full, r_half.T)
    cond = r_full & (3.0 * overlap > 2.0 * r_half.sum(1).float()[None, :])
    union = rerank._bool_matmul(cond, r_half)
    assert int(r_full.sum(1).max()) == k1 + 1
    assert float(overlap.max()) == half_k + 1
    assert float(union.max()) == half_k + 1

    got = rerank.re_ranking_device(_t(qg), _t(qq), _t(gg), k1=k1, k2=k2).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_rerank.re_ranking_device(qg, qq, gg, k1=k1, k2=k2)), atol=2e-4)
    np.testing.assert_allclose(got, jax_metrics.re_ranking(qg, qq, gg, k1=k1, k2=k2), atol=2e-4)


def _ranking_inputs(seed, num_q=9, num_g=70, ties=False):
    rng = np.random.RandomState(seed)
    dm = rng.rand(num_q, num_g)
    if ties:
        dm = np.round(dm * 8) / 8
    return (dm, rng.randint(0, 6, num_q), rng.randint(-1, 6, num_g),
            rng.randint(0, 3, num_q), rng.randint(0, 3, num_g))


@pytest.mark.parametrize("protocol,ties", [("mars", False), ("market1501", False),
                                           ("dukev", False), ("dukev", True), ("cuhk03", False)])
def test_host_metrics_copies_bit_equal(protocol, ties):
    args = _ranking_inputs(7, ties=ties)
    kw = {f"use_metric_{protocol}": True}
    np.random.seed(0)
    got = torch_metrics.evaluate_rank(*args, **kw)
    np.random.seed(0)
    want = jax_metrics.evaluate_rank(*args, use_native=False, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("levels", [4, 16, None])
def test_interp_average_precision_matches_sklearn(levels):
    """The NumPy PR-curve AUC equals scikit-learn's auc(recall, precision)
    bit for bit, with heavy ties (`levels` distinct scores) and without."""
    from sklearn.metrics import auc, precision_recall_curve

    from agrl_torch.metrics.rank import _interp_average_precision

    rng = np.random.RandomState(levels or 0)
    for _ in range(20):
        n = rng.randint(2, 60)
        y_score = -rng.rand(n)
        if levels:
            y_score = np.round(y_score * levels) / levels
        y_true = rng.rand(n) < 0.3
        y_true[rng.randint(n)] = True
        precision, recall, _ = precision_recall_curve(y_true, y_score)
        assert _interp_average_precision(y_true, y_score) == float(auc(recall, precision))


def test_host_distance_and_rerank_copies_bit_equal():
    rng = np.random.RandomState(8)
    qf, gf = rng.randn(7, 12), rng.randn(25, 12)
    for metric in ("euclidean", "cosine"):
        np.testing.assert_array_equal(torch_metrics.compute_distance_matrix(qf, gf, metric),
                                      jax_metrics.compute_distance_matrix(qf, gf, metric))
    qg, qq, gg = make_dists(np.random.RandomState(9))
    np.testing.assert_array_equal(torch_metrics.re_ranking(qg, qq, gg, k1=6, k2=3),
                                  jax_metrics.re_ranking(qg, qq, gg, k1=6, k2=3))
