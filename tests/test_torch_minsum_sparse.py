"""The port's sparse min-plus entry (`min_sum_sparse`) held against its
plain version, agrl_tpu's Pallas kernel (interpret mode on the CPU) and
the host algorithm's accumulation order, on sparse seeded inputs. On CPU
tensors the entry takes the plain version; the CUDA kernels are checked
in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from agrl_torch.metrics.rerank import sparse_min_sum
from agrl_torch.ops import minsum, rerank
from agrl_tpu.ops.minsum import min_sum_pallas

torch.set_num_threads(2)


def _random_sparse(rng, rows, cols, density):
    return (rng.rand(rows, cols) * (rng.rand(rows, cols) < density)).astype(np.float32)


def _re_ranking_v(seed=0, num_q=15, num_g=45):
    """Re-ranking's membership matrix on identity-clustered features."""
    rng = np.random.RandomState(seed)
    centres = rng.randn(8, 16) * 3
    feats = centres[rng.randint(0, 8, num_q + num_g)] + rng.randn(num_q + num_g, 16) * 0.7
    d = np.sqrt(((feats[:, None] - feats[None]) ** 2).sum(-1)).astype(np.float32)
    blocks = (d[:num_q, num_q:], d[:num_q, :num_q], d[num_q:, num_q:])
    v = rerank.expanded_membership(rerank.original_dist(*map(torch.from_numpy, blocks)), 8, 3)
    v = v.numpy()
    return v[:num_q], v


def _case(name):
    rng = np.random.RandomState(3)
    if name == "re_ranking_v":
        return _re_ranking_v()
    if name == "empty_rows_and_columns":
        a, b = _random_sparse(rng, 23, 301, 0.1), _random_sparse(rng, 57, 301, 0.1)
        a[3], a[:, 9], b[7], b[:, 5] = 0, 0, 0, 0
        return a, b
    density = {"density_1pct": 0.01, "density_10pct": 0.1}[name]
    return _random_sparse(rng, 23, 301, density), _random_sparse(rng, 57, 301, density)


CASES = ["re_ranking_v", "density_1pct", "density_10pct", "empty_rows_and_columns"]


@pytest.mark.parametrize("name", CASES)
def test_min_sum_sparse_matches_plain_and_pallas(name):
    """CPU tensors take the plain version bit for bit; it meets the Pallas
    kernel's bar (interpret mode, tests/test_ops_pallas.py: 1e-4), here
    at 1e-5 since the sums are small."""
    a, b = _case(name)
    got = minsum.min_sum_sparse(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (a.shape[0], b.shape[0])
    want = minsum.min_sum_reference(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(min_sum_pallas(a, b, tq=16, tj=16, tc=32, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=1e-5)


@pytest.mark.parametrize("name", CASES)
def test_min_sum_sparse_matches_host_accumulation_order(name):
    """The host algorithm's fp32 accumulation (metrics.rerank.sparse_min_sum,
    the sparse kernels' order) differs from the plain version's summation
    order by rounding only: 1e-6 on sums of at most a few units."""
    a, b = _case(name)
    got = minsum.min_sum_sparse(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, sparse_min_sum(a, b), atol=1e-6, rtol=0)


@pytest.mark.parametrize("where,value", [("a", -1e-3), ("a", float("nan")), ("b", -1.0),
                                         ("b", float("nan"))])
def test_min_sum_sparse_rejects_negative_or_nan(where, value):
    a, b = (torch.from_numpy(x) for x in _case("density_10pct"))
    (a if where == "a" else b)[2, 4] = value
    with pytest.raises(ValueError, match="non-negative"):
        minsum.min_sum_sparse(a, b)


def test_min_sum_sparse_refuses_other_devices():
    with pytest.raises(ValueError):
        minsum.min_sum_sparse(torch.zeros(2, 3, device="meta"), torch.zeros(2, 3, device="meta"))


def test_re_ranking_takes_the_sparse_entry(monkeypatch):
    """re_ranking_device sends its Jaccard term to min_sum_sparse, once,
    with the query rows of v and all of v."""
    calls = []

    def spy(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return minsum.min_sum_sparse(a, b)

    rng = np.random.RandomState(1)
    feats = rng.randn(40, 8).astype(np.float32)
    d = np.sqrt(((feats[:, None] - feats[None]) ** 2).sum(-1)).astype(np.float32)
    blocks = [torch.from_numpy(x) for x in (d[:10, 10:], d[:10, :10], d[10:, 10:])]
    want = rerank.re_ranking_device(*blocks, k1=6, k2=3)
    monkeypatch.setattr(rerank, "min_sum_sparse", spy)
    got = rerank.re_ranking_device(*blocks, k1=6, k2=3)
    assert calls == [((10, 40), (40, 40))]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
