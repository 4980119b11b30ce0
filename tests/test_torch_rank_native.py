"""The port's C++ ranking scorers (agrl_torch/metrics/rank_native.py, on
native/rank_eval.cpp built into agrl_torch/_build) held against the
port's NumPy scorers and agrl_tpu's (its NumPy paths: CMC and mAP to
1e-6; cuhk03 draw for draw under the same global seed), and the
dispatch in evaluate_rank. Skips, with the reason, only where the
library cannot be built."""

import numpy as np
import pytest

from agrl_torch.metrics import rank as trank
from agrl_torch.metrics import rank_native
from agrl_tpu.metrics import rank as jrank

from .oracles import make_reid_problem


@pytest.fixture
def native():
    if not rank_native.available():
        pytest.skip(f"the ranking library cannot be built here: {rank_native.why_unavailable()}")


def _problem(seed, junk=False, **kw):
    rng = np.random.RandomState(seed)
    dist, qp, gp, qc, gc = make_reid_problem(rng, **kw)
    if junk:
        qp, gp = qp.copy(), gp.copy()
        qp[:3] = -1
        gp[rng.rand(len(gp)) < 0.15] = -1
    return dist, qp, gp, qc, gc


SCORERS = {
    "mars": (rank_native.evaluate_mars_native, trank.evaluate_mars, jrank.evaluate_mars),
    "market1501": (rank_native.evaluate_market1501_native, trank.eval_market1501,
                   jrank.eval_market1501),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("protocol,junk", [("mars", False), ("mars", True),
                                           ("market1501", False)])
def test_native_scorers_match_numpy_and_agrl_tpu(native, protocol, junk, seed):
    """junk: pid -1 distractors (mars's label) in the query and gallery."""
    args = _problem(seed, junk=junk)
    nat, ours, theirs = SCORERS[protocol]
    cmc_n, map_n = nat(*args, 50)
    cmc_t, map_t = ours(*args, 50)
    cmc_j, map_j = theirs(*args, 50)
    np.testing.assert_allclose(cmc_n, cmc_t, atol=1e-6)
    np.testing.assert_allclose(map_n, map_t, atol=1e-6)
    np.testing.assert_allclose(cmc_n, cmc_j, atol=1e-6)
    np.testing.assert_allclose(map_n, map_j, atol=1e-6)


@pytest.mark.parametrize("seed,kw,max_rank", [
    (0, dict(num_q=15, num_g=120, num_pids=12), 10),
    (3, dict(num_q=8, num_g=30, num_pids=4), 20),  # fewer groups than max_rank
])
def test_native_cuhk03_draw_for_draw(native, seed, kw, max_rank):
    args = _problem(seed, **kw)
    results = []
    for fn in (rank_native.evaluate_cuhk03_native, trank.eval_cuhk03, jrank.eval_cuhk03):
        np.random.seed(777 + seed)
        results.append(fn(*args, max_rank))
        results[-1] += (np.random.randint(1 << 30),)  # the stream after the call
    (cmc_n, map_n, after_n), (cmc_t, map_t, after_t), (cmc_j, map_j, after_j) = results
    np.testing.assert_allclose(cmc_n, cmc_t, atol=1e-7)
    np.testing.assert_allclose(cmc_n, cmc_j, atol=1e-7)
    np.testing.assert_allclose(map_n, map_t, atol=1e-6)
    assert after_n == after_t == after_j  # the same number of draws


@pytest.mark.parametrize("protocol", ["mars", "market1501", "cuhk03", "dukev"])
def test_evaluate_rank_dispatch(native, protocol, monkeypatch):
    """use_native=True takes the C++ scorer for mars/market1501/cuhk03 and
    the NumPy path for dukev; the default keeps the NumPy paths."""
    args = _problem(4, num_q=12, num_g=90, num_pids=10)
    kw = {f"use_metric_{protocol}": True}
    np.random.seed(1)
    got = trank.evaluate_rank(*args, use_native=True, **kw)
    np.random.seed(1)
    numpy_path = trank.evaluate_rank(*args, **kw)
    np.testing.assert_allclose(got[0], numpy_path[0], atol=1e-6)
    assert abs(got[1] - numpy_path[1]) < 1e-6
    called = []
    for name in ("evaluate_mars_native", "evaluate_market1501_native", "evaluate_cuhk03_native"):
        real = getattr(rank_native, name)
        monkeypatch.setattr(rank_native, name,
                            lambda *a, _n=name, _r=real: called.append(_n) or _r(*a))
    np.random.seed(1)
    trank.evaluate_rank(*args, use_native=True, **kw)
    trank.evaluate_rank(*args, **kw)
    assert called == ([] if protocol == "dukev" else [f"evaluate_{protocol}_native"])


def test_evaluate_rank_falls_back_without_the_library(monkeypatch):
    args = _problem(2)
    monkeypatch.setattr(rank_native, "available", lambda: False)
    got = trank.evaluate_rank(*args, use_native=True, use_metric_mars=True)
    want = jrank.evaluate_rank(*args, use_native=False, use_metric_mars=True)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_native_refuses_an_all_invalid_query_set(native):
    dist, qp, gp, qc, gc = _problem(6, num_q=5, num_g=40)
    with pytest.raises(RuntimeError, match="do not appear in gallery"):
        rank_native.evaluate_market1501_native(dist, qp + 1000, gp, qc, gc, 10)
