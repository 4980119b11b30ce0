"""CMC / mAP ranking metrics — vectorized NumPy implementations.

A copy of agrl_tpu/metrics/rank.py. `evaluate_rank(use_native=True)`
dispatches mars, market1501 and cuhk03 to the C++ scorers of
native/rank_eval.cpp (metrics/rank_native.py) when they build, as
agrl_tpu's does; by default, and wherever the library cannot be built,
it runs the NumPy paths below, which are the paths agrl_tpu takes
without its library, so the two agree bit for bit.

Behavioral parity targets in the reference:
  * `eval_market1501`  -> torchreid/metrics/rank.py:95-150 (and the Cython
    twin rank_cylib/rank_cy.pyx:154-243). Same-pid+same-cam gallery entries
    are dropped; CMC is a clipped cumsum; AP is the standard
    precision-weighted sum over the FULL kept ranking.
  * `eval_cuhk03`      -> torchreid/metrics/rank.py:22-92 (10x random
    single-gallery-shot resampling).
  * `evaluate_mars`    -> torchreid/metrics/rank.py:160-212 (the training script's
    default): good = same pid & different cam, junk = pid==-1 or same
    pid+cam; ranking truncated to `max_rank` BEFORE scoring; AP uses the
    trapezoid rule with the FULL-gallery good count as the recall
    denominator.
  * `evaluate_dukev`   -> torchreid/metrics/rank.py:330-343 (sklearn
    interpolated AP + first-match-break CMC).

Where the reference runs per-query Python loops (or generated Cython), the
market1501 and mars paths here are fully vectorized over queries with
cumulative-sum formulations — the same math reorganized so the batch
dimension maps onto numpy (and, in agrl_torch.ops.rank, onto the card).
The duke path's tie case computes scikit-learn's PR-curve AUC in NumPy
(`_interp_average_precision`), where agrl_tpu imports scikit-learn.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

__all__ = ["evaluate_rank", "eval_market1501", "eval_cuhk03", "evaluate_mars", "evaluate_dukev", "evaluate_dukev_fast"]


def _sorted_flags(distmat, q_pids, g_pids, q_camids, g_camids):
    """Sort gallery per query; return (indices, match, same_cam) flags in sorted order."""
    distmat = np.asarray(distmat)
    q_pids = np.asarray(q_pids)
    g_pids = np.asarray(g_pids)
    q_camids = np.asarray(q_camids)
    g_camids = np.asarray(g_camids)
    indices = np.argsort(distmat, axis=1)  # (Q, G)
    g_pids_s = g_pids[indices]
    g_cams_s = g_camids[indices]
    match = g_pids_s == q_pids[:, None]
    same_cam = g_cams_s == q_camids[:, None]
    return indices, g_pids_s, match, same_cam


def eval_market1501(distmat, q_pids, g_pids, q_camids, g_camids, max_rank=50):
    """Market1501 protocol, vectorized over queries.

    For each query: drop gallery entries with same pid AND same cam;
    CMC(r) = 1 iff a match occurs at kept-rank <= r; AP = mean precision at
    each match position over the full kept list. Queries whose identity
    never appears in the kept gallery are excluded from both averages.
    """
    num_q, num_g = np.asarray(distmat).shape
    if num_g < max_rank:
        max_rank = num_g
        print(f"Note: number of gallery samples is quite small, got {num_g}")

    _, _, match, same_cam = _sorted_flags(distmat, q_pids, g_pids, q_camids, g_camids)
    keep = ~(match & same_cam)  # (Q, G) in sorted order
    good = match & keep

    # position among kept entries (1-based) at every sorted slot
    j = np.cumsum(keep, axis=1)
    cs = np.cumsum(good, axis=1)  # number of matches seen so far

    num_rel = good.sum(axis=1)  # matches per query (kept)
    valid = num_rel > 0
    assert valid.any(), "Error: all query identities do not appear in gallery"

    # AP: sum of precision (cs/j) at each good slot / num_rel
    with np.errstate(divide="ignore", invalid="ignore"):
        prec = np.where(good, cs / np.maximum(j, 1), 0.0)
    ap = prec.sum(axis=1) / np.maximum(num_rel, 1)

    # CMC: kept-rank (0-based) of the first good slot
    first_good = np.where(good, j - 1, num_g)  # kept-rank at good slots
    r0 = first_good.min(axis=1)  # (Q,)
    ranks = np.arange(max_rank)[None, :]
    cmc_rows = (ranks >= r0[:, None]).astype(np.float32)

    all_cmc = cmc_rows[valid].sum(axis=0) / valid.sum()
    mAP = float(ap[valid].mean())
    return all_cmc.astype(np.float32), mAP


def eval_cuhk03(distmat, q_pids, g_pids, q_camids, g_camids, max_rank=50, num_repeats=10):
    """CUHK03 protocol: 10x random single-gallery-shot CMC; standard AP."""
    distmat = np.asarray(distmat)
    q_pids = np.asarray(q_pids)
    g_pids = np.asarray(g_pids)
    num_q, num_g = distmat.shape
    if num_g < max_rank:
        max_rank = num_g
        print(f"Note: number of gallery samples is quite small, got {num_g}")

    indices, g_pids_s, match, same_cam = _sorted_flags(
        distmat, q_pids, g_pids, q_camids, g_camids
    )
    keep = ~(match & same_cam)

    all_cmc, all_ap = [], []
    for q_idx in range(num_q):
        raw_cmc = match[q_idx][keep[q_idx]].astype(np.int64)
        if not raw_cmc.any():
            continue
        kept_g_pids = g_pids_s[q_idx][keep[q_idx]]
        pid_slots = defaultdict(list)
        for idx, pid in enumerate(kept_g_pids):
            pid_slots[pid].append(idx)

        cmc = np.zeros(max_rank, dtype=np.float64)
        for _ in range(num_repeats):
            mask = np.zeros(len(raw_cmc), dtype=bool)
            for idxs in pid_slots.values():
                mask[np.random.choice(idxs)] = True
            masked = raw_cmc[mask]
            _cmc = np.clip(np.cumsum(masked), 0, 1)
            padded = np.zeros(max_rank, dtype=np.float64)
            padded[: min(max_rank, len(_cmc))] = _cmc[:max_rank]
            if len(_cmc) < max_rank and len(_cmc) > 0:
                padded[len(_cmc):] = _cmc[-1]
            cmc += padded
        cmc /= num_repeats
        all_cmc.append(cmc)

        num_rel = raw_cmc.sum()
        tmp = np.cumsum(raw_cmc) / np.arange(1, len(raw_cmc) + 1)
        all_ap.append(float((tmp * raw_cmc).sum() / num_rel))

    assert all_cmc, "Error: all query identities do not appear in gallery"
    all_cmc = np.asarray(all_cmc, dtype=np.float32).mean(axis=0)
    return all_cmc.astype(np.float32), float(np.mean(all_ap))


def evaluate_mars(distmat, q_pids, g_pids, q_camids, g_camids, max_rank=50):
    """MARS protocol (the training script's default), vectorized over queries.

    Semantics (reference rank.py:160-212): sort each query's gallery and
    truncate to `max_rank`. Walk the truncated list: junk entries
    (pid == -1, or same pid & same cam) are skipped without advancing the
    retrieved-count; good entries (same pid, different cam) advance both
    intersect and recall. AP accumulates the trapezoid
    (recall - old_recall) * (old_precision + precision) / 2, with recall's
    denominator = the FULL-gallery good count. CMC at kept-rank r is 1 once
    a good entry appeared at kept-rank <= r.
    """
    distmat = np.asarray(distmat)
    q_pids = np.asarray(q_pids)
    g_pids = np.asarray(g_pids)
    q_camids = np.asarray(q_camids)
    g_camids = np.asarray(g_camids)
    num_q, num_g = distmat.shape
    R = min(max_rank, num_g)

    # full-gallery good counts (recall denominator)
    full_good = (g_pids[None, :] == q_pids[:, None]) & (
        g_camids[None, :] != q_camids[:, None]
    )
    ngood = full_good.sum(axis=1)  # (Q,)

    indices = np.argsort(distmat, axis=1)[:, :R]  # (Q, R)
    g_pids_s = g_pids[indices]
    g_cams_s = g_camids[indices]
    good = (g_pids_s == q_pids[:, None]) & (g_cams_s != q_camids[:, None])
    junk = (g_pids_s == -1) | (
        (g_pids_s == q_pids[:, None]) & (g_cams_s == q_camids[:, None])
    )
    keep = ~junk
    good &= keep  # good and junk are disjoint by construction; be safe

    j = np.cumsum(keep, axis=1)  # kept position (1-based) at each slot
    cs = np.cumsum(good, axis=1)  # intersect size after each slot

    # trapezoid AP: at each good slot, recall step = 1/ngood,
    # precision = cs/j, old_precision = (cs-1)/(j-1) (or 1.0 at the first kept slot)
    with np.errstate(divide="ignore", invalid="ignore"):
        prec = np.where(good, cs / np.maximum(j, 1), 0.0)
        old_prec = np.where(
            good & (j > 1), (cs - 1) / np.maximum(j - 1, 1), 1.0
        )
        old_prec = np.where(good, old_prec, 0.0)
    ngood_safe = np.maximum(ngood, 1)[:, None]
    ap = ((prec + old_prec) / 2.0 / ngood_safe * good).sum(axis=1)
    ap = np.where(ngood > 0, ap, 0.0)

    # CMC: kept-rank of first good. Queries with no good entry in the
    # truncated list use a sentinel >= max_rank so their CMC row stays all
    # zeros even when num_g < max_rank (a found query's 1s extend past R,
    # i.e. the row is padded with its last value).
    first_good = np.where(good, j - 1, max_rank)
    r0 = first_good.min(axis=1)
    ranks = np.arange(max_rank)[None, :]
    cmc = (ranks >= r0[:, None]).astype(np.float64)

    return cmc.mean(axis=0), float(ap.mean())


# ---------------------------------------------------------------------------
# DukeMTMC-VideoReID style (sklearn interpolated AP + configurable CMC)
# ---------------------------------------------------------------------------


def _interp_average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AUC of the precision-recall curve, as the reference's duke path
    computes it (rank.py:253-261: sklearn's auc(recall, precision) over
    precision_recall_curve(y_true, y_score)), written out in NumPy with
    sklearn's arithmetic so the port needs no scikit-learn: one curve
    point per distinct score (a run of tied scores is one point), in
    descending score order, then the (recall 0, precision 1) endpoint and
    the trapezoid rule over decreasing recall."""
    y_true = np.asarray(y_true, dtype=bool)
    y_score = np.asarray(y_score)
    order = np.argsort(y_score, kind="stable")[::-1]
    score_s, true_s = y_score[order], y_true[order]
    # the last slot of each run of equal scores, and the end
    thresholds = np.r_[np.nonzero(np.diff(score_s))[0], true_s.size - 1]
    tps = np.cumsum(true_s.astype(np.float64))[thresholds]
    fps = 1 + thresholds.astype(np.float64) - tps
    precision = tps / (tps + fps)
    recall = tps / tps[-1] if tps[-1] > 0 else np.ones_like(tps)
    precision = np.concatenate([precision[::-1], [1.0]])
    recall = np.concatenate([recall[::-1], [0.0]])
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return float(-trapezoid(precision, recall))


def _cmc_first_match(distmat, query_ids, gallery_ids, query_cams, gallery_cams, topk=100):
    """Open-reid style CMC (reference rank.py:264-307) with the only
    options the duke path passes: shared camera set, no single-gallery-shot
    resampling, first match break (agrl_tpu's _cmc_configurable with
    those arguments, so the results are the same)."""
    distmat = np.asarray(distmat)
    query_ids = np.asarray(query_ids)
    gallery_ids = np.asarray(gallery_ids)
    query_cams = np.asarray(query_cams)
    gallery_cams = np.asarray(gallery_cams)
    m, _ = distmat.shape
    indices = np.argsort(distmat, axis=1)
    matches = gallery_ids[indices] == query_ids[:, None]
    ret = np.zeros(topk)
    num_valid_queries = 0
    for i in range(m):
        valid = (gallery_ids[indices[i]] != query_ids[i]) | (
            gallery_cams[indices[i]] != query_cams[i]
        )
        if not np.any(matches[i, valid]):
            continue
        index = np.nonzero(matches[i, valid])[0]
        if index[0] < topk:
            ret[index[0]] += 1
        num_valid_queries += 1
    if num_valid_queries == 0:
        raise RuntimeError("No valid query")
    return ret.cumsum() / num_valid_queries


def evaluate_dukev_fast(
    distmat, query_ids, gallery_ids, query_cams, gallery_cams, max_rank=50
):
    """Vectorized duke-protocol scoring (the fast path of evaluate_dukev).

    Equivalent closed forms of the reference's per-query loops:
      * mAP: sklearn's auc(recall, precision) over the PR curve of the
        kept ranking is, for tie-free scores, exactly the trapezoid sum
        over match positions with old_precision = 1 at the first kept
        slot — the same cumsum formulation the mars path uses, with the
        kept-list match count as the recall denominator and no rank
        truncation. (With TIED distances sklearn merges curve points and
        can differ; re-id feature distances are continuous, and
        evaluate_dukev keeps the sklearn path for exactness.)
      * CMC (first_match_break, shared camera set): indicator that the
        first kept match appears at rank <= r — identical to the
        market1501 CMC row construction with topk=max(100, max_rank).
    """
    num_q, num_g = np.asarray(distmat).shape
    topk = max(100, max_rank)
    _, _, match, same_cam = _sorted_flags(
        distmat, query_ids, gallery_ids, query_cams, gallery_cams
    )
    keep = ~(match & same_cam)
    good = match & keep

    j = np.cumsum(keep, axis=1)  # kept position (1-based)
    cs = np.cumsum(good, axis=1)
    num_rel = good.sum(axis=1)
    valid = num_rel > 0
    if not valid.any():
        raise RuntimeError("No valid query")

    with np.errstate(divide="ignore", invalid="ignore"):
        prec = np.where(good, cs / np.maximum(j, 1), 0.0)
        old_prec = np.where(good & (j > 1), (cs - 1) / np.maximum(j - 1, 1), 1.0)
        old_prec = np.where(good, old_prec, 0.0)
    ap = ((prec + old_prec) / 2.0 * good).sum(axis=1) / np.maximum(num_rel, 1)
    mAP = float(ap[valid].mean())

    first_good = np.where(good, j - 1, num_g)
    r0 = first_good.min(axis=1)
    ranks = np.arange(topk)[None, :]
    cmc = (ranks >= r0[:, None]).astype(np.float64)
    return cmc[valid].mean(axis=0), mAP


def evaluate_dukev(distmat, query_ids, gallery_ids, query_cams, gallery_cams, max_rank=50):
    """Duke video protocol: interpolated mAP + first-match-break CMC."""
    distmat = np.asarray(distmat)
    query_ids = np.asarray(query_ids)
    gallery_ids = np.asarray(gallery_ids)
    query_cams = np.asarray(query_cams)
    gallery_cams = np.asarray(gallery_cams)

    indices = np.argsort(distmat, axis=1)
    matches = gallery_ids[indices] == query_ids[:, None]
    aps = []
    for i in range(matches.shape[0]):
        valid = (gallery_ids[indices[i]] != query_ids[i]) | (
            gallery_cams[indices[i]] != query_cams[i]
        )
        y_true = matches[i, valid]
        y_score = -distmat[i][indices[i]][valid]
        if not np.any(y_true):
            continue
        aps.append(_interp_average_precision(y_true, y_score))
    if not aps:
        raise RuntimeError("No valid query")
    mAP = float(np.mean(aps))

    cmc_scores = _cmc_first_match(
        distmat, query_ids, gallery_ids, query_cams, gallery_cams, topk=max(100, max_rank)
    )
    return cmc_scores, mAP


def evaluate_rank(
    distmat,
    q_pids,
    g_pids,
    q_camids,
    g_camids,
    max_rank=50,
    use_metric_cuhk03=False,
    use_metric_market1501=False,
    use_metric_mars=False,
    use_metric_dukev=False,
    use_native=False,
):
    """Dispatcher mirroring reference torchreid/metrics/rank.py:215-238.

    With `use_native` (the Evaluator's host scoring passes it), mars,
    market1501 and cuhk03 run in the C++ scorers when they build
    (metrics/rank_native.py), like the reference preferring its Cython
    extension and agrl_tpu its native/librank_eval.so; they agree with the
    NumPy paths to ~1e-6. Otherwise, and for dukev, the NumPy paths run.
    The cuhk03 paths draw from the global np.random stream, as the
    reference does, so the choice never changes its draws. Fully
    on-device evaluation lives in agrl_torch.ops.rank."""
    if use_native and (use_metric_mars or use_metric_market1501 or use_metric_cuhk03):
        from agrl_torch.metrics import rank_native

        if rank_native.available():
            if use_metric_cuhk03:
                scorer = rank_native.evaluate_cuhk03_native
            elif use_metric_market1501:
                scorer = rank_native.evaluate_market1501_native
            else:
                scorer = rank_native.evaluate_mars_native
            return scorer(distmat, q_pids, g_pids, q_camids, g_camids, max_rank)
    if use_metric_cuhk03:
        return eval_cuhk03(distmat, q_pids, g_pids, q_camids, g_camids, max_rank)
    if use_metric_market1501:
        return eval_market1501(distmat, q_pids, g_pids, q_camids, g_camids, max_rank)
    if use_metric_mars:
        return evaluate_mars(distmat, q_pids, g_pids, q_camids, g_camids, max_rank)
    if use_metric_dukev:
        # vectorized closed form of the sklearn loop — exact only for
        # tie-free distances (sklearn merges PR-curve points at ties; the
        # trapezoid form doesn't). Feature distances are continuous, but a
        # re-ranked distmat is a quantized Jaccard blend where ties are
        # plausible — detect them and keep the literal sklearn walk there.
        dm = np.asarray(distmat)
        row_sorted = np.sort(dm, axis=1)
        has_ties = bool((row_sorted[:, 1:] == row_sorted[:, :-1]).any())
        impl = evaluate_dukev if has_ties else evaluate_dukev_fast
        return impl(distmat, q_pids, g_pids, q_camids, g_camids, max_rank)
    raise ValueError("Select one of the evaluation metrics")
