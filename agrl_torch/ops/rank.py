"""CMC/mAP on the features' device (counterpart of agrl_tpu/ops/rank.py:
streaming_topk, mars_cmc_map_from_topk, evaluate_mars_device,
mars_cmc_map_from_distmat, market1501_cmc_map, dukev_cmc_map,
cuhk03_cmc_map).

The MARS protocol truncates the ranking to max_rank before scoring, so
only a top-k is needed: the gallery is consumed in tiles with a
streaming top-k merge and the full (Q, G) matrix is never held. The
per-query walk (junk skipping, trapezoid AP, first-good CMC) becomes
masked cumulative sums over the top-k axis. The other protocols score a
full (Q, G) matrix (e.g. the re-ranked one): one stable sort per row,
then the same cumulative sums.

Every sort is stable, so equal distances keep the lower gallery index
first, as jnp.argsort and lax.top_k order them.
"""

from __future__ import annotations

import torch

from agrl_torch.ops.distmat import compute_distmat


def nearest(dist: torch.Tensor, k: int) -> torch.Tensor:
    """(R, N) -> (R, k) column indices of each row's k smallest entries,
    in order, ties lowest index first (lax.top_k on -dist)."""
    return torch.sort(dist, dim=1, stable=True).indices[:, :k]


def _ids(device, *arrays):
    """pids/camids (numpy arrays or tensors) as int64 tensors on `device`."""
    return [torch.as_tensor(a, device=device).long() for a in arrays]


def streaming_topk(qf, gf, k: int = 50, tile: int = 2048, metric: str = "cosine"):
    """Top-k smallest distances without materializing (Q, G).

    qf: (Q, D), gf: (G, D) -> (dists (Q, k), indices (Q, k)). Gallery
    tiles of `tile` rows merge into the running best-k; ties keep the
    lower position, as lax.top_k does. Slots no gallery entry fills carry
    distance float32-max and the out-of-range index G, so when k > G the
    fillers never alias gallery entry 0."""
    Q, G = qf.shape[0], gf.shape[0]
    big = torch.finfo(torch.float32).max
    best_d = torch.full((Q, k), big, dtype=torch.float32, device=qf.device)
    best_i = torch.full((Q, k), G, dtype=torch.int64, device=qf.device)
    for start in range(0, G, tile):
        d = compute_distmat(qf, gf[start:start + tile], metric).float()
        col = torch.arange(start, start + d.shape[1], device=qf.device)
        cat_d = torch.cat([best_d, d], dim=1)
        cat_i = torch.cat([best_i, col.expand(Q, -1)], dim=1)
        order = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
        best_d = torch.gather(cat_d, 1, order)
        best_i = torch.gather(cat_i, 1, order)
    return best_d, best_i


def mars_cmc_map_from_topk(topk_idx, q_pids, g_pids, q_camids, g_camids, max_rank: int = 50):
    """MARS CMC/mAP from top-k gallery indices (top-k >= max_rank).

    Same cumulative-sum trapezoid formulation as agrl_tpu's oracle
    (agrl_tpu.metrics.rank.evaluate_mars). Returns (cmc (max_rank,), mAP)."""
    G = g_pids.shape[0]
    R = min(max_rank, topk_idx.shape[1])
    idx = topk_idx[:, :R]
    in_range = idx < G  # small galleries: top-k slots may be fillers
    safe = torch.clamp(idx, 0, G - 1)
    g_pid_s, g_cam_s = g_pids[safe], g_camids[safe]
    qp, qc = q_pids[:, None], q_camids[:, None]
    good = (g_pid_s == qp) & (g_cam_s != qc) & in_range
    junk = ~in_range | (g_pid_s == -1) | ((g_pid_s == qp) & (g_cam_s == qc))
    keep = ~junk
    good = good & keep

    ngood = ((g_pids[None, :] == qp) & (g_camids[None, :] != qc)).sum(dim=1)

    j = torch.cumsum(keep, dim=1)
    cs = torch.cumsum(good, dim=1)
    zero = torch.zeros((), dtype=torch.float32, device=idx.device)
    prec = torch.where(good, cs / torch.clamp(j, min=1), zero)
    old_prec = torch.where(good & (j > 1), (cs - 1) / torch.clamp(j - 1, min=1), 1.0)
    old_prec = torch.where(good, old_prec, zero)
    ap = ((prec + old_prec) / 2.0 * good).sum(dim=1) / torch.clamp(ngood, min=1)
    ap = torch.where(ngood > 0, ap, zero)

    # the no-good sentinel is max_rank, not R: with G < max_rank a sentinel
    # of R would flip CMC to 1 past R for queries with no match
    first_good = torch.where(good, j - 1, max_rank).min(dim=1).values
    ranks = torch.arange(max_rank, device=idx.device)
    cmc = (ranks[None, :] >= first_good[:, None]).float()
    return cmc.mean(dim=0), ap.mean()


def evaluate_mars_device(
    qf, gf, q_pids, g_pids, q_camids, g_camids,
    max_rank: int = 50, metric: str = "cosine", tile: int = 2048,
):
    """Feature matrices in, (CMC curve, mAP) out, on the features' device.
    pids/camids may be numpy arrays or tensors."""
    _, idx = streaming_topk(qf, gf, k=max_rank, tile=tile, metric=metric)
    ids = _ids(qf.device, q_pids, g_pids, q_camids, g_camids)
    return mars_cmc_map_from_topk(idx, *ids, max_rank=max_rank)


def mars_cmc_map_from_distmat(distmat, q_pids, g_pids, q_camids, g_camids, max_rank: int = 50):
    """MARS protocol from an explicit (Q, G) distance matrix (e.g. the
    re-ranked one): top-k, then the masked-cumsum scorer."""
    k = min(max_rank, distmat.shape[1])
    idx = nearest(distmat.float(), k)
    ids = _ids(distmat.device, q_pids, g_pids, q_camids, g_camids)
    return mars_cmc_map_from_topk(idx, *ids, max_rank=max_rank)


def _sorted_flags(distmat, q_pids, g_pids, q_camids, g_camids):
    """Each row's gallery in distance order: (sorted pids, keep, good),
    keep dropping same-pid-same-camera entries, good = match & keep."""
    q_pids, g_pids, q_camids, g_camids = _ids(distmat.device, q_pids, g_pids, q_camids, g_camids)
    indices = torch.sort(distmat, dim=1, stable=True).indices
    g_pid_s, g_cam_s = g_pids[indices], g_camids[indices]
    match = g_pid_s == q_pids[:, None]
    keep = ~(match & (g_cam_s == q_camids[:, None]))
    return g_pid_s, keep, match & keep


def _valid_mean(cmc_rows, ap, valid):
    """CMC and mAP averaged over the queries with a match; the count is
    clamped to 1 (the Evaluator checks validity on the host first)."""
    n_valid = torch.clamp(valid.sum(), min=1)
    return (cmc_rows * valid[:, None]).sum(dim=0) / n_valid, (ap * valid).sum() / n_valid


def _first_good_cmc(good, j, sentinel, length):
    """(Q, length) 0/1 rows: 1 from the kept rank of the first match on."""
    first_good = torch.where(good, j - 1, sentinel).min(dim=1).values
    ranks = torch.arange(length, device=j.device)
    return (ranks[None, :] >= first_good[:, None]).float()


def _precision_at_matches(keep, good):
    """(kept rank j, 1-based, at every sorted slot; matches seen so far;
    matches per query; precision at each match, 0 elsewhere)."""
    j = torch.cumsum(keep, dim=1)
    cs = torch.cumsum(good, dim=1)
    prec = torch.where(good, cs / torch.clamp(j, min=1), 0.0)
    return j, cs, good.sum(dim=1), prec


def _market1501_ap(keep, good):
    """(kept rank j; matches per query; AP = the mean precision at each
    match over the full kept ranking)."""
    j, _, num_rel, prec = _precision_at_matches(keep, good)
    return j, num_rel, prec.sum(dim=1) / torch.clamp(num_rel, min=1)


def market1501_cmc_map(distmat, q_pids, g_pids, q_camids, g_camids, max_rank: int = 50):
    """market1501 protocol on the matrix's device: full-gallery sort and
    cumulative sums."""
    _, keep, good = _sorted_flags(distmat, q_pids, g_pids, q_camids, g_camids)
    j, num_rel, ap = _market1501_ap(keep, good)
    return _valid_mean(_first_good_cmc(good, j, distmat.shape[1], max_rank), ap, num_rel > 0)


def dukev_cmc_map(distmat, q_pids, g_pids, q_camids, g_camids, max_rank: int = 50):
    """Duke video protocol on the matrix's device: the closed-form sklearn
    PR-AUC (trapezoid against the (recall 0, precision 1) endpoint, exact
    for tie-free distances, as agrl_tpu.metrics.rank.evaluate_dukev_fast)
    and first-match-break CMC over topk = max(100, max_rank) ranks."""
    G = distmat.shape[1]
    _, keep, good = _sorted_flags(distmat, q_pids, g_pids, q_camids, g_camids)
    j, cs, num_rel, prec = _precision_at_matches(keep, good)
    old_prec = torch.where(good & (j > 1), (cs - 1) / torch.clamp(j - 1, min=1), 1.0)
    old_prec = torch.where(good, old_prec, 0.0)
    ap = ((prec + old_prec) / 2.0 * good).sum(dim=1) / torch.clamp(num_rel, min=1)
    return _valid_mean(_first_good_cmc(good, j, G, max(100, max_rank)), ap, num_rel > 0)


def cuhk03_cmc_map(distmat, q_pids, g_pids, q_camids, g_camids, generator: torch.Generator,
                   max_rank: int = 50, num_repeats: int = 10):
    """cuhk03 protocol on the matrix's device (reference rank.py:22-92).

    AP is market1501's over the full kept ranking. CMC is the mean over
    `num_repeats` rounds of single-gallery-shot resampling, one random
    kept slot per distinct gallery pid, vectorized as agrl_tpu's: a
    random permutation (argsort of uniforms), then a stable sort by pid,
    so the first slot of every pid segment is that pid's draw; the CMC row
    is `rank >= r0`, r0 counting the chosen slots ahead of the query
    pid's. The uniforms come from `generator` (drawn on its device): the
    draws differ from agrl_tpu's jax.random ones, as those differ from
    the reference's np.random; AP, valid/keep and the case of one kept
    slot per pid (where CMC is deterministic) agree exactly."""
    Q, G = distmat.shape
    dev = distmat.device
    q_pid_t = _ids(dev, q_pids)[0]
    g_pid_s, keep, good = _sorted_flags(distmat, q_pids, g_pids, q_camids, g_camids)
    j, num_rel, ap = _market1501_ap(keep, good)
    pos = j - 1  # position among kept slots, at every sorted slot

    # non-kept slots sink to a sentinel pid segment at the end
    sentinel = torch.iinfo(torch.int64).max
    pid_keyed = torch.where(keep, g_pid_s, sentinel)
    ranks = torch.arange(max_rank, device=dev)
    cmc_sum = torch.zeros(Q, max_rank, device=dev)
    first_col = torch.ones(Q, 1, dtype=torch.bool, device=dev)
    for _ in range(num_repeats):
        u = torch.rand(Q, G, generator=generator, device=generator.device).to(dev)
        ord_u = torch.sort(u, dim=1, stable=True).indices  # a random permutation per query
        pid_perm = torch.gather(pid_keyed, 1, ord_u)
        order = torch.gather(ord_u, 1, torch.sort(pid_perm, dim=1, stable=True).indices)
        pid_sorted = torch.gather(g_pid_s, 1, order)
        keep_sorted = torch.gather(keep, 1, order)
        pos_sorted = torch.gather(pos, 1, order)
        first = torch.cat([first_col, pid_sorted[:, 1:] != pid_sorted[:, :-1]], dim=1)
        chosen = first & keep_sorted  # one slot per distinct kept pid
        is_q = chosen & (pid_sorted == q_pid_t[:, None])
        pos_star = torch.where(is_q, pos_sorted, 0).sum(dim=1)
        r0 = (chosen & (pos_sorted < pos_star[:, None])).sum(dim=1)
        cmc_sum += (ranks[None, :] >= r0[:, None]).float()
    return _valid_mean(cmc_sum / num_repeats, ap, num_rel > 0)
