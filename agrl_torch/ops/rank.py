"""MARS-protocol CMC/mAP on the features' device (counterpart of
agrl_tpu/ops/rank.py: streaming_topk, mars_cmc_map_from_topk,
evaluate_mars_device).

The MARS protocol truncates the ranking to max_rank before scoring, so
only a top-k is needed: the gallery is consumed in tiles with a
streaming top-k merge and the full (Q, G) matrix is never held. The
per-query walk (junk skipping, trapezoid AP, first-good CMC) becomes
masked cumulative sums over the top-k axis.
"""

from __future__ import annotations

import torch

from agrl_torch.ops.distmat import compute_distmat


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
    dev = qf.device
    _, idx = streaming_topk(qf, gf, k=max_rank, tile=tile, metric=metric)
    ids = [torch.as_tensor(a, device=dev) for a in (q_pids, g_pids, q_camids, g_camids)]
    return mars_cmc_map_from_topk(idx, *ids, max_rank=max_rank)
