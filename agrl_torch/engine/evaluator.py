"""Evaluation: feature extraction -> distances (optionally re-ranked) ->
CMC/mAP.

Counterpart of agrl_tpu/engine/evaluator.py for `--test-sample evenly`
(reference test(), train_vidreid_xent_htri.py:450-546): every tracklet is
one clip and its features stay on the device. The ranking stage takes
agrl_tpu's branches and console lines:
  * device path (the default): the protocol scores on the card — MARS as
    a streaming top-k, market1501/cuhk03/dukev from the full distance
    matrix; with `re_rank`, k-reciprocal re-ranking on the card first
    (ops/rerank.py, whose Jaccard term is the min-plus kernel);
  * host scoring (`device_rank=False`, `return_distmat`, or dukev after
    re-ranking, whose device scorer is exact only for tie-free
    distances): agrl_torch.metrics (NumPy) scores a (Q, G) matrix copied
    to the host. With `re_rank` that matrix is still re-ranked on the
    features' device unless `device_rank=False`; agrl_tpu re-ranks on the
    host in all three cases, and the two re-rankings agree within 2e-4.
    With `device_rank=False` the distances are computed on the device
    and re-ranked on the host by the host algorithm, as in agrl_tpu.

Not ported yet (raise NotImplementedError): dense/skipdense clip packing,
bucketed `all` with frame masks, a mesh.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from agrl_torch import resolve_device
from agrl_torch.data.transforms import preprocess_clips
from agrl_torch.metrics import evaluate_rank, re_ranking
from agrl_torch.ops.distmat import compute_distmat
from agrl_torch.ops.rank import (
    cuhk03_cmc_map,
    dukev_cmc_map,
    evaluate_mars_device,
    market1501_cmc_map,
    mars_cmc_map_from_distmat,
)
from agrl_torch.ops.rerank import re_ranking_from_features
from agrl_torch.utils.avgmeter import AverageMeter

PROTOCOLS = ("mars", "market1501", "cuhk03", "dukev")
_DEVICE_SCORERS = {
    "mars": mars_cmc_map_from_distmat,
    "market1501": market1501_cmc_map,
    "dukev": dukev_cmc_map,
}


def make_eval_forward(model, device):
    """The eval forward: uint8 clips (B, S, H, W, 3) and adjacencies
    (B, V, V) as numpy arrays or tensors in, (B, D) float32 features out,
    on `device`. Preprocess (normalize) runs on the device.

    Sets both TF32 switches off — process-wide — so every fp32 product
    and convolution runs in full fp32 (this slice serves fp32 only; the
    l2 affinity and the cosine distances need it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model.eval()

    def fwd(imgs, adjs) -> torch.Tensor:
        x = torch.as_tensor(imgs).to(device)
        a = torch.as_tensor(adjs, dtype=torch.float32).to(device)
        with torch.inference_mode():
            return model(preprocess_clips(x), a)

    return fwd


class Evaluator:
    def __init__(self, model, test_sample: str = "evenly", device="cuda"):
        if test_sample != "evenly":
            raise NotImplementedError(f"test_sample={test_sample!r} is not ported yet")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.test_sample = test_sample
        self._fwd = make_eval_forward(self.model, self.device)

    def extract(self, loader, name: str = "query"):
        """Returns (features (N, D) on the device, pids, camids, batch_time
        meter). Batch times are host time around each forward, synchronized
        with the card. The model goes to eval mode first: a trainer between
        two evaluations leaves it in train mode."""
        self.model.eval()
        feats, pids, camids = [], [], []
        batch_time = AverageMeter()
        for imgs, bpids, bcamids, adjs in loader:
            t0 = time.time()
            feats.append(self._fwd(imgs, adjs))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            batch_time.update(time.time() - t0)
            pids.extend(np.asarray(bpids).tolist())
            camids.extend(np.asarray(bcamids).tolist())
        if not feats:
            raise ValueError(f"{name} loader yielded no tracklets")
        features = torch.cat(feats, dim=0)
        print(
            f"Extracted features for {name} set, obtained "
            f"{features.shape[0]}-by-{features.shape[1]} matrix"
        )
        return features, np.asarray(pids), np.asarray(camids), batch_time

    def evaluate(
        self,
        queryloader,
        galleryloader,
        dist_metric: str = "euclidean",
        re_rank: bool = False,
        ranks=(1, 5, 10, 20),
        metric_protocol: str = "mars",
        return_distmat: bool = False,
        device_rank: bool = True,
    ):
        """Returns (rank-1, mAP), or the (Q, G) numpy distance matrix
        (re-ranked if asked) with `return_distmat`, and prints agrl_tpu's
        result block."""
        if metric_protocol not in PROTOCOLS:
            raise ValueError(f"metric_protocol must be one of {PROTOCOLS}, got {metric_protocol!r}")
        qf, q_pids, q_camids, bt_q = self.extract(queryloader, "query")
        gf, g_pids, g_camids, bt_g = self.extract(galleryloader, "gallery")
        avg_bt = (bt_q.sum + bt_g.sum) / max(bt_q.count + bt_g.count, 1)
        print(f"==> BatchTime(s)/Batch: {avg_bt:.3f}")
        ids = (q_pids, g_pids, q_camids, g_camids)

        # dukev's device scorer is a trapezoid closed form, exact only for
        # tie-free distances; re-ranked distances are quantized Jaccard
        # blends where ties are plausible -> host path (whose dispatcher
        # detects ties and keeps the literal sklearn walk)
        if device_rank and not return_distmat and not (re_rank and metric_protocol == "dukev"):
            # the device scorers clamp their valid-query denominator, so an
            # all-invalid query set would print 0% scores: check validity
            # on the host first, as every host path raises
            some_valid = bool(
                ((q_pids[:, None] == g_pids[None, :]) & (q_camids[:, None] != g_camids[None, :])).any()
            )
            if not some_valid:
                raise RuntimeError(
                    "No valid query: no query identity appears in the "
                    "gallery under a different camera"
                )
            print("Computing CMC and mAP on device")
            cmc_d, map_d = self._device_cmc(qf, gf, ids, dist_metric, re_rank, metric_protocol)
            cmc, mAP = cmc_d.cpu().numpy(), float(map_d)
            _print_results(cmc, mAP, ranks)
            return float(cmc[0]), mAP

        if re_rank and device_rank:
            # return_distmat, or dukev: re-rank where the features are and
            # copy only the re-ranked (Q, G) matrix to the host scorer
            print("Applying person re-ranking (device)...")
            distmat = re_ranking_from_features(qf, gf, dist_metric).cpu().numpy()
        else:
            print(f"Computing distance matrix with metric={dist_metric} ...")
            distmat = compute_distmat(qf, gf, dist_metric).cpu().numpy()
            if re_rank:
                print("Applying person re-ranking ...")
                qq = compute_distmat(qf, qf, dist_metric).cpu().numpy()
                gg = compute_distmat(gf, gf, dist_metric).cpu().numpy()
                distmat = re_ranking(distmat, qq, gg)

        print("Computing CMC and mAP")
        cmc, mAP = evaluate_rank(distmat, *ids, **{f"use_metric_{metric_protocol}": True})
        _print_results(cmc, mAP, ranks)
        if return_distmat:
            return distmat
        return float(cmc[0]), mAP

    @staticmethod
    def _device_cmc(qf, gf, ids, dist_metric, re_rank, metric_protocol):
        """(CMC curve, mAP) as device tensors, from features on the card."""
        if re_rank:
            print("Applying person re-ranking (device)...")
            dm = re_ranking_from_features(qf, gf, dist_metric)
        elif metric_protocol == "mars":
            # streaming top-k: no full (Q, G) matrix at all
            return evaluate_mars_device(qf, gf, *ids, metric=dist_metric)
        else:
            dm = compute_distmat(qf, gf, dist_metric)
        if metric_protocol == "cuhk03":
            gen = torch.Generator(device=dm.device).manual_seed(0)
            return cuhk03_cmc_map(dm, *ids, generator=gen)
        return _DEVICE_SCORERS[metric_protocol](dm, *ids)


def _print_results(cmc, mAP, ranks):
    print("Results ----------")
    print(f"mAP: {mAP:.2%}")
    print("CMC curve")
    for r in ranks:
        if r <= len(cmc):  # tiny galleries truncate the CMC curve
            print(f"Rank-{r:<3}: {cmc[r - 1]:.2%}")
    print("------------------")
