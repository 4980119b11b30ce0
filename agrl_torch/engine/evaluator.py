"""Evaluation: feature extraction -> distances -> MARS CMC/mAP on device.

Counterpart of agrl_tpu/engine/evaluator.py for `--test-sample evenly`
(reference test(), train_vidreid_xent_htri.py:450-546): every tracklet is
one clip; features stay on the device; the MARS protocol runs there as a
streaming top-k plus masked cumulative sums (ops/rank.py); the console
result block is the same.

Not ported yet (raise NotImplementedError): dense/skipdense clip packing,
bucketed `all` with frame masks, re-ranking, other protocols, a mesh.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from agrl_torch import resolve_device
from agrl_torch.data.transforms import preprocess_clips
from agrl_torch.ops.rank import evaluate_mars_device
from agrl_torch.utils.avgmeter import AverageMeter


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
        with the card."""
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
        ranks=(1, 5, 10, 20),
        metric_protocol: str = "mars",
    ):
        """Returns (rank-1, mAP) and prints agrl_tpu's result block."""
        if metric_protocol != "mars":
            raise NotImplementedError(f"metric_protocol={metric_protocol!r} is not ported yet")
        qf, q_pids, q_camids, bt_q = self.extract(queryloader, "query")
        gf, g_pids, g_camids, bt_g = self.extract(galleryloader, "gallery")
        avg_bt = (bt_q.sum + bt_g.sum) / max(bt_q.count + bt_g.count, 1)
        print(f"==> BatchTime(s)/Batch: {avg_bt:.3f}")

        # the scorer clamps its valid-query denominator, so an all-invalid
        # query set would print 0% scores: check validity on host first
        some_valid = bool(
            ((q_pids[:, None] == g_pids[None, :]) & (q_camids[:, None] != g_camids[None, :])).any()
        )
        if not some_valid:
            raise RuntimeError(
                "No valid query: no query identity appears in the "
                "gallery under a different camera"
            )
        print("Computing CMC and mAP on device")
        cmc_d, map_d = evaluate_mars_device(
            qf, gf, q_pids, g_pids, q_camids, g_camids, metric=dist_metric
        )
        cmc, mAP = cmc_d.cpu().numpy(), float(map_d)
        print("Results ----------")
        print(f"mAP: {mAP:.2%}")
        print("CMC curve")
        for r in ranks:
            if r <= len(cmc):
                print(f"Rank-{r:<3}: {cmc[r - 1]:.2%}")
        print("------------------")
        return float(cmc[0]), mAP
