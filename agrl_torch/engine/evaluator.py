"""Evaluation: feature extraction -> distances (optionally re-ranked) ->
CMC/mAP.

Counterpart of agrl_tpu/engine/evaluator.py on one device (reference
test(), train_vidreid_xent_htri.py:450-546). Extraction by test_sample:
  * `evenly`: every tracklet is one clip;
  * `dense`/`skipdense`: a tracklet's n clips; the clip streams of
    consecutive tracklets pack into (clip_batch, ...) device batches (a
    tracklet may straddle two), and each tracklet's clip features pool
    (avg or max) on the host in float64 as the slices arrive;
  * `all`: each tracklet pads to the next `_bucket_len` frame count with
    a frame mask the model honours exactly, and same-bucket tracklets
    batch together under a frame budget of clip_batch * 8. A model with
    no `supports_frame_mask` (the legacy video archs: res50tp_legacy,
    res50ta, res50rnn, resnet3d50, resnet3dt) runs each tracklet whole,
    unpadded, one loader batch at a time, as agrl_tpu's Evaluator does.
Features end on the Evaluator's device as (N, D) float32, D the model's
eval width: 4096 (vmgn), 6144 (ganet), 2048 (gsta, res50tp, resnet50_s1,
res50tp_legacy, res50ta, resnet3d50, resnet3dt), 1024 (sta, simple_sta),
512 (msppn, res50rnn) or (num_gb + 1) * 512 (msppgn).
With `bf16=True` (`--bf16-eval`) every forward is agrl_tpu's bf16 eval
(`eval_program`: weights, pixels and adjacency rounded to bf16, the model
at its own dtype).
The ranking stage takes agrl_tpu's branches and console lines:
  * device path (the default): the protocol scores on the card — MARS as
    a streaming top-k, market1501/cuhk03/dukev from the full distance
    matrix; with `re_rank`, k-reciprocal re-ranking on the card first
    (ops/rerank.py, whose Jaccard term is the min-plus kernel);
  * host scoring (`device_rank=False`, `return_distmat`, or dukev after
    re-ranking, whose device scorer is exact only for tie-free
    distances): agrl_torch.metrics scores a (Q, G) matrix copied to the
    host, in the C++ scorers of native/rank_eval.cpp where they build (mars,
    market1501, cuhk03) and in NumPy otherwise, as agrl_tpu does. With `re_rank` that matrix is still re-ranked on the
    features' device unless `device_rank=False`; agrl_tpu re-ranks on the
    host in all three cases, and the two re-rankings agree within 2e-4.
    With `device_rank=False` the distances are computed on the device
    and re-ranked on the host by the host algorithm, as in agrl_tpu.

msppn and msppgn pad their `all` adjacency through their own
`pad_eval_adjacency` hook, as agrl_tpu's Evaluator calls it.

The mesh Evaluator (`extract(..., mesh=)`, `evaluate(..., mesh=)`, the
process-group form of parallel.make_mesh; agrl_tpu/engine/evaluator.py
`_make_fwd_runner`, `_mesh_put`): every rank reads the whole query and
gallery (the eval loaders are not process-sharded), each device batch is
split into dp equal contiguous parts, one a dp index, and the features are
gathered back in order over the dp group, so every rank holds the whole
(N, D) features. Under an mp axis the weights sharded over it are
gathered whole first and the blocks restored after
(parallel.whole_weights), as agrl_tpu's `_mesh_put` replicates the
variables over the whole mesh: the mp ranks of one dp index run the same
part of each batch, and a graph layer's eval forward is K1 on the whole
W, never on a block.
A batch that does not divide by dp pads, as agrl_tpu's does: zero frames
with an all-ones adjacency (evenly, dense/skipdense), or, under `all`,
zero frames, a zero adjacency and a frame mask keeping frame 0; the
padding rows are dropped. Under `all` a bucket's batch is rounded up to a
multiple of dp. The ranking then runs on every rank on the whole
features, so every rank prints the same CMC and mAP; the host-scored path
builds its (Q, G) matrix from the dp ranks' gallery stripes
(ops/distmat.py `sharded_distmat`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from agrl_torch import resolve_device
from agrl_torch.data.transforms import preprocess_clips
from agrl_torch.metrics import evaluate_rank, re_ranking
from agrl_torch.ops.distmat import compute_distmat, sharded_distmat
from agrl_torch.ops.rank import (
    cuhk03_cmc_map,
    dukev_cmc_map,
    evaluate_mars_device,
    market1501_cmc_map,
    mars_cmc_map_from_distmat,
)
from agrl_torch.ops.rerank import re_ranking_from_features
from agrl_torch.parallel import whole_weights
from agrl_torch.utils.avgmeter import AverageMeter

PROTOCOLS = ("mars", "market1501", "cuhk03", "dukev")
_DEVICE_SCORERS = {
    "mars": mars_cmc_map_from_distmat,
    "market1501": market1501_cmc_map,
    "dukev": dukev_cmc_map,
}


def serving_state(model) -> dict:
    """The tensors the eval forward reads: every floating-point parameter
    and buffer, by state-dict name (not `num_batches_tracked`)."""
    named = [*model.named_parameters(), *model.named_buffers()]
    return {name: t for name, t in named if t.is_floating_point()}


def eval_program(model, bf16: bool = False):
    """The eval forward as a function of its weights:
    fn(state, imgs_u8, adjs, frame_mask=None) -> (B, D) float32, with
    `state` a {name: tensor} dict of `serving_state(model)`'s names (None:
    the model's own tensors). Preprocess (normalize) runs on the inputs'
    device. With `bf16`, agrl_tpu's `_cast` (agrl_tpu/engine/evaluator.py:
    50-62): every float32 tensor of the state, the normalized pixels and
    the adjacency are rounded to bf16, then the model runs at its own
    `dtype`: a float32 model computes in float32 on the rounded values, a
    dtype-None model in bf16 up to layer4, a bfloat16 one in bf16 up to
    layer4 (agrl_torch/models/vmgn.py). The live model's weights are never
    written: the rounded tensors go in through torch.func.functional_call.
    The Evaluator and the exported artifact (engine/export.py) run this one
    definition."""

    def fn(state, imgs, adjs, frame_mask=None):
        x = preprocess_clips(imgs)
        a = adjs.float()
        if bf16:
            if state is None:
                state = serving_state(model)
            state = {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
                     for k, v in state.items()}
            x, a = x.to(torch.bfloat16), a.to(torch.bfloat16)
        kw = {} if frame_mask is None else {"frame_mask": frame_mask}
        if state is None:
            out = model(x, a, **kw)
        else:
            out = torch.func.functional_call(model, state, (x, a), kw, strict=False)
        return out.float()

    return fn


def make_eval_forward(model, device, bf16: bool = False):
    """The eval forward: uint8 clips (B, S, H, W, 3) and adjacencies
    (B, V, V) as numpy arrays or tensors in, (B, D) float32 features out,
    on `device`, through `eval_program(model, bf16)` on the model's live
    weights, in inference mode. A (B, S) 0/1 `frame_mask` goes to a model
    that takes one (`supports_frame_mask`).

    Sets both TF32 switches off — process-wide — so every fp32 product
    and convolution runs in full fp32 (the l2 affinity and the cosine
    distances need it); bf16 convolutions do not use TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model.eval()
    program = eval_program(model, bf16)

    def fwd(imgs, adjs, frame_mask=None) -> torch.Tensor:
        x = torch.as_tensor(imgs).to(device)
        a = torch.as_tensor(adjs, dtype=torch.float32).to(device)
        if frame_mask is not None:
            frame_mask = torch.as_tensor(frame_mask, dtype=torch.float32).to(device)
        with torch.inference_mode():
            return program(None, x, a, frame_mask)

    return fwd


class Evaluator:
    def __init__(self, model, test_sample: str = "evenly", pool: str = "avg",
                 bf16: bool = False, clip_batch: int = 64, device="cuda"):
        if pool not in ("avg", "max"):
            raise ValueError(f"pool must be avg or max, got {pool!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.test_sample = test_sample
        self.pool = pool
        self.bf16 = bf16
        self.clip_batch = clip_batch
        self._fwd = make_eval_forward(self.model, self.device, bf16)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _runner(self, mesh, adj_pad: float = 1.0):
        """The forward of one device batch: `self._fwd`, or under a
        process-group mesh this dp index's part of the batch (padded to a
        multiple of dp: zero frames, adjacency `adj_pad`, a frame mask
        keeping frame 0) with every dp rank's features gathered back in
        order."""
        if mesh is None:
            return self._fwd
        if not mesh.distributed:
            raise ValueError("the Evaluator takes the process-group form of the mesh")
        if not mesh.holds(self.device):
            raise ValueError(f"the Evaluator is on {self.device}, this rank's device is "
                             f"{mesh.device}")
        from agrl_torch.parallel import gather_rows

        def run(imgs, adjs, frame_mask=None):
            imgs, adjs = np.asarray(imgs), np.asarray(adjs)
            n = imgs.shape[0]
            pad = (-n) % mesh.dp
            if pad:
                imgs = np.concatenate([imgs, np.zeros((pad, *imgs.shape[1:]), imgs.dtype)])
                adjs = np.concatenate([adjs, np.full((pad, *adjs.shape[1:]), adj_pad,
                                                     adjs.dtype)])
                if frame_mask is not None:
                    fpad = np.zeros((pad, frame_mask.shape[1]), np.float32)
                    fpad[:, 0] = 1.0  # the masked mean never divides by zero
                    frame_mask = np.concatenate([frame_mask, fpad])
            k = (n + pad) // mesh.dp
            part = slice(mesh.dp_index * k, (mesh.dp_index + 1) * k)
            f = self._fwd(imgs[part], adjs[part],
                          None if frame_mask is None else frame_mask[part])
            with torch.inference_mode():
                return gather_rows(f, mesh)[:n]

        return run

    def extract(self, loader, name: str = "query", mesh=None):
        """Returns (features (N, D) on the device, pids, camids, batch_time
        meter). Batch times are host time around each forward, synchronized
        with the card. The model goes to eval mode first: a trainer between
        two evaluations leaves it in train mode. `mesh`: the process-group
        mesh whose dp ranks split each batch, its mp shards gathered whole
        for the extraction (module docstring)."""
        self.model.eval()
        with whole_weights(self.model):
            if self.test_sample in ("dense", "skipdense"):
                return self._extract_dense_packed(loader, name, mesh)
            if self.test_sample == "all" and getattr(self.model, "supports_frame_mask", False):
                return self._extract_all_bucketed(loader, name, mesh)
            return self._extract_evenly(loader, name, mesh)

    def _extract_evenly(self, loader, name: str, mesh=None):
        """One forward a loader batch (evenly, and `all` for a model that
        takes no frame mask: one whole tracklet a batch)."""
        run = self._runner(mesh)
        feats, pids, camids = [], [], []
        batch_time = AverageMeter()
        for imgs, bpids, bcamids, adjs in loader:
            t0 = time.time()
            feats.append(run(imgs, adjs))
            self._sync()
            batch_time.update(time.time() - t0)
            pids.extend(np.asarray(bpids).tolist())
            camids.extend(np.asarray(bcamids).tolist())
        if not feats:
            raise ValueError(f"{name} loader yielded no tracklets")
        features = torch.cat(feats, dim=0)
        _print_extracted(name, features)
        return features, np.asarray(pids), np.asarray(camids), batch_time

    @staticmethod
    def _bucket_len(num: int, lo: int = 8) -> int:
        """Bucket ladder of `--test-sample all`: geometric ~1.25x steps
        rounded up to multiples of 8, floored at `lo` (8, 16, 24, 32, 40,
        56, 72, 96, 120, 152, 192, 240, 304, 384, 480, 600, 752, 944, 1184,
        ...; agrl_tpu/engine/evaluator.py:180-192)."""
        b = lo
        while b < num:
            b = -(-5 * b // 32) * 8  # ceil(b * 1.25 / 8) * 8
        return b

    def _extract_all_bucketed(self, loader, name: str, mesh=None):
        """`all` extraction: each tracklet pads to `_bucket_len` frames with a
        frame mask (masked global mean, masked graph rows, masked attention:
        models/vmgn.py), so its feature equals the unpadded forward's, and
        same-bucket tracklets batch together up to clip_batch * 8 frames.
        The adjacency pads with a trailing zero block (frame-major
        vertices), or through the model's `pad_eval_adjacency` (msppn and
        msppgn: split-major vertices over three scales, whose entries
        scatter to their padded positions, models/graphnet.py). A bucket's
        last batch runs at its own size. Loader batches
        hold whole tracklets: imgs (b, num, H, W, 3), adjs (b, V, V).
        Under a mesh a bucket's batch rounds up to a multiple of dp."""
        frame_budget = max(self.clip_batch, 1) * 8
        dp = 1 if mesh is None else mesh.dp
        run = self._runner(mesh, adj_pad=0.0)
        batch_time = AverageMeter()
        pend: dict[int, list] = {}  # bucket -> [(idx, imgs, adj, fmask)]
        out: dict[int, torch.Tensor] = {}  # idx -> feature row
        pids, camids = [], []
        n_items = 0

        def ab_for(Sp: int) -> int:
            return -(-max(1, frame_budget // Sp) // dp) * dp

        def flush(Sp: int, final: bool = False):
            q = pend[Sp]
            ab = ab_for(Sp)
            while q and (final or len(q) >= ab):
                chunk = q[:ab]
                del q[:ab]
                t0 = time.time()
                imgs = np.stack([c[1] for c in chunk])
                adjs = np.stack([c[2] for c in chunk])
                fmasks = np.stack([c[3] for c in chunk])
                f = run(imgs, adjs, fmasks)
                self._sync()
                batch_time.update(time.time() - t0)
                for (idx, *_), row in zip(chunk, f):
                    out[idx] = row

        pad_adj = getattr(self.model, "pad_eval_adjacency", None)
        for imgs, bpids, bcamids, adjs in loader:
            for bi in range(imgs.shape[0]):
                clip, adj = imgs[bi], adjs[bi]  # (num, H, W, 3), (V, V)
                num = clip.shape[0]
                Sp = self._bucket_len(num)
                if pad_adj is not None:
                    # the split-major archs place the entries themselves, also
                    # at Sp == num: one that ignores the adjacency maps any
                    # layout to its own per-bucket shape
                    adj = pad_adj(adj, num, Sp)
                elif adj.shape[0] % num:
                    raise ValueError(f"adjacency ({adj.shape[0]} vertices) is not a multiple of "
                                     f"the frame count ({num}): bucketed 'all' eval needs the "
                                     "frame-major layout")
                if Sp > num:  # trailing pad frames
                    clip = np.concatenate([clip, np.zeros((Sp - num, *clip.shape[1:]), clip.dtype)])
                    if pad_adj is None:  # frame-major: a trailing zero block
                        Vp = Sp * (adj.shape[0] // num)
                        adj_p = np.zeros((Vp, Vp), adj.dtype)
                        adj_p[: adj.shape[0], : adj.shape[1]] = adj
                        adj = adj_p
                fmask = np.zeros(Sp, np.float32)
                fmask[:num] = 1.0
                pend.setdefault(Sp, []).append((n_items, clip, adj, fmask))
                pids.append(int(np.asarray(bpids)[bi]))
                camids.append(int(np.asarray(bcamids)[bi]))
                n_items += 1
                if len(pend[Sp]) >= ab_for(Sp):
                    flush(Sp)
        for Sp in sorted(pend):
            flush(Sp, final=True)

        if not n_items:
            raise ValueError(f"{name} loader yielded no tracklets")
        features = torch.stack([out[i] for i in range(n_items)])
        _print_extracted(name, features)
        return features, np.asarray(pids), np.asarray(camids), batch_time

    def _extract_dense_packed(self, loader, name: str, mesh=None):
        """dense/skipdense extraction with cross-tracklet clip packing: the
        clip streams of consecutive tracklets fill (clip_batch, ...) device
        batches (the last one runs at its own size), a tracklet's clips may straddle
        two batches, and its avg/max pooling accumulates in float64 on the
        host as slices arrive: the same mean/max over the same clips.
        Loader batches hold whole tracklets: imgs (b, n, S, H, W, 3), adjs
        (b, n, V, V)."""
        CB = self.clip_batch
        run = self._runner(mesh)
        batch_time = AverageMeter()
        pend_imgs, pend_adjs, pend_seg = [], [], []  # the flat clip stream
        pids, camids = [], []
        acc = {}  # tracklet idx -> [sum or max (D,) float64, clip count]

        def accumulate(f, segs):
            for row, seg in zip(f, segs):
                entry = acc.get(seg)
                if entry is None:
                    acc[seg] = [row.astype(np.float64), 1]
                elif self.pool == "avg":
                    entry[0] += row
                    entry[1] += 1
                else:
                    np.maximum(entry[0], row, out=entry[0])
                    entry[1] += 1

        def flush(final: bool = False):
            while pend_imgs and (final or len(pend_imgs) >= CB):
                take = min(CB, len(pend_imgs))
                t0 = time.time()
                imgs = np.stack(pend_imgs[:take])
                adjs = np.stack(pend_adjs[:take])
                segs = pend_seg[:take]
                del pend_imgs[:take], pend_adjs[:take], pend_seg[:take]
                f = run(imgs, adjs).cpu().numpy()  # syncs with the card
                batch_time.update(time.time() - t0)
                accumulate(f, segs)

        n_tracklets = 0
        for imgs, bpids, bcamids, adjs in loader:
            for bi in range(imgs.shape[0]):
                pids.append(int(np.asarray(bpids)[bi]))
                camids.append(int(np.asarray(bcamids)[bi]))
                for ci in range(imgs.shape[1]):
                    pend_imgs.append(imgs[bi, ci])
                    pend_adjs.append(adjs[bi, ci])
                    pend_seg.append(n_tracklets)
                n_tracklets += 1
            flush()
        flush(final=True)

        if not acc:
            raise ValueError(f"{name} loader yielded no tracklets")
        D = next(iter(acc.values()))[0].shape[0]
        features = np.empty((n_tracklets, D), np.float32)
        for seg in range(n_tracklets):
            total, cnt = acc[seg]
            features[seg] = total / cnt if self.pool == "avg" else total
        features = torch.from_numpy(features).to(self.device)
        _print_extracted(name, features)
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
        mesh=None,
    ):
        """Returns (rank-1, mAP), or the (Q, G) numpy distance matrix
        (re-ranked if asked) with `return_distmat`, and prints agrl_tpu's
        result block. `mesh`: the process-group mesh whose dp ranks split
        the extraction (its mp shards gathered whole once for both splits);
        every rank ranks the whole features and returns the same result
        (module docstring)."""
        if metric_protocol not in PROTOCOLS:
            raise ValueError(f"metric_protocol must be one of {PROTOCOLS}, got {metric_protocol!r}")
        kw = {} if mesh is None else {"mesh": mesh}  # without one, today's call
        with whole_weights(self.model):
            qf, q_pids, q_camids, bt_q = self.extract(queryloader, "query", **kw)
            gf, g_pids, g_camids, bt_g = self.extract(galleryloader, "gallery", **kw)
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
            if mesh is None:
                distmat = compute_distmat(qf, gf, dist_metric).cpu().numpy()
            else:
                distmat = sharded_distmat(mesh, qf, gf, dist_metric).cpu().numpy()
            if re_rank:
                print("Applying person re-ranking ...")
                qq = compute_distmat(qf, qf, dist_metric).cpu().numpy()
                gg = compute_distmat(gf, gf, dist_metric).cpu().numpy()
                distmat = re_ranking(distmat, qq, gg)

        print("Computing CMC and mAP")
        cmc, mAP = evaluate_rank(distmat, *ids, use_native=True,
                                 **{f"use_metric_{metric_protocol}": True})
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


def _print_extracted(name, features):
    print(
        f"Extracted features for {name} set, obtained "
        f"{features.shape[0]}-by-{features.shape[1]} matrix"
    )


def _print_results(cmc, mAP, ranks):
    print("Results ----------")
    print(f"mAP: {mAP:.2%}")
    print("CMC curve")
    for r in ranks:
        if r <= len(cmc):  # tiny galleries truncate the CMC curve
            print(f"Rank-{r:<3}: {cmc[r - 1]:.2%}")
    print("------------------")
