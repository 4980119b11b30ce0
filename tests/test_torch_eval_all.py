"""The port's bucketed `--test-sample all` evaluation held against agrl_tpu.

vmgn_tiny (depth 1,1,1,1, full width) at 32x16 with agrl_tpu's random
weights bridged into the port: the bucket ladder, the masked VMGN forward
(padding frames drop out of the global mean, the graph layers and the
temporal attention), the Evaluator's bucketed extraction over tracklets
of three buckets (the largest with 168 graph vertices, more than the
card's short kernel schedule holds) and its CMC/mAP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrl_torch.engine.evaluator import Evaluator as TorchEvaluator
from agrl_torch.models import build_model
from agrl_torch.models.weight_convert import from_jax_variables
from agrl_tpu.engine.evaluator import Evaluator as JaxEvaluator
from agrl_tpu.models import init_model as jax_init_model
from agrl_tpu.models import init_params

torch.set_num_threads(2)

H, W, PARTS = 32, 16, 7
CLIP_BATCH = 2  # a frame budget of 16: 2 tracklets of bucket 8, 1 of 16 or 24 a batch
# (pid, camid, frames): buckets 8, 16 and 24 (V = 168) in both splits
QUERY = [(0, 0, 3), (1, 0, 12), (2, 0, 20)]
GALLERY = [(0, 1, 5), (1, 1, 17), (2, 1, 9), (0, 0, 4), (1, 1, 14), (3, 1, 22)]


@pytest.fixture(scope="module")
def models():
    jmodel = jax_init_model("vmgn_tiny", num_classes=4)
    variables = init_params(jmodel, jax.random.PRNGKey(0), seq_len=4, height=H, width=W)
    variables = jax.tree.map(np.asarray, dict(variables))
    tmodel = build_model("vmgn_tiny", num_classes=4)
    from_jax_variables(variables, tmodel)
    return jmodel, variables, tmodel.eval()


def _batches(tracklets, seed):
    """`all` loader batches, one tracklet each: imgs (1, num, H, W, 3)
    uint8, adj (1, V, V) with V = num * PARTS."""
    rng = np.random.RandomState(seed)
    out = []
    for pid, camid, num in tracklets:
        V = num * PARTS
        imgs = (rng.rand(1, num, H, W, 3) * 255).astype(np.uint8)
        adj = (rng.rand(1, V, V) > 0.5).astype(np.float32)
        out.append((imgs, np.asarray([pid]), np.asarray([camid]), adj))
    return out


def _padded(rng, B, num, Sp):
    """The same clips unpadded and padded to Sp frames with a frame mask."""
    V, Vp = num * PARTS, Sp * PARTS
    x = rng.rand(B, num, H, W, 3).astype(np.float32)
    adj = (rng.rand(B, V, V) > 0.4).astype(np.float32)
    xp = np.zeros((B, Sp, H, W, 3), np.float32)
    xp[:, :num] = x
    adjp = np.zeros((B, Vp, Vp), np.float32)
    adjp[:, :V, :V] = adj
    fmask = np.zeros((B, Sp), np.float32)
    fmask[:, :num] = 1.0
    return (x, adj), (xp, adjp, fmask)


def test_bucket_len_matches_agrl_tpu():
    got = [TorchEvaluator._bucket_len(n) for n in range(1, 1001)]
    assert got == [JaxEvaluator._bucket_len(n) for n in range(1, 1001)]
    assert got[999] == 1184  # MARS's max_len lands in the top bucket: V = 8288


@pytest.mark.parametrize("num,Sp", [(3, 8), (11, 16)])
def test_masked_forward_equals_unpadded_and_agrl_tpu(models, num, Sp):
    """The port's masked forward equals its own unpadded forward (2e-4,
    agrl_tpu's bar in tests/test_all_bucketed_eval.py) and agrl_tpu's masked
    forward on the same weights (5e-4, the eval forward's bar)."""
    jmodel, variables, tmodel = models
    (x, adj), (xp, adjp, fmask) = _padded(np.random.RandomState(num), 2, num, Sp)
    with torch.inference_mode():
        unpadded = tmodel(torch.from_numpy(x), torch.from_numpy(adj)).numpy()
        got = tmodel(torch.from_numpy(xp), torch.from_numpy(adjp),
                     frame_mask=torch.from_numpy(fmask)).numpy()
    want = np.asarray(jmodel.apply(variables, jnp.asarray(xp), jnp.asarray(adjp), train=False,
                                   frame_mask=jnp.asarray(fmask)))
    np.testing.assert_allclose(got, unpadded, atol=2e-4, rtol=0)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-4)


def test_masked_forward_is_eval_only(models):
    tmodel = build_model("vmgn_tiny", num_classes=4).train()
    _, (xp, adjp, fmask) = _padded(np.random.RandomState(0), 2, 3, 8)
    with pytest.raises(ValueError, match="eval-only"):
        tmodel(torch.from_numpy(xp), torch.from_numpy(adjp), frame_mask=torch.from_numpy(fmask))


def _memoized(evaluator, call_extract):
    """Each split is extracted once; evaluate() reuses the features."""
    cache, extract = {}, evaluator.extract

    def cached(*args, **kwargs):  # agrl_tpu's evaluate passes keep_on_device and mesh
        name = args[-1]
        if name not in cache:
            cache[name] = extract(*args)
        return cache[name]

    evaluator.extract = cached
    call_extract(evaluator)
    return evaluator, cache


@pytest.fixture(scope="module")
def extracted(models):
    jmodel, variables, tmodel = models
    splits = {"query": _batches(QUERY, 1), "gallery": _batches(GALLERY, 2)}
    t_eval, t_feats = _memoized(
        TorchEvaluator(tmodel, test_sample="all", clip_batch=CLIP_BATCH, device="cpu"),
        lambda ev: [ev.extract(splits[n], n) for n in splits])
    j_eval, j_feats = _memoized(
        JaxEvaluator(jmodel, test_sample="all", clip_batch=CLIP_BATCH),
        lambda ev: [ev.extract(variables, splits[n], n) for n in splits])
    return dict(splits=splits, t_eval=t_eval, t_feats=t_feats, j_eval=j_eval, j_feats=j_feats,
                variables=variables)


@pytest.mark.parametrize("split", ["query", "gallery"])
def test_bucketed_extract_matches_agrl_tpu(extracted, split):
    """Same rows in the same order (5e-4), pids and camids; each row also
    equals the port's unpadded forward of its tracklet (2e-4)."""
    t_f, t_pids, t_cams, _ = extracted["t_feats"][split]
    j_f, j_pids, j_cams, _ = extracted["j_feats"][split]
    assert isinstance(t_f, torch.Tensor) and t_f.shape == (len(j_f), 4096)
    np.testing.assert_allclose(t_f.numpy(), np.asarray(j_f), atol=5e-4, rtol=1e-4)
    np.testing.assert_array_equal(t_pids, j_pids)
    np.testing.assert_array_equal(t_cams, j_cams)
    fwd = extracted["t_eval"]._fwd
    for (imgs, _, _, adj), row in zip(extracted["splits"][split], t_f):
        np.testing.assert_allclose(row.numpy(), fwd(imgs, adj)[0].numpy(), atol=2e-4, rtol=0)


def test_bucketed_batches_by_the_frame_budget(models):
    """Tracklets of one bucket share a batch up to clip_batch * 8 frames; a
    bucket's last batch runs at its own size, with no dummy tracklets."""
    tmodel = models[2]
    ev = TorchEvaluator(tmodel, test_sample="all", clip_batch=CLIP_BATCH, device="cpu")
    calls, inner = [], ev._fwd

    def counting(imgs, adjs, fmask):
        calls.append((imgs.shape[:2], fmask.sum(axis=1).tolist()))
        return inner(imgs, adjs, fmask)

    ev._fwd = counting
    ev.extract(_batches(GALLERY, 2), "gallery")
    # buckets: 8 <- 5, 4 (one batch of 2); 16 <- 9, 14 (two of 1); 24 <- 17, 22
    assert sorted(calls) == sorted([((2, 8), [5.0, 4.0]), ((1, 16), [9.0]), ((1, 16), [14.0]),
                                    ((1, 24), [17.0]), ((1, 24), [22.0])])
    calls.clear()
    ev.extract(_batches([(0, 0, 3)], 3), "query")
    assert calls == [((1, 8), [3.0])]


def test_evaluate_matches_agrl_tpu(extracted):
    """CMC/mAP on the bucketed features, MARS protocol on the device
    path of both: equal within 1e-6."""
    kw = dict(dist_metric="cosine")
    t_r1, t_map = extracted["t_eval"].evaluate("query", "gallery", **kw)
    j_r1, j_map = extracted["j_eval"].evaluate(extracted["variables"], "query", "gallery", **kw)
    assert abs(t_r1 - float(j_r1)) < 1e-6
    assert abs(t_map - float(j_map)) < 1e-6
