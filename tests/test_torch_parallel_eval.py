"""The mesh Evaluator at world 2 (gloo, two CPU processes) held against
agrl_tpu's single-device Evaluator.

vmgn_tiny (depth 1,1,1,1, full width) at 32x16 with agrl_tpu's random
weights bridged into the port. Every rank reads the whole in-memory query
and gallery; each device batch splits over the two ranks, and every batch
shape below leaves a ragged one that pads to a multiple of 2: evenly
(loader batches of 3 clips: 3 + 2 and 3 + 3 + 1), dense (a clip batch of
3 over tracklets of 1 to 4 clips) and `all` (a frame budget of 16:
buckets of 8, 16 and 24 frames, whose batches round up to 2 tracklets).
Both ranks must hold the same features and print the same CMC and mAP,
equal to agrl_tpu's; the host-scored (Q, G) matrix, built from the ranks'
gallery stripes, is held too.
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from agrl_torch.models import build_model
from agrl_torch.models.weight_convert import from_jax_variables
from agrl_tpu.engine.evaluator import Evaluator as JaxEvaluator
from agrl_tpu.models import init_model as jax_init_model
from agrl_tpu.models import init_params
from tests.torch_parallel_worker import spawn

torch.set_num_threads(2)

S, H, W, PARTS, CLIP_BATCH, TEST_BATCH = 4, 32, 16, 7, 2, 3
Q_IDS, G_IDS = [0, 1, 2, 3, 0], [0, 1, 2, 3, 0, 1, 4]
# `all`: (pid, camid, frames), buckets 8, 16 and 24
ALL_QUERY = [(0, 0, 3), (1, 0, 12), (2, 0, 20), (3, 0, 6)]
ALL_GALLERY = [(0, 1, 5), (1, 1, 17), (2, 1, 9), (0, 0, 4), (1, 1, 14), (3, 1, 22), (4, 1, 7)]


def _evenly(ids, cam, rng):
    """Loader batches of TEST_BATCH clips: (b, S, H, W, 3), pids, camids, (b, V, V)."""
    V = S * PARTS
    out = []
    for start in range(0, len(ids), TEST_BATCH):
        pids = np.asarray(ids[start:start + TEST_BATCH])
        b = len(pids)
        out.append(((rng.rand(b, S, H, W, 3) * 255).astype(np.uint8), pids,
                    np.full(b, cam), (rng.rand(b, V, V) > 0.5).astype(np.float32)))
    return out


def _dense(ids, cam, rng):
    """One tracklet a loader batch: (1, n, S, H, W, 3), (1, n, V, V), n of 1 to 4."""
    V = S * PARTS
    out = []
    for i, pid in enumerate(ids):
        n = 1 + (i * 3) % 4
        out.append(((rng.rand(1, n, S, H, W, 3) * 255).astype(np.uint8), np.asarray([pid]),
                    np.asarray([cam]), (rng.rand(1, n, V, V) > 0.5).astype(np.float32)))
    return out


def _all(tracklets, rng):
    out = []
    for pid, camid, num in tracklets:
        V = num * PARTS
        out.append(((rng.rand(1, num, H, W, 3) * 255).astype(np.uint8), np.asarray([pid]),
                    np.asarray([camid]), (rng.rand(1, V, V) > 0.5).astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jmodel = jax_init_model("vmgn_tiny", num_classes=4)
    variables = init_params(jmodel, jax.random.PRNGKey(0), seq_len=S, height=H, width=W)
    variables = jax.tree.map(np.asarray, dict(variables))
    model = build_model("vmgn_tiny", num_classes=4)
    from_jax_variables(variables, model)
    rng = np.random.RandomState(0)
    loaders = {"evenly": (_evenly(Q_IDS, 0, rng), _evenly(G_IDS, 1, rng)),
               "dense": (_dense(Q_IDS, 0, rng), _dense(G_IDS, 1, rng)),
               "all": (_all(ALL_QUERY, rng), _all(ALL_GALLERY, rng))}
    want = {}
    for sample, (query, gallery) in loaders.items():
        ev = JaxEvaluator(jmodel, test_sample=sample, clip_batch=CLIP_BATCH)
        with contextlib.redirect_stdout(io.StringIO()):
            qf = np.asarray(ev.extract(variables, query, "query")[0])
            gf = np.asarray(ev.extract(variables, gallery, "gallery")[0])
            r1, mAP = ev.evaluate(variables, query, gallery, dist_metric="euclidean")
            distmat = ev.evaluate(variables, query, gallery, dist_metric="euclidean",
                                  return_distmat=True)
        want[sample] = dict(qf=qf, gf=gf, rank1=float(r1), mAP=float(mAP), distmat=distmat)
    inputs = dict(num_classes=4, clip_batch=CLIP_BATCH, state=model.state_dict(),
                  loaders=loaders)
    return want, spawn("eval", inputs, tmp_path_factory.mktemp("eval"))


SAMPLES = ["evenly", "dense", "all"]


@pytest.mark.parametrize("sample", SAMPLES)
def test_ranks_hold_the_same_features_and_results(runs, sample):
    """Every rank gathers the whole features in order and prints the same
    result block: equal bit for bit across the ranks."""
    a, b = (r[sample] for r in runs[1])
    assert torch.equal(a["qf"], b["qf"]) and torch.equal(a["gf"], b["gf"])
    assert (a["rank1"], a["mAP"]) == (b["rank1"], b["mAP"])
    np.testing.assert_array_equal(a["distmat"], b["distmat"])
    # the console but its timing lines
    results = ["\n".join(line for line in c.splitlines() if "BatchTime" not in line)
               for c in (a["console"], b["console"])]
    assert results[0] == results[1] and "Rank-1" in results[0]


@pytest.mark.parametrize("sample", SAMPLES)
def test_mesh_features_and_results_match_agrl_tpu(runs, sample):
    """The features against agrl_tpu's single-device Evaluator's (atol 5e-4,
    rtol 1e-4: the eval forward's bar, tests/test_torch_eval_all.py), rank-1
    and mAP on the device path within 1e-6, the host-scored distance matrix
    within 1e-4 of its largest entry."""
    want = runs[0][sample]
    got = runs[1][0][sample]
    assert got["qf"].shape == want["qf"].shape and got["gf"].shape == want["gf"].shape
    np.testing.assert_allclose(got["qf"].numpy(), want["qf"], atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(got["gf"].numpy(), want["gf"], atol=5e-4, rtol=1e-4)
    assert abs(got["rank1"] - want["rank1"]) < 1e-6
    assert abs(got["mAP"] - want["mAP"]) < 1e-6
    np.testing.assert_allclose(got["distmat"], want["distmat"], rtol=0,
                               atol=1e-4 * np.abs(want["distmat"]).max())

