"""The port's `evenly` data path, device MARS ranking and Evaluator held
against agrl_tpu, on a synthetic dataset materialized at 64x32."""

import jax
import numpy as np
import pytest
import torch

from agrl_torch.data.datasets import init_vidreid_dataset as torch_dataset
from agrl_torch.data.loader import ClipLoader as TorchClipLoader
from agrl_torch.data.loader import VideoClipDataset as TorchClipDataset
from agrl_torch.engine.evaluator import Evaluator as TorchEvaluator
from agrl_torch.models import build_model
from agrl_torch.models.weight_convert import from_jax_variables
from agrl_torch.ops.rank import evaluate_mars_device as torch_mars
from agrl_tpu.data.datasets import init_vidreid_dataset as jax_dataset
from agrl_tpu.data.loader import ClipLoader as JaxClipLoader
from agrl_tpu.data.loader import VideoClipDataset as JaxClipDataset
from agrl_tpu.engine.evaluator import Evaluator as JaxEvaluator
from agrl_tpu.models import init_model as jax_init_model
from agrl_tpu.models import init_params
from agrl_tpu.ops.rank import evaluate_mars_device as jax_mars

torch.set_num_threads(2)

H, W, S = 64, 32, 4
DATA = dict(num_pids=4, tracklets_per_pid=2, frames_per_tracklet=(3, 10),
            height=H, width=W, verbose=False)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    return torch_dataset("synthetic", root=str(root), **DATA), jax_dataset(
        "synthetic", root=str(root), materialize=False, **DATA
    )


def _clip_datasets(tds, jds, split):
    common = dict(seq_len=S, sample="evenly", height=H, width=W)
    return (
        TorchClipDataset(getattr(tds, split), pose_info=tds.process_poses, **common),
        JaxClipDataset(getattr(jds, split), pose_info=jds.process_poses, decode="pil", **common),
    )


def test_synthetic_catalog_and_frames_match(synthetic, tmp_path):
    tds, jds = synthetic
    for split in ("train", "query", "gallery"):
        assert getattr(tds, split) == getattr(jds, split)
    assert tds.process_poses.keys() == jds.process_poses.keys()
    for k, v in tds.process_poses.items():
        np.testing.assert_array_equal(v, jds.process_poses[k])
    # agrl_tpu writing the same catalog elsewhere produces the same pixels
    from PIL import Image

    jax_dataset("synthetic", root=str(tmp_path), **DATA)
    paths = [p for split in (tds.query, tds.gallery) for t in split for p in t[0]]
    for p in paths[:: max(1, len(paths) // 20)]:
        other = p.replace(str(p).split("synthetic-mars")[0], str(tmp_path) + "/")
        np.testing.assert_array_equal(np.asarray(Image.open(p)), np.asarray(Image.open(other)))


@pytest.mark.parametrize("split", ["query", "gallery"])
def test_evenly_items_and_batches_bit_equal(synthetic, split):
    tset, jset = _clip_datasets(*synthetic, split)
    assert len(tset) == len(jset) and tset.num_vertices == jset.num_vertices
    for i in range(len(tset)):
        t_imgs, t_pid, t_cam, t_adj = tset.get_item(i)
        j_imgs, j_pid, j_cam, j_adj = jset.get_item(i)
        assert (t_pid, t_cam) == (j_pid, j_cam)
        assert t_imgs.dtype == j_imgs.dtype == np.uint8
        np.testing.assert_array_equal(t_imgs, j_imgs)
        np.testing.assert_array_equal(t_adj, j_adj)
    tb = list(TorchClipLoader(tset, batch_size=3))
    jb = list(JaxClipLoader(jset, batch_size=3, num_workers=1))
    assert len(tb) == len(jb) == 3  # 8 tracklets: a short last batch
    for t, j in zip(tb, jb):
        for a, b in zip(t, j):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["evenly", "random", "all", "consecutive",
                                    "dense", "restricted", "skipdense"])
def test_sampling_copy_matches_jax(method):
    from agrl_torch.data.sampling import sample_clip_indices as torch_sample
    from agrl_tpu.data.sampling import sample_clip_indices as jax_sample

    for num in (1, 5, 8, 13, 16, 40):
        got = torch_sample(num, 8, method, np.random.RandomState(num))
        want = jax_sample(num, 8, method, np.random.RandomState(num))
        np.testing.assert_array_equal(got, want)


def test_pose_json_copy_matches_jax(tmp_path):
    import json

    from agrl_torch.data.pose import load_pose_json as torch_load
    from agrl_tpu.data.pose import load_pose_json as jax_load

    rng = np.random.RandomState(0)

    def body(score):
        return {"joints": rng.rand(54).tolist(), "score": score}

    raw = {
        "0001C1T0001F001.jpg": {"bodies": [body(0.9)]},
        "0001C1T0001F002.jpg": {"bodies": [body(0.5), body(0.56), body(0.8), body(0.85)]},
    }
    path = tmp_path / "pose.json"
    path.write_text(json.dumps(raw))
    got, want = torch_load(str(path)), jax_load(str(path))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("num_g,metric",[(60, "cosine"), (23, "cosine"), (60, "euclidean")])
def test_mars_ranking_matches_jax(num_g, metric):
    """Repeated pids and cameras; a 23-entry gallery is smaller than
    max_rank (50), which exercises the filler index and the sentinel."""
    rng = np.random.RandomState(num_g)
    qf = rng.randn(17, 64).astype(np.float32)
    gf = rng.randn(num_g, 64).astype(np.float32)
    q_pids = rng.randint(0, 6, 17)
    g_pids = rng.randint(-1, 6, num_g)
    q_cams = rng.randint(0, 3, 17)
    g_cams = rng.randint(0, 3, num_g)
    ids = (q_pids, g_pids, q_cams, g_cams)
    j_cmc, j_map = jax_mars(qf, gf, *ids, metric=metric, tile=16)
    t_cmc, t_map = torch_mars(torch.from_numpy(qf), torch.from_numpy(gf), *ids,
                              metric=metric, tile=16)
    np.testing.assert_allclose(t_cmc.numpy(), np.asarray(j_cmc), atol=1e-6)
    np.testing.assert_allclose(float(t_map), float(j_map), atol=1e-6)


def test_evaluator_matches_jax(synthetic):
    tds, jds = synthetic
    jmodel = jax_init_model("vmgn_tiny", num_classes=tds.num_train_pids)
    variables = init_params(jmodel, jax.random.PRNGKey(1), seq_len=S, height=H, width=W)
    variables = jax.tree.map(np.asarray, dict(variables))
    tmodel = build_model("vmgn_tiny", num_classes=tds.num_train_pids)
    from_jax_variables(variables, tmodel)

    tq, jq = _clip_datasets(tds, jds, "query")
    tg, jg = _clip_datasets(tds, jds, "gallery")
    t_r1, t_map = TorchEvaluator(tmodel, device="cpu").evaluate(
        TorchClipLoader(tq, 4), TorchClipLoader(tg, 4), dist_metric="cosine"
    )
    j_r1, j_map = JaxEvaluator(jmodel).evaluate(
        variables, JaxClipLoader(jq, 4, num_workers=1), JaxClipLoader(jg, 4, num_workers=1),
        dist_metric="cosine",
    )
    assert abs(t_r1 - float(j_r1)) < 1e-6
    assert abs(t_map - j_map) < 1e-6
