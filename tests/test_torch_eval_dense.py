"""The port's dense, skipdense and `all` items and its packed dense
extraction held against agrl_tpu, on a synthetic dataset at 64x32.

vmgn_tiny with agrl_tpu's random weights bridged into the port; seq_len 4
over 3-10-frame tracklets gives 1-3 clips a tracklet, and a clip_batch of
2 makes a tracklet's clips straddle two device batches.
"""

import jax
import numpy as np
import pytest
import torch

from agrl_torch.data.datasets import init_vidreid_dataset as torch_dataset
from agrl_torch.data.loader import ClipLoader as TorchClipLoader
from agrl_torch.data.loader import VideoClipDataset as TorchClipDataset
from agrl_torch.data.sampling import num_clips as torch_num_clips
from agrl_torch.engine.evaluator import Evaluator as TorchEvaluator
from agrl_torch.models import build_model
from agrl_torch.models.weight_convert import from_jax_variables
from agrl_tpu.data.datasets import init_vidreid_dataset as jax_dataset
from agrl_tpu.data.loader import ClipLoader as JaxClipLoader
from agrl_tpu.data.loader import VideoClipDataset as JaxClipDataset
from agrl_tpu.data.sampling import num_clips as jax_num_clips
from agrl_tpu.engine.evaluator import Evaluator as JaxEvaluator
from agrl_tpu.models import init_model as jax_init_model
from agrl_tpu.models import init_params

torch.set_num_threads(2)

H, W, S = 64, 32, 4
CLIP_BATCH = 2
DATA = dict(num_pids=4, tracklets_per_pid=2, frames_per_tracklet=(3, 10),
            height=H, width=W, verbose=False)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    return torch_dataset("synthetic", root=str(root), **DATA), jax_dataset(
        "synthetic", root=str(root), materialize=False, **DATA
    )


def _clip_datasets(tds, jds, split, sample):
    common = dict(seq_len=S, sample=sample, height=H, width=W)
    return (
        TorchClipDataset(getattr(tds, split), pose_info=tds.process_poses, **common),
        JaxClipDataset(getattr(jds, split), pose_info=jds.process_poses, decode="pil", **common),
    )


def test_num_clips_matches_agrl_tpu():
    for method in ("dense", "skipdense", "evenly", "all"):
        for num in range(1, 40):
            assert torch_num_clips(num, 8, method) == jax_num_clips(num, 8, method)
    assert torch_num_clips(1500, 8, "dense") == jax_num_clips(1500, 8, "dense") == 126


@pytest.mark.parametrize("sample", ["dense", "skipdense", "all"])
def test_items_and_loader_batches_bit_equal(synthetic, sample):
    """Items bit-equal to agrl_tpu's: dense/skipdense (n, S, H, W, 3) with
    (n, V, V) graphs, all (num, H, W, 3) with (7 num, 7 num); and the
    batch-of-one loader's batches."""
    tset, jset = _clip_datasets(*synthetic, "gallery", sample)
    for i in range(len(tset)):
        t_item, j_item = tset.get_item(i), jset.get_item(i)
        num = min(len(tset.tracklets[i][0]), tset.max_len)
        n = torch_num_clips(num, S, sample)
        want_shape = (n, S, H, W, 3) if sample != "all" else (num, H, W, 3)
        assert t_item[0].shape == want_shape and t_item[3].shape[-1] == 7 * want_shape[-4]
        assert t_item[1:3] == j_item[1:3]
        for a, b in (t_item[0], j_item[0]), (t_item[3], j_item[3]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for t, j in zip(TorchClipLoader(tset, 1), JaxClipLoader(jset, 1, num_workers=1)):
        for a, b in zip(t, j):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def models(synthetic):
    tds = synthetic[0]
    jmodel = jax_init_model("vmgn_tiny", num_classes=tds.num_train_pids)
    variables = init_params(jmodel, jax.random.PRNGKey(3), seq_len=S, height=H, width=W)
    variables = jax.tree.map(np.asarray, dict(variables))
    tmodel = build_model("vmgn_tiny", num_classes=tds.num_train_pids)
    from_jax_variables(variables, tmodel)
    return jmodel, variables, tmodel


def _loaders(synthetic, sample):
    out = {}
    for split in ("query", "gallery"):
        tset, jset = _clip_datasets(*synthetic, split, sample)
        out[split] = TorchClipLoader(tset, 1), JaxClipLoader(jset, 1, num_workers=1)
    return out


@pytest.mark.parametrize("sample,pool", [("dense", "avg"), ("dense", "max"),
                                         ("skipdense", "avg")])
def test_packed_extraction_matches_agrl_tpu(synthetic, models, sample, pool):
    """Features (5e-4, the eval forward's bar), pids and camids of the
    packed extraction, and the same number of device batches; some
    tracklet has more clips than a batch holds, so it straddles two. The
    device batches hold the tracklets' clips and no padding clips."""
    jmodel, variables, tmodel = models
    tl, jl = _loaders(synthetic, sample)["gallery"]
    n = [torch_num_clips(min(len(t[0]), 1000), S, sample) for t in tl.dataset.tracklets]
    assert max(n) > CLIP_BATCH
    ev = TorchEvaluator(tmodel, test_sample=sample, pool=pool, clip_batch=CLIP_BATCH, device="cpu")
    sizes, inner = [], ev._fwd

    def counting(imgs, adjs):
        sizes.append(imgs.shape[0])
        return inner(imgs, adjs)

    ev._fwd = counting
    t_f, t_pids, t_cams, t_bt = ev.extract(tl, "gallery")
    assert sum(sizes) == sum(n) and max(sizes) == CLIP_BATCH
    j_f, j_pids, j_cams, j_bt = JaxEvaluator(
        jmodel, test_sample=sample, pool=pool, clip_batch=CLIP_BATCH
    ).extract(variables, jl, "gallery")
    assert isinstance(t_f, torch.Tensor) and t_f.dtype == torch.float32
    np.testing.assert_allclose(t_f.numpy(), j_f, atol=5e-4, rtol=1e-4)
    np.testing.assert_array_equal(t_pids, j_pids)
    np.testing.assert_array_equal(t_cams, j_cams)
    assert t_bt.count == j_bt.count == -(-sum(n) // CLIP_BATCH)


def test_dense_evaluate_matches_agrl_tpu(synthetic, models):
    """CMC/mAP of dense avg-pooled features, MARS protocol on the device
    path of both: equal within 1e-6."""
    jmodel, variables, tmodel = models
    loaders = _loaders(synthetic, "dense")
    kw = dict(dist_metric="cosine")
    t_r1, t_map = TorchEvaluator(tmodel, test_sample="dense", clip_batch=CLIP_BATCH,
                                 device="cpu").evaluate(loaders["query"][0],
                                                        loaders["gallery"][0], **kw)
    j_r1, j_map = JaxEvaluator(jmodel, test_sample="dense", clip_batch=CLIP_BATCH).evaluate(
        variables, loaders["query"][1], loaders["gallery"][1], **kw)
    assert abs(t_r1 - float(j_r1)) < 1e-6
    assert abs(t_map - float(j_map)) < 1e-6
