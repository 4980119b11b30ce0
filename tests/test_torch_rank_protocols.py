"""The port's device scorers (mars from a matrix, market1501, dukev,
cuhk03) and the Evaluator's ranking stage (re-ranking, protocols, host
path) held against agrl_tpu (JAX on the CPU)."""

import jax
import numpy as np
import pytest
import torch

from agrl_torch.data.datasets import init_vidreid_dataset as torch_dataset
from agrl_torch.data.loader import ClipLoader as TorchClipLoader
from agrl_torch.data.loader import VideoClipDataset as TorchClipDataset
from agrl_torch.engine import evaluator as evaluator_mod
from agrl_torch.engine.evaluator import Evaluator as TorchEvaluator
from agrl_torch.models import build_model
from agrl_torch.models.weight_convert import from_jax_variables
from agrl_torch.ops import rank as torch_rank
from agrl_tpu.data.datasets import init_vidreid_dataset as jax_dataset
from agrl_tpu.data.loader import ClipLoader as JaxClipLoader
from agrl_tpu.data.loader import VideoClipDataset as JaxClipDataset
from agrl_tpu.engine.evaluator import Evaluator as JaxEvaluator
from agrl_tpu.metrics import rank_native
from agrl_tpu.models import init_model as jax_init_model
from agrl_tpu.models import init_params
from agrl_tpu.ops import rank as jax_rank

torch.set_num_threads(2)


def _ids(seed, num_q, num_g):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 6, num_q), rng.randint(-1, 6, num_g),
            rng.randint(0, 3, num_q), rng.randint(0, 3, num_g))


@pytest.mark.parametrize("name", ["mars_cmc_map_from_distmat", "market1501_cmc_map",
                                  "dukev_cmc_map"])
@pytest.mark.parametrize("num_g", [70, 23])
def test_device_scorers_match_jax(name, num_g):
    """Random tie-free distances, repeated pids and cameras, junk (-1)
    pids; a 23-entry gallery is shorter than max_rank (50)."""
    dm = np.random.RandomState(num_g).rand(13, num_g).astype(np.float32)
    ids = _ids(num_g + 1, 13, num_g)
    j_cmc, j_map = getattr(jax_rank, name)(dm, *ids)
    t_cmc, t_map = getattr(torch_rank, name)(torch.from_numpy(dm), *ids)
    assert t_cmc.shape == j_cmc.shape
    np.testing.assert_allclose(t_cmc.numpy(), np.asarray(j_cmc), atol=1e-6)
    np.testing.assert_allclose(float(t_map), float(j_map), atol=1e-6)


def test_cuhk03_map_and_valid_match_jax():
    """AP and the valid-query mask do not depend on the draws."""
    dm = np.random.RandomState(3).rand(11, 60).astype(np.float32)
    ids = _ids(4, 11, 60)
    _, j_map = jax_rank.cuhk03_cmc_map(dm, *ids, jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    t_cmc, t_map = torch_rank.cuhk03_cmc_map(torch.from_numpy(dm), *ids, generator=gen)
    np.testing.assert_allclose(float(t_map), float(j_map), atol=1e-6)
    _, w_map = torch_rank.market1501_cmc_map(torch.from_numpy(dm), *ids)  # same AP, same valid
    assert float(t_map) == float(w_map)
    assert t_cmc.shape == (50,) and bool((t_cmc[1:] >= t_cmc[:-1]).all())


def test_cuhk03_one_slot_per_pid_is_deterministic():
    """With one kept gallery slot per pid every draw picks the same slots,
    so CMC agrees exactly with agrl_tpu's whatever the generator."""
    rng = np.random.RandomState(5)
    num_q, num_g = 8, 30
    dm = rng.rand(num_q, num_g).astype(np.float32)
    g_pids = rng.permutation(num_g)  # distinct pids
    q_pids = g_pids[rng.randint(0, num_g, num_q)]
    q_cams, g_cams = np.zeros(num_q, int), np.ones(num_g, int)
    ids = (q_pids, g_pids, q_cams, g_cams)
    j_cmc, j_map = jax_rank.cuhk03_cmc_map(dm, *ids, jax.random.PRNGKey(1))
    for seed in (0, 1):
        gen = torch.Generator().manual_seed(seed)
        t_cmc, t_map = torch_rank.cuhk03_cmc_map(torch.from_numpy(dm), *ids, generator=gen)
        np.testing.assert_allclose(t_cmc.numpy(), np.asarray(j_cmc), atol=1e-6)
        np.testing.assert_allclose(float(t_map), float(j_map), atol=1e-6)


H, W, S = 64, 32, 4
DATA = dict(num_pids=4, tracklets_per_pid=2, frames_per_tracklet=(3, 10),
            height=H, width=W, verbose=False)


def _memoize_extract(evaluator):
    """Extract each split once: later evaluate() calls reuse the features
    (the ranking stage is what these tests vary)."""
    extract, cache = evaluator.extract, {}

    def cached(*args, **kwargs):
        key = (args[-1] if isinstance(args[-1], str) else kwargs.get("name"),
               kwargs.get("keep_on_device"))
        if key not in cache:
            cache[key] = extract(*args, **kwargs)
        return cache[key]

    evaluator.extract = cached
    return evaluator


@pytest.fixture(scope="module")
def evaluators(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthetic"))
    tds = torch_dataset("synthetic", root=root, **DATA)
    jds = jax_dataset("synthetic", root=root, materialize=False, **DATA)
    jmodel = jax_init_model("vmgn_tiny", num_classes=tds.num_train_pids)
    variables = init_params(jmodel, jax.random.PRNGKey(2), seq_len=S, height=H, width=W)
    variables = jax.tree.map(np.asarray, dict(variables))
    tmodel = build_model("vmgn_tiny", num_classes=tds.num_train_pids)
    from_jax_variables(variables, tmodel)

    common = dict(seq_len=S, sample="evenly", height=H, width=W)
    loaders = {}
    for split in ("query", "gallery"):
        loaders[split] = (
            TorchClipLoader(TorchClipDataset(getattr(tds, split), pose_info=tds.process_poses,
                                             **common), 4),
            JaxClipLoader(JaxClipDataset(getattr(jds, split), pose_info=jds.process_poses,
                                         decode="pil", **common), 4, num_workers=1),
        )
    t_eval = _memoize_extract(TorchEvaluator(tmodel, device="cpu"))
    j_eval = _memoize_extract(JaxEvaluator(jmodel))
    return t_eval, j_eval, variables, loaders


@pytest.mark.parametrize("protocol,device_rank", [("mars", True), ("market1501", True),
                                                  ("mars", False)])
def test_evaluator_re_rank_matches_jax(evaluators, protocol, device_rank, monkeypatch, capsys):
    # agrl_tpu's host scorers take the NumPy paths, as the port's do
    monkeypatch.setattr(rank_native, "IS_NATIVE_AVAILABLE", False)
    t_eval, j_eval, variables, loaders = evaluators
    kw = dict(dist_metric="cosine", re_rank=True, metric_protocol=protocol,
              device_rank=device_rank)
    t_r1, t_map = t_eval.evaluate(loaders["query"][0], loaders["gallery"][0], **kw)
    t_out = capsys.readouterr().out
    j_r1, j_map = j_eval.evaluate(variables, loaders["query"][1], loaders["gallery"][1], **kw)
    j_out = capsys.readouterr().out
    assert abs(t_r1 - float(j_r1)) < 1e-6
    assert abs(t_map - j_map) < 1e-6
    line = "Applying person re-ranking (device)..." if device_rank else \
        "Applying person re-ranking ..."
    assert line in t_out and line in j_out
    # the same console result block
    assert t_out[t_out.index("Results"):] == j_out[j_out.index("Results"):]


def _no_host_re_ranking(*args, **kwargs):
    raise AssertionError("the host re-ranking ran although device_rank=True")


def test_evaluator_return_distmat_matches_jax(evaluators, monkeypatch, capsys):
    """The export re-ranks where the features are (ops.rerank), not with
    the host algorithm agrl_tpu uses here: the JAX package's
    device-vs-host bar (2e-4)."""
    monkeypatch.setattr(rank_native, "IS_NATIVE_AVAILABLE", False)
    monkeypatch.setattr(evaluator_mod, "re_ranking", _no_host_re_ranking)
    t_eval, j_eval, variables, loaders = evaluators
    kw = dict(dist_metric="cosine", re_rank=True, return_distmat=True)
    t_dm = t_eval.evaluate(loaders["query"][0], loaders["gallery"][0], **kw)
    assert "Applying person re-ranking (device)..." in capsys.readouterr().out
    j_dm = j_eval.evaluate(variables, loaders["query"][1], loaders["gallery"][1], **kw)
    assert isinstance(t_dm, np.ndarray) and t_dm.shape == j_dm.shape
    np.testing.assert_allclose(t_dm, j_dm, atol=2e-4)
    with pytest.raises(ValueError):
        t_eval.evaluate(loaders["query"][0], loaders["gallery"][0], metric_protocol="viper")


def test_evaluator_dukev_re_rank_matches_jax(evaluators, monkeypatch, capsys):
    """dukev after re-ranking scores on the host (tie-aware); the port
    re-ranks where the features are, agrl_tpu on the host."""
    monkeypatch.setattr(rank_native, "IS_NATIVE_AVAILABLE", False)
    monkeypatch.setattr(evaluator_mod, "re_ranking", _no_host_re_ranking)
    t_eval, j_eval, variables, loaders = evaluators
    kw = dict(dist_metric="cosine", re_rank=True, metric_protocol="dukev")
    t_r1, t_map = t_eval.evaluate(loaders["query"][0], loaders["gallery"][0], **kw)
    t_out = capsys.readouterr().out
    j_r1, j_map = j_eval.evaluate(variables, loaders["query"][1], loaders["gallery"][1], **kw)
    assert "Applying person re-ranking (device)..." in t_out
    assert "Computing CMC and mAP\n" in t_out  # the host scorer
    assert abs(t_r1 - float(j_r1)) < 2e-4
    assert abs(t_map - j_map) < 2e-4
