"""The port's loader with agrl_tpu's host caches (agrl_torch/data/loader.py)
held against agrl_tpu's ClipLoader on the same seeds and files (PIL
decoder): cold and warm epochs with the frame, item and batch caches on
and off; the batch cache's scope; the caches after an Evaluator; and
prefetch_to_device on the CPU (the batches in order, train losses, errors
and an abandoned generator)."""

import threading

import numpy as np
import pytest
import torch

from agrl_torch.data import samplers as tsamplers
from agrl_torch.data.cache import BoundedCache as TorchBoundedCache
from agrl_torch.data.cache import FrameDiskCache as TorchFrameDiskCache
from agrl_torch.data.datasets import init_vidreid_dataset as torch_dataset
from agrl_torch.data.loader import ClipLoader as TorchClipLoader
from agrl_torch.data.loader import VideoClipDataset as TorchClipDataset
from agrl_torch.data.loader import prefetch_to_device
from agrl_tpu.data import samplers as jsamplers
from agrl_tpu.data.cache import BoundedCache as JaxBoundedCache
from agrl_tpu.data.cache import FrameDiskCache as JaxFrameDiskCache
from agrl_tpu.data.datasets import init_vidreid_dataset as jax_dataset
from agrl_tpu.data.loader import ClipLoader as JaxClipLoader
from agrl_tpu.data.loader import VideoClipDataset as JaxClipDataset

torch.set_num_threads(2)

H, W, S = 64, 32, 4
DATA = dict(num_pids=5, tracklets_per_pid=3, frames_per_tracklet=(3, 10),
            height=H, width=W, verbose=False)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic_cache")
    return torch_dataset("synthetic", root=str(root), **DATA), jax_dataset(
        "synthetic", root=str(root), materialize=False, **DATA
    )


def _loaders(tds, jds, sample, caches, tmp_path, workers=2):
    """A port and an agrl_tpu loader over the train split: no sampler for
    the deterministic strategies (their batches cache), P x K otherwise."""
    common = dict(seq_len=S, sample=sample, height=H, width=W, decode="pil")
    kw_t, kw_j = {}, {}
    if "ram" in caches:
        kw_t["cache"], kw_j["cache"] = TorchBoundedCache(), JaxBoundedCache()
    if "disk" in caches:
        kw_t["disk_cache"] = TorchFrameDiskCache(str(tmp_path / "t"), H, W, decoder="pil")
        kw_j["disk_cache"] = JaxFrameDiskCache(str(tmp_path / "j"), H, W, decoder="pil")
    tset = TorchClipDataset(tds.train, pose_info=tds.process_poses, **common, **kw_t)
    jset = JaxClipDataset(jds.train, pose_info=jds.process_poses, **common, **kw_j)
    if sample in ("evenly", "dense"):
        batch = 4 if sample == "evenly" else 1
        return (TorchClipLoader(tset, batch, seed=3, num_workers=workers),
                JaxClipLoader(jset, batch, seed=3, num_workers=workers))
    return (
        TorchClipLoader(tset, 4, drop_last=True, seed=3, num_workers=workers,
                        sampler=tsamplers.RandomIdentitySamplerV1(tds.train, 2, seed=11)),
        JaxClipLoader(jset, 4, drop_last=True, seed=3, num_workers=workers,
                      sampler=jsamplers.RandomIdentitySamplerV1(jds.train, 2, seed=11)),
    )


def _assert_batches_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        for s, t in zip(x, y):
            assert s.dtype == t.dtype
            np.testing.assert_array_equal(s, t)


@pytest.mark.parametrize("caches", ["none", "ram", "disk", "ram+disk"])
@pytest.mark.parametrize("sample", ["evenly", "dense", "restricted"])
def test_batches_equal_agrl_tpu_cold_and_warm(synthetic, sample, caches, tmp_path):
    tds, jds = synthetic
    t_loader, j_loader = _loaders(tds, jds, sample, caches, tmp_path)
    cold = None
    for _ in range(3):  # cold, then warm twice (the batch cache's hits)
        tb, jb = list(t_loader), list(j_loader)
        _assert_batches_equal(tb, jb)
        if sample != "restricted":
            if cold is not None:
                _assert_batches_equal(tb, cold)
            cold = tb
    assert t_loader.batch_cacheable == (sample != "restricted" and "ram" in caches)
    if "disk" in caches:
        assert len(t_loader.dataset.disk_cache) == len(j_loader.dataset.disk_cache) > 0


def test_warm_evenly_epoch_builds_no_item(synthetic, monkeypatch):
    tds, _ = synthetic
    ds = TorchClipDataset(tds.train, seq_len=S, sample="evenly", height=H, width=W,
                          pose_info=tds.process_poses, cache_frames=True, decode="pil")
    loader = TorchClipLoader(ds, 4, num_workers=2)
    cold = list(loader)
    built = []
    real = TorchClipDataset._build_item
    monkeypatch.setattr(TorchClipDataset, "_build_item",
                        lambda self, i, rng=None: built.append(i) or real(self, i, rng))
    warm = list(loader)
    assert built == []
    assert all(w is c for w, c in zip(warm, cold))  # the cached batch objects
    # the item cache was never written: the batch holds those bytes
    assert not any(k[0] == ds.item_tag and len(k) == 2 for k in ds.cache._d)


@pytest.mark.parametrize("sample,sampler", [("restricted", False), ("evenly", True)])
def test_batch_cache_off_for_nondeterministic_loaders(synthetic, sample, sampler):
    tds, _ = synthetic
    ds = TorchClipDataset(tds.train, seq_len=S, sample=sample, height=H, width=W,
                          pose_info=tds.process_poses, cache_frames=True, decode="pil")
    smp = tsamplers.RandomIdentitySamplerV1(tds.train, 2, seed=1) if sampler else None
    loader = TorchClipLoader(ds, 4, sampler=smp, drop_last=sampler, seed=0)
    assert not loader.batch_cacheable
    first, second = list(loader), list(loader)
    assert not any(isinstance(k, tuple) and "batch" in k for k in ds.cache._d)
    assert any(not np.array_equal(a[0], b[0]) for a, b in zip(first, second))


def test_loader_resolves_decode_threads(synthetic):
    tds, _ = synthetic
    for workers, want in ((1, 0), (4, 1)):
        ds = TorchClipDataset(tds.train, seq_len=S, height=H, width=W)
        assert ds.decode_threads is None
        TorchClipLoader(ds, 2, num_workers=workers)
        assert ds.decode_threads == want
    ds = TorchClipDataset(tds.train, seq_len=S, height=H, width=W, decode_threads=3)
    TorchClipLoader(ds, 2, num_workers=4, malloc_tuning=True)
    assert ds.decode_threads == 3


def test_cached_eval_batches_survive_an_evaluation(synthetic):
    """A whole CPU Evaluator.evaluate over loaders with the batch cache:
    the cached batches still equal cold ones (the CPU forward shares the
    cached arrays' memory and must not write into them)."""
    from agrl_torch.engine.evaluator import Evaluator
    from agrl_torch.models import init_model

    tds, _ = synthetic
    common = dict(seq_len=S, sample="evenly", height=H, width=W, pose_info=tds.process_poses)
    shared = TorchBoundedCache()
    loaders = [TorchClipLoader(TorchClipDataset(getattr(tds, s), cache=shared, **common), 4)
               for s in ("query", "gallery")]
    model = init_model("vmgn_tiny", num_classes=tds.num_train_pids, device="cpu", seed=0)
    r1, mAP = Evaluator(model, device="cpu").evaluate(*loaders, dist_metric="cosine")
    assert 0.0 <= r1 <= 1.0 and 0.0 <= mAP <= 1.0
    for loader in loaders:
        assert loader.batch_cacheable
        cold = list(TorchClipLoader(TorchClipDataset(loader.dataset.tracklets, **common), 4))
        _assert_batches_equal(list(loader), cold)


def test_prefetch_on_cpu_yields_the_loader_batches_in_order(synthetic):
    tds, _ = synthetic
    ds = TorchClipDataset(tds.train, seq_len=S, sample="restricted", height=H, width=W,
                          pose_info=tds.process_poses)
    want = list(TorchClipLoader(ds, 3, seed=9, num_workers=2))
    got = list(prefetch_to_device(TorchClipLoader(ds, 3, seed=9, num_workers=2), size=2,
                                  device="cpu"))
    _assert_batches_equal(got, want)
    with pytest.raises(ValueError, match="size"):
        next(prefetch_to_device(iter(want), size=0, device="cpu"))


def test_prefetch_reraises_a_thread_error_in_the_consumer():
    def batches():
        yield (np.zeros(2),)
        raise OSError("disk went away")

    it = prefetch_to_device(batches(), device="cpu")
    assert next(it)[0].shape == (2,)
    with pytest.raises(OSError, match="disk went away"):
        next(it)
    assert not any(t.name == "prefetch" and t.is_alive() for t in threading.enumerate())


def test_abandoned_prefetch_joins_its_thread_and_the_loader_pool(synthetic):
    tds, _ = synthetic
    ds = TorchClipDataset(tds.train, seq_len=S, sample="restricted", height=H, width=W,
                          pose_info=tds.process_poses)
    before = set(threading.enumerate())
    it = prefetch_to_device(TorchClipLoader(ds, 2, seed=1, num_workers=3), size=2,
                            device="cpu")
    next(it)
    it.close()  # the consumer leaves after one batch
    left = [t for t in set(threading.enumerate()) - before if t.is_alive()]
    assert left == [], left


def test_five_train_steps_equal_with_and_without_prefetch(synthetic):
    """vmgn_tiny, the paper recipe's step (flips, soft-margin triplet, Adam)
    on P x K batches: the losses are bit-equal whether the batches come from
    the loader or through prefetch_to_device."""
    from agrl_torch import make_train_step
    from agrl_torch.models import init_model
    from agrl_torch.optim import init_optim

    tds, _ = synthetic
    ds = TorchClipDataset(tds.train, seq_len=S, sample="restricted", height=H, width=W,
                          pose_info=tds.process_poses)
    history = {}
    for prefetch in (False, True):
        model = init_model("vmgn_tiny", num_classes=tds.num_train_pids, device="cpu", seed=0)
        opt = init_optim("adam", model.parameters(), 1e-3, weight_decay=5e-4)
        step = make_train_step(model, opt, lambda s: 1e-3, label_smooth=False,
                               aug={"flip_aug": True})
        gen = torch.Generator().manual_seed(4)
        loader = TorchClipLoader(ds, 4, drop_last=True, seed=2, num_workers=2,
                                 sampler=tsamplers.RandomIdentitySamplerV1(tds.train, 2, seed=5))
        losses = []
        while len(losses) < 5:
            batches = prefetch_to_device(loader, device="cpu") if prefetch else loader
            for imgs, pids, _, adjs in batches:
                if len(losses) == 5:
                    break
                m = step(imgs, pids, adjs, generator=gen)
                losses.append((m["xent_loss"].item(), m["htri_loss"].item()))
        history[prefetch] = losses
    assert history[True] == history[False]
    assert all(np.isfinite(v) for pair in history[True] for v in pair)
