"""The port's training data path held against agrl_tpu's: P x K samplers,
the seeded ClipLoader over train clip strategies, and train
preprocessing with flips — bit for bit, on the same seeds and files."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrl_torch.data import samplers as tsamplers
from agrl_torch.data.datasets import init_vidreid_dataset as torch_dataset
from agrl_torch.data.loader import ClipLoader as TorchClipLoader
from agrl_torch.data.loader import VideoClipDataset as TorchClipDataset
from agrl_torch.data.transforms import preprocess_clips
from agrl_tpu.data import samplers as jsamplers
from agrl_tpu.data.datasets import init_vidreid_dataset as jax_dataset
from agrl_tpu.data.loader import ClipLoader as JaxClipLoader
from agrl_tpu.data.loader import VideoClipDataset as JaxClipDataset
from agrl_tpu.data.transforms import _preprocess_one_clip

# as agrl_tpu runs it: compiled inside the jitted preprocess_clips (XLA
# turns the divisions into an FMA and a multiply, which the port follows)
_jax_one_clip = jax.jit(_preprocess_one_clip, static_argnames=(
    "train", "flip_aug", "rand_erase", "misalign_aug", "rand_translate"))

H, W, S = 64, 32, 4
DATA = dict(num_pids=5, tracklets_per_pid=3, frames_per_tracklet=(3, 10),
            height=H, width=W, verbose=False)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic_train")
    return torch_dataset("synthetic", root=str(root), **DATA), jax_dataset(
        "synthetic", root=str(root), materialize=False, **DATA
    )


def _source(n_pids=6, seed=0):
    """A tracklet list with 1..5 tracklets per pid: some pids have fewer
    than K, so V1 samples them with replacement."""
    rng = np.random.RandomState(seed)
    return [(f"t{p}_{i}", p, i % 2) for p in range(n_pids) for i in range(rng.randint(1, 6))]


@pytest.mark.parametrize("name", ["RandomIdentitySamplerV1", "RandomIdentitySampler"])
def test_sampler_streams_match_jax(name):
    source = _source()
    ours = tsamplers.init_sampler(name, source, batch_size=8, num_instances=4, seed=7)
    theirs = jsamplers.init_sampler(name, source, batch_size=8, num_instances=4, seed=7)
    assert len(ours) == len(theirs)
    for _ in range(3):  # the generator state carries across epochs
        assert list(ours) == list(theirs)


@pytest.mark.parametrize("sample", ["restricted", "random", "consecutive"])
def test_seeded_loader_epoch_bit_equal(synthetic, sample):
    """Two epochs of 4 x 2 batches from RandomIdentitySamplerV1 with
    drop_last: the same indices, clips, labels and pose graphs."""
    tds, jds = synthetic
    common = dict(seq_len=S, sample=sample, height=H, width=W)
    tset = TorchClipDataset(tds.train, pose_info=tds.process_poses, **common)
    jset = JaxClipDataset(jds.train, pose_info=jds.process_poses, decode="pil", **common)
    t_loader = TorchClipLoader(
        tset, batch_size=8, drop_last=True, seed=3,
        sampler=tsamplers.RandomIdentitySamplerV1(tds.train, num_instances=2, seed=11),
    )
    j_loader = JaxClipLoader(
        jset, batch_size=8, drop_last=True, seed=3, num_workers=1,
        sampler=jsamplers.RandomIdentitySamplerV1(jds.train, num_instances=2, seed=11),
    )
    assert len(t_loader) == len(j_loader) == 1  # 5 pids x 2 = 10 indices, drop 2
    for _ in range(2):
        tb, jb = list(t_loader), list(j_loader)
        assert len(tb) == len(jb) == 1
        for t, j in zip(tb[0], jb[0]):
            assert t.dtype == j.dtype
            np.testing.assert_array_equal(t, j)


def test_threaded_loader_matches_sequential(synthetic):
    tds, _ = synthetic
    tset = TorchClipDataset(tds.train, seq_len=S, sample="restricted", height=H, width=W,
                            pose_info=tds.process_poses)
    one = list(TorchClipLoader(tset, batch_size=4, seed=5, num_workers=1))
    many = list(TorchClipLoader(tset, batch_size=4, seed=5, num_workers=3))
    assert len(one) == len(many) == 4  # 15 tracklets: a short last batch
    for a, b in zip(one, many):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_train_flips_match_jax_preprocess():
    """agrl_tpu draws one flip per clip from its key; the decision is read
    off the key and handed to the port, which must then give the same
    pixels bit for bit."""
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (4, S, H, W, 3)).astype(np.uint8)
    keys = jax.random.split(jax.random.PRNGKey(4), 4)
    flips, want = [], []
    for clip, key in zip(imgs, keys):
        flips.append(bool(jax.random.uniform(jax.random.split(key, 4)[0]) < 0.5))
        want.append(np.asarray(_jax_one_clip(
            jnp.asarray(clip), key, train=True, flip_aug=True, rand_erase=False,
            misalign_aug=False, rand_translate=False,
        )))
    assert 0 < sum(flips) < 4
    got = preprocess_clips(torch.from_numpy(imgs), train=True, flip=torch.tensor(flips))
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    # eval preprocessing: the same arithmetic, no flip
    np.testing.assert_array_equal(
        preprocess_clips(torch.from_numpy(imgs)).numpy(),
        np.stack([np.asarray(_jax_one_clip(
            jnp.asarray(c), k, train=False, flip_aug=True, rand_erase=False,
            misalign_aug=False, rand_translate=False,
        )) for c, k in zip(imgs, keys)]),
    )


def test_train_preprocess_draws_and_refuses():
    imgs = torch.zeros(6, S, H, W, 3, dtype=torch.uint8)
    imgs[..., : W // 2, :] = 255  # left half white: a flip is visible
    g = torch.Generator().manual_seed(0)
    out = preprocess_clips(imgs, train=True, generator=g)
    drawn = torch.rand(6, generator=torch.Generator().manual_seed(0)) < 0.5
    flipped = out[:, 0, 0, -1, 0] > out[:, 0, 0, 0, 0]
    assert torch.equal(flipped, drawn)
    with pytest.raises(ValueError):
        preprocess_clips(imgs, train=True)  # neither a generator nor flips
    # the other augmentations draw from the generator too and refuse to run
    # without one (tests/test_torch_augment.py holds them against agrl_tpu)
    noise = torch.randint(0, 256, imgs.shape, generator=g, dtype=torch.uint8)
    plain = preprocess_clips(noise, train=True, flip_aug=False)
    for aug in ("rand_erase", "misalign_aug", "rand_translate"):
        kw = {"flip_aug": False, aug: True}
        drawn = preprocess_clips(noise, train=True, generator=g, **kw)
        assert (drawn - plain).abs().max() > 0.1, aug
        with pytest.raises(ValueError):
            preprocess_clips(noise, train=True, **kw)
