"""The port's train augmentations held against agrl_tpu's
`preprocess_clips` (jitted, as its train step runs it): misalign (each of
its four variants), random crop (`rand_translate`), random erasing, and
all three with flips, on 256x128 clips. The draws are read off
agrl_tpu's keys (agrl_tpu/data/transforms.py:216-353) and injected into
the port, which must then give agrl_tpu's pixels:

  * erasing and flips alone: bit for bit (no resize; the fma
    normalization is agrl_tpu's);
  * every case with a resize: atol 2e-6, a few ulps of the normalized
    pixels (|x| <= 2.64). Found: random crop (240x120 -> 256x128) and
    misalign's crops (244 -> 256 rows), which enlarge, 7.2e-7; misalign's
    pads (268 -> 256 rows), which shrink with agrl_tpu's antialiasing
    (F.interpolate(antialias=True) here), 1.2e-6 (0.32 without the
    antialiasing); an undrawn clip of a misalign batch, whose
    normalization is split around the resize, 4.8e-7; all together
    1.2e-6 (on the CPU, at this seed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrl_torch.data import transforms as tt
from agrl_tpu.data import transforms as jt

H, W, S, B = 256, 128, 2, 8
ATOL = 2e-6
VARIANTS = ("crop_top", "crop_bottom", "pad_top", "pad_bottom")


def _draws(key, H=H, W=W, S=S, B=B):
    """What agrl_tpu's preprocess_clips draws from `key`, per clip:
    flip, misalign [apply, top, crop], translate [top, left], erase
    [apply, top, left, h, w] per frame."""
    ch, cw = tt.crop_window(H, W)
    flip, mis, trans, erase = [], [], [], []
    for kb in jax.random.split(key, B):
        k_flip, k_erase, k_mis, k_trans = jax.random.split(kb, 4)
        flip.append(bool(jax.random.uniform(k_flip) < 0.5))
        mis.append([bool(jax.random.uniform(k) < 0.5) for k in jax.random.split(k_mis, 3)])
        k_x, k_y = jax.random.split(k_trans)
        trans.append([int(jax.random.randint(k_y, (), 0, H - ch + 1)),
                      int(jax.random.randint(k_x, (), 0, W - cw + 1))])
        frames = []
        for kf in jax.random.split(k_erase, S):
            k_p, k_rect = jax.random.split(kf)
            mask = np.asarray(jt._erase_mask(k_rect, H, W))
            rows, cols = np.flatnonzero(mask.any(1)), np.flatnonzero(mask.any(0))
            rect = ([rows[0], cols[0], len(rows), len(cols)] if rows.size else [0, 0, 0, 0])
            frames.append([int(jax.random.uniform(k_p) < 0.5)] + rect)
        erase.append(frames)
    return dict(flip=torch.tensor(flip), misalign_draws=torch.tensor(mis),
                translate_draws=torch.tensor(trans), erase_draws=torch.tensor(erase))


def _variant(row):
    apply, top, crop = (bool(v) for v in row)
    if not apply:
        return None
    return f"{'crop' if crop else 'pad'}_{'top' if top else 'bottom'}"


@pytest.fixture(scope="module")
def case():
    """Clips and a key whose misalign draws give all four variants and an
    unaltered clip, and whose flips, erasures and crops are mixed."""
    imgs = np.random.RandomState(0).randint(0, 256, (B, S, H, W, 3)).astype(np.uint8)
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        d = _draws(key)
        kinds = {_variant(r) for r in d["misalign_draws"].tolist()}
        if kinds >= set(VARIANTS) | {None} and 0 < int(d["flip"].sum()) < B and (
                0 < int(d["erase_draws"][..., 0].sum()) < B * S):
            return imgs, key, d
    raise AssertionError("no key with every misalign variant")


def _jax(imgs, key, **aug):
    return np.asarray(jt.preprocess_clips(jnp.asarray(imgs), key, train=True, **aug))


def _port(imgs, draws, **aug):
    return tt.preprocess_clips(torch.from_numpy(imgs), train=True, **draws, **aug).numpy()


OFF = dict(flip_aug=False, rand_erase=False, misalign_aug=False, rand_translate=False)


@pytest.mark.parametrize("variant", VARIANTS)
def test_misalign_variant_matches_agrl_tpu(case, variant):
    imgs, key, d = case
    aug = dict(OFF, misalign_aug=True)
    want, got = _jax(imgs, key, **aug), _port(imgs, d, **aug)
    clips = [b for b, r in enumerate(d["misalign_draws"].tolist()) if _variant(r) == variant]
    err = np.abs(got[clips] - want[clips]).max()
    assert err <= ATOL, (variant, err)
    # the variant changed the clip: the bar is not met by an unchanged one
    plain = _port(imgs, d, **OFF)
    assert np.abs(plain[clips] - want[clips]).max() > 0.1


def test_misalign_leaves_undrawn_clips_unchanged(case):
    imgs, key, d = case
    aug = dict(OFF, misalign_aug=True)
    want, got = _jax(imgs, key, **aug), _port(imgs, d, **aug)
    clips = [b for b, r in enumerate(d["misalign_draws"].tolist()) if _variant(r) is None]
    # x * (1/255), then (x - mean) * (1/std): agrl_tpu's split normalization
    np.testing.assert_allclose(got[clips], want[clips], rtol=0, atol=ATOL)


def test_random_crop_matches_agrl_tpu(case):
    imgs, key, d = case
    aug = dict(OFF, rand_translate=True)
    want, got = _jax(imgs, key, **aug), _port(imgs, d, **aug)
    assert np.abs(got - want).max() <= ATOL
    assert len({tuple(t) for t in d["translate_draws"].tolist()}) > 1


def test_random_erase_matches_agrl_tpu_bit_for_bit(case):
    imgs, key, d = case
    aug = dict(OFF, rand_erase=True)
    want, got = _jax(imgs, key, **aug), _port(imgs, d, **aug)
    np.testing.assert_array_equal(got, want)
    fill = np.float32(tt.IMAGENET_MEAN)
    erased = (got == fill).all(-1).sum(axis=(2, 3))  # pixels a frame took the fill
    drawn = (d["erase_draws"][..., 0] * d["erase_draws"][..., 3] * d["erase_draws"][..., 4])
    np.testing.assert_array_equal(erased, drawn.numpy())


def test_all_augmentations_with_flips_match_agrl_tpu(case):
    imgs, key, d = case
    aug = dict(flip_aug=True, rand_erase=True, misalign_aug=True, rand_translate=True)
    want, got = _jax(imgs, key, **aug), _port(imgs, d, **aug)
    assert np.abs(got - want).max() <= ATOL


def test_generator_draws_every_augmentation():
    """Drawn from the generator, in agrl_tpu's order (misalign, translate,
    flip, erase): a second generator on the same seed repeats them."""
    imgs = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (4, S, 64, 32, 3))
                            .astype(np.uint8))
    aug = dict(flip_aug=True, rand_erase=True, misalign_aug=True, rand_translate=True)
    a = tt.preprocess_clips(imgs, train=True, generator=torch.Generator().manual_seed(3), **aug)
    g = torch.Generator().manual_seed(3)
    draws = dict(misalign_draws=tt.draw_misalign(4, g), translate_draws=tt.draw_translate(
        4, 64, 32, g), flip=torch.rand(4, generator=g) < 0.5,
        erase_draws=tt.draw_erase(4, S, 64, 32, g))
    b = tt.preprocess_clips(imgs, train=True, **draws, **aug)
    assert torch.equal(a, b)
    e = draws["erase_draws"]
    assert ((e[..., 3] > 0) & (e[..., 3] < 64) & (e[..., 1] + e[..., 3] <= 64)).all()
    assert ((e[..., 4] > 0) & (e[..., 4] < 32) & (e[..., 2] + e[..., 4] <= 32)).all()
    with pytest.raises(ValueError):
        tt.preprocess_clips(imgs, train=True, **aug)  # neither a generator nor draws
