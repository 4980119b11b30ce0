"""The port's FeatureExtractor: bf16 by default (agrl_tpu's default),
fixed batch shape, padding, shape checks, and no silent CPU fallback."""

import numpy as np
import pytest
import torch

from agrl_torch.data.transforms import preprocess_clips
from agrl_torch.engine.evaluator import Evaluator, make_eval_forward
from agrl_torch.engine.export import FeatureExtractor
from agrl_torch.models import init_model

torch.set_num_threads(2)

S, H, W, V = 4, 64, 32, 28


@pytest.fixture(scope="module")
def extractor():
    model = init_model("vmgn_tiny", num_classes=5, device="cpu", seed=0)
    return FeatureExtractor(model, batch_size=2, seq_len=S, device="cpu")


def _clips(n, seed=0):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n, S, H, W, 3)).astype(np.uint8)
    adjs = (rng.rand(n, V, V) > 0.5).astype(np.float32)
    return imgs, adjs


def test_ragged_request_equals_single_clip_calls(extractor):
    imgs, adjs = _clips(3)
    batch = extractor(imgs, adjs)
    assert batch.shape == (3, 4096) and batch.dtype == np.float32
    assert np.isfinite(batch).all()
    for i in range(3):
        np.testing.assert_allclose(batch[i], extractor(imgs[i:i + 1], adjs[i:i + 1])[0],
                                   atol=1e-5, rtol=0)


def test_default_adjacency_is_all_ones(extractor):
    imgs, _ = _clips(2, seed=1)
    np.testing.assert_array_equal(extractor(imgs), extractor(imgs, np.ones((2, V, V))))


def test_default_is_the_bf16_eval_forward_row_for_row(extractor):
    """The default extractor serves make_eval_forward(bf16=True): a ragged
    3-clip request at batch 2 gives each clip's single-clip forward, and an
    empty request an empty result."""
    imgs, adjs = _clips(3, seed=2)
    fwd = make_eval_forward(extractor.model, "cpu", bf16=True)
    want = np.concatenate([fwd(imgs[i:i + 1], adjs[i:i + 1]).numpy() for i in range(3)])
    np.testing.assert_allclose(extractor(imgs, adjs), want, atol=1e-5, rtol=0)
    assert extractor(imgs[:0], adjs[:0]).shape == (0, 4096)
    fp32 = make_eval_forward(extractor.model, "cpu", bf16=False)(imgs, adjs).numpy()
    assert np.abs(want - fp32).max() > 1e-4  # the default is not the fp32 forward


def test_fp32_switch_serves_the_fp32_forward(extractor):
    fx = FeatureExtractor(extractor.model, batch_size=2, seq_len=S, bf16=False, device="cpu")
    imgs, adjs = _clips(3, seed=3)
    with torch.inference_mode():
        want = extractor.model(preprocess_clips(torch.from_numpy(imgs)),
                               torch.from_numpy(adjs)).numpy()
    np.testing.assert_allclose(fx(imgs, adjs), want, atol=1e-5, rtol=0)


def test_empty_request(extractor):
    imgs, _ = _clips(1)
    assert extractor(imgs[:0]).shape == (0, 4096)


@pytest.mark.parametrize(
    "shape,adj_v",
    [
        ((1, S + 1, H, W, 3), None),   # seq_len
        ((1, S, H + 8, W, 3), None),   # height
        ((1, S, H, W + 8, 3), None),   # width
        ((1, S, H, W, 3), V + 7),      # vertex count
    ],
)
def test_wrong_shapes_raise(extractor, shape, adj_v):
    extractor(_clips(1)[0])  # locks H x W in
    adjs = None if adj_v is None else np.ones((1, adj_v, adj_v), np.float32)
    with pytest.raises(ValueError):
        extractor(np.zeros(shape, np.uint8), adjs)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_no_cpu_fallback_without_a_card(monkeypatch, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = init_model("vmgn_tiny", num_classes=5, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FeatureExtractor(model, batch_size=2, seq_len=S, device=device)
    with pytest.raises(RuntimeError):
        Evaluator(model, device=device)
    with pytest.raises(RuntimeError):
        init_model("vmgn_tiny", num_classes=5, device=device)
