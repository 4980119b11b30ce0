"""The port's training losses held against agrl_tpu.losses on the same
numpy inputs (fp32 both ways; atol 1e-6 on scalars of order 1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrl_torch import losses as tl
from agrl_tpu import losses as jl


def _logits(B=16, K=625, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, K) * 3).astype(np.float32), rng.randint(0, K, B).astype(np.int32)


@pytest.mark.parametrize("epsilon", [0.0, 0.1])
def test_cross_entropy_label_smooth(epsilon):
    logits, labels = _logits()
    got = tl.cross_entropy_label_smooth(torch.from_numpy(logits), torch.from_numpy(labels),
                                        epsilon=epsilon)
    want = jl.cross_entropy_label_smooth(jnp.asarray(logits), jnp.asarray(labels),
                                         epsilon=epsilon)
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=0)


def _pk_features(seed=1, P=4, K=4, D=2048):
    rng = np.random.RandomState(seed)
    labels = np.repeat(np.arange(P), K).astype(np.int32)
    return (rng.randn(P * K, D) * 0.05).astype(np.float32), labels


@pytest.mark.parametrize("soft", [True, False])
def test_batch_hard_triplet(soft):
    feats, labels = _pk_features()
    got = tl.batch_hard_triplet(torch.from_numpy(feats), torch.from_numpy(labels), soft=soft)
    want = jl.batch_hard_triplet(jnp.asarray(feats), jnp.asarray(labels), soft=soft)
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=0)


def test_deep_supervision_over_heads():
    logits = [_logits(seed=s)[0] for s in range(5)]
    labels = _logits()[1]
    got = tl.deep_supervision(tl.cross_entropy_label_smooth,
                              [torch.from_numpy(x) for x in logits], torch.from_numpy(labels))
    want = jl.deep_supervision(jl.cross_entropy_label_smooth,
                               [jnp.asarray(x) for x in logits], jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=0)
    single = tl.deep_supervision(tl.cross_entropy_label_smooth, torch.from_numpy(logits[0]),
                                 torch.from_numpy(labels))
    np.testing.assert_allclose(
        float(single),
        float(jl.cross_entropy_label_smooth(jnp.asarray(logits[0]), jnp.asarray(labels))),
        atol=1e-6, rtol=0,
    )
