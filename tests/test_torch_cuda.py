"""Port kernels on the card against their plain PyTorch versions.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without
one. The file imports no JAX, so it also runs where JAX is not
installed; there, skip the repo's JAX conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from agrl_torch.ops import graph_conv

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    # the plain version's matmuls must run in full fp32 to be a reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, V, C, seed=0, relu_like=False):
    rng = np.random.RandomState(seed)
    f = rng.rand(B, V, C) * 2.0 if relu_like else rng.randn(B, V, C) * 0.1
    return dict(
        f=f.astype(np.float32),
        adj=(rng.rand(B, V, V) > 0.5).astype(np.float32),
        W=(rng.randn(C, C) * 0.01).astype(np.float32),
        scale=(rng.rand(C) + 0.5).astype(np.float32),
        bias=(rng.randn(C) * 0.1).astype(np.float32),
        mean=(rng.randn(C) * 0.1).astype(np.float32),
        var=(rng.rand(C) + 0.5).astype(np.float32),
    )


def _to(dev, arrs):
    return {k: torch.from_numpy(v).to(dev) for k, v in arrs.items()}


@pytest.mark.parametrize(
    "B,V,C,relu_like",
    [
        (16, 56, 2048, False),  # the serving path's shape
        (16, 56, 2048, True),   # ReLU-like features: large distances
        (3, 40, 2048, False),   # ragged batch and V
        (2, 64, 256, False),    # largest V of the 4-row tile
        (2, 65, 384, False),    # smallest V of the 8-row tile
        (1, 128, 128, False),   # largest V, one column tile
        (2, 1, 128, False),     # a single vertex
        (5, 17, 384, False),    # C / 32 not a multiple of 8: 4 Gram slices
    ],
)
@pytest.mark.parametrize("weight_view", [False, True])
def test_kernel_matches_plain(cuda, B, V, C, relu_like, weight_view):
    """W row-major (in, out), or the transpose view of a contiguous torch
    Linear weight, as GraphConvLayer passes it (same values)."""
    t = _to(cuda, _inputs(B, V, C, relu_like=relu_like))
    W = t["W"].t().contiguous().t() if weight_view else t["W"]
    assert W.is_contiguous() != weight_view
    args = (t["f"], t["adj"], W, t["scale"], t["bias"], t["mean"], t["var"])
    before = graph_conv.launches
    got = graph_conv.graph_propagate(*args)
    torch.cuda.synchronize()
    assert graph_conv.launches == before + 1
    want = graph_conv.graph_propagate_reference(*args)
    # fp32 both ways; only the summation order differs
    torch.testing.assert_close(got, want, atol=2e-4, rtol=0)


def test_v2_matches_plain_on_bf16_rounded_inputs(cuda):
    t = _to(cuda, _inputs(16, 56, 2048, seed=1))
    args = (t["W"], t["scale"], t["bias"], t["mean"], t["var"])
    got = graph_conv.graph_propagate_v2(t["f"], t["adj"], *args)
    want = graph_conv.graph_propagate_reference(
        graph_conv.round_bf16(t["f"]), graph_conv.round_bf16(t["adj"]), *args
    )
    torch.testing.assert_close(got, want, atol=2e-3, rtol=0)


def test_kernel_rejects_what_it_does_not_take(cuda):
    t = _to(cuda, _inputs(2, 56, 256))
    rest = (t["W"], t["scale"], t["bias"], t["mean"], t["var"])
    with pytest.raises(ValueError):  # V > 128
        big = torch.zeros(1, 129, 256, device=cuda)
        graph_conv.graph_propagate(big, torch.ones(1, 129, 129, device=cuda), *rest)
    with pytest.raises(ValueError):  # C not a multiple of the column tile
        t2 = _to(cuda, _inputs(2, 56, 200))
        graph_conv.graph_propagate(*t2.values())
    with pytest.raises(ValueError):  # float64
        graph_conv.graph_propagate(t["f"].double(), t["adj"], *rest)
    with pytest.raises(ValueError):  # non-contiguous features
        graph_conv.graph_propagate(t["f"].transpose(0, 1), t["adj"], *rest)
