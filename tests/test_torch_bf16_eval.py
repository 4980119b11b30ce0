"""The port's bf16 eval held against agrl_tpu's `make_eval_forward(bf16=True)`.

VMGN at depth (1,1,1,1), 64x32 frames, S=4, two graph layers, built
directly in both packages with each of agrl_tpu's three model dtypes;
agrl_tpu's weights (with randomized BatchNorm statistics) are carried
into the port by `from_jax_variables`. The bf16 eval rounds the weights,
the normalized pixels and the adjacency to bf16 and runs the model at its
own dtype:
  * float32: float32 arithmetic on the rounded values, held at the fp32
    eval's bar (atol 5e-4, rtol 1e-4; measured ~2e-7 of max);
  * None and bfloat16: bf16 trunks, held within 1e-2 of max (measured
    ~5e-3 and ~4e-4), and the port's bf16-vs-fp32 distance within 2x
    agrl_tpu's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrl_torch.engine.evaluator import Evaluator, make_eval_forward
from agrl_torch.engine.export import FeatureExtractor
from agrl_torch.models.vmgn import VMGN
from agrl_torch.models.weight_convert import from_jax_variables
from agrl_tpu.engine.evaluator import Evaluator as JaxEvaluator
from agrl_tpu.engine.evaluator import make_eval_forward as jax_make_eval_forward
from agrl_tpu.engine.export import FeatureExtractor as JaxFeatureExtractor
from agrl_tpu.models import init_params
from agrl_tpu.models.vmgn import VMGN as JaxVMGN
from tests.test_torch_vmgn import _randomize

torch.set_num_threads(2)

S, H, W, B, V = 4, 64, 32, 3, 28
DTYPES = {"float32": (jnp.float32, torch.float32), "none": (None, None),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def _inputs(seed=3):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (B, S, H, W, 3)).astype(np.uint8)
    adj = ((rng.rand(B, V, V) > 0.5) + np.eye(V)).astype(np.float32)
    fmask = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [1, 0, 0, 0]], np.float32)
    return imgs, adj, fmask


@pytest.fixture(scope="module", params=sorted(DTYPES))
def pair(request):
    jdt, tdt = DTYPES[request.param]
    jmodel = JaxVMGN(num_classes=10, layers=(1, 1, 1, 1), num_gb=2, dtype=jdt)
    variables = init_params(jmodel, jax.random.PRNGKey(0), seq_len=S, height=H, width=W)
    variables = _randomize(jax.tree.map(np.asarray, dict(variables)))
    tmodel = VMGN(num_classes=10, layers=(1, 1, 1, 1), num_gb=2, dtype=tdt)
    from_jax_variables(variables, tmodel)
    return request.param, jmodel, variables, tmodel.eval()


_FEATURES = {}  # (dtype name, bf16, masked) -> (port, agrl_tpu): one JAX compile each


def _both(pair, bf16, masked=False):
    key = (pair[0], bf16, masked)
    if key not in _FEATURES:
        _FEATURES[key] = _forward(pair, bf16, masked)
    return _FEATURES[key]


def _forward(pair, bf16, masked):
    _, jmodel, variables, tmodel = pair
    imgs, adj, fmask = _inputs()
    jfwd, jfwd_masked = jax_make_eval_forward(jmodel, bf16)
    tfwd = make_eval_forward(tmodel, "cpu", bf16)
    if masked:
        return (tfwd(imgs, adj, fmask).numpy(),
                np.asarray(jfwd_masked(variables, imgs, adj, jnp.asarray(fmask))))
    return tfwd(imgs, adj).numpy(), np.asarray(jfwd(variables, imgs, adj))


@pytest.mark.parametrize("masked", [False, True])
def test_bf16_eval_matches_agrl_tpu(pair, masked):
    name = pair[0]
    got, want = _both(pair, True, masked)
    assert got.shape == want.shape == (B, 4096) and got.dtype == np.float32
    if name == "float32":
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-4)
    else:
        assert _rel(got, want) <= 1e-2, _rel(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_bf16_distance_from_fp32_within_2x_agrl_tpu(pair, masked):
    """The port rounds where agrl_tpu rounds: its bf16-vs-fp32 distance is
    no more than twice agrl_tpu's (for the float32 model the two distances
    are the same rounding, ~8.5e-3 of max here)."""
    got16, want16 = _both(pair, True, masked)
    got32, want32 = _both(pair, False, masked)
    port, jax_ = _rel(got16, got32), _rel(want16, want32)
    assert 0 < port <= 2 * jax_, (port, jax_)


def test_bf16_eval_leaves_the_live_weights_alone(pair):
    tmodel = pair[3]
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    _both(pair, True)
    for k, v in tmodel.state_dict().items():
        assert v.dtype == before[k].dtype and torch.equal(v, before[k]), k


def test_default_feature_extractor_matches_agrl_tpu(pair):
    """Both serving APIs default to bf16; for the float32 model (the `vmgn`
    factory's dtype) the port's default features equal agrl_tpu's default
    ones within the fp32 bar, a ragged 3-clip request at batch 2."""
    name, jmodel, variables, tmodel = pair
    imgs, adj, _ = _inputs(seed=4)
    got = FeatureExtractor(tmodel, batch_size=2, seq_len=S, device="cpu")(imgs, adj)
    want = JaxFeatureExtractor(jmodel, variables, batch_size=2, seq_len=S)(imgs, adj)
    if name == "float32":
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-4)
    else:
        assert _rel(got, want) <= 1e-2


class _Loader:
    """(imgs, pids, camids, adjs) batches, the loader contract of both
    Evaluators."""

    def __init__(self, seed, n=5, batch=2):
        rng = np.random.RandomState(seed)
        self.imgs = rng.randint(0, 256, (n, S, H, W, 3)).astype(np.uint8)
        self.adjs = ((rng.rand(n, V, V) > 0.5) + np.eye(V)).astype(np.float32)
        self.pids, self.batch = np.arange(n) % 3, batch

    def __iter__(self):
        for i in range(0, len(self.imgs), self.batch):
            sl = slice(i, i + self.batch)
            yield self.imgs[sl], self.pids[sl], np.zeros_like(self.pids[sl]), self.adjs[sl]


def test_evaluator_bf16_features_match_agrl_tpu(pair):
    name, jmodel, variables, tmodel = pair
    got = Evaluator(tmodel, bf16=True, device="cpu").extract(_Loader(6))[0].numpy()
    want = np.asarray(JaxEvaluator(jmodel, bf16=True).extract(variables, _Loader(6))[0])
    assert got.shape == want.shape == (5, 4096)
    if name == "float32":
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-4)
    else:
        assert _rel(got, want) <= 1e-2
