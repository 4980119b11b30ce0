"""The Evaluator's extraction of the single-scale archs held against
agrl_tpu's, on a synthetic dataset at 64x32.

Each arch at depth (1,1,1,1) with agrl_tpu's random weights (randomized,
ganet's PAM gamma nonzero; tests/test_torch_archs.py) bridged into the
port: `dense` packed extraction (clip_batch 2, so a tracklet's clips
straddle two device batches) and bucketed `all` (frame masks), features
within the eval forward's bar (atol 5e-4, rtol 1e-4), pids and camids
equal. sta and simple_sta pick each part's best frame by an arg-max; the
synthetic tracklets' frames (one colour per identity under noise) give
their two best frames scores as close as 7.8e-6 apart (relative, under
`all`), too near fp32 rounding to call a flip impossible, so they are
held on their fp32 forward with clips built apart
(tests/test_torch_archs.py) and here only for the features' width and
finiteness.
"""

import numpy as np
import pytest
import torch

from agrl_torch.engine.evaluator import Evaluator as TorchEvaluator
from agrl_tpu.engine.evaluator import Evaluator as JaxEvaluator
from tests.test_torch_archs import ARCHS, WIDTH, jax_variables, port_model
from tests.test_torch_archs import jax_model as tiny_jax_model
from tests.test_torch_eval_dense import CLIP_BATCH, _loaders, synthetic  # noqa: F401
from agrl_torch.models.weight_convert import from_jax_variables

torch.set_num_threads(2)

PICK = ("sta", "simple_sta")


@pytest.fixture(scope="module", params=ARCHS)
def models(request, synthetic):  # noqa: F811
    arch = request.param
    variables = jax_variables(arch)
    tmodel = port_model(arch)
    from_jax_variables(variables, tmodel)
    return arch, tiny_jax_model(arch), variables, tmodel


@pytest.mark.parametrize("sample", ["dense", "all"])
def test_extraction_matches_agrl_tpu(synthetic, models, sample):  # noqa: F811
    arch, jmodel, variables, tmodel = models
    tl, jl = _loaders(synthetic, sample)["gallery"]
    t_f, t_pids, t_cams, _ = TorchEvaluator(tmodel, test_sample=sample, clip_batch=CLIP_BATCH,
                                            device="cpu").extract(tl, "gallery")
    assert t_f.dtype == torch.float32 and t_f.shape == (len(tl.dataset), WIDTH[arch])
    assert torch.isfinite(t_f).all()
    if arch in PICK:
        return
    j_f, j_pids, j_cams, _ = JaxEvaluator(jmodel, test_sample=sample,
                                          clip_batch=CLIP_BATCH).extract(variables, jl, "gallery")
    np.testing.assert_allclose(t_f.numpy(), j_f, atol=5e-4, rtol=1e-4)
    np.testing.assert_array_equal(t_pids, j_pids)
    np.testing.assert_array_equal(t_cams, j_cams)
