"""The port's VMGN eval forward and weight bridge held against agrl_tpu.

vmgn_tiny (depth 1,1,1,1) at 128x64, S=4, B=2, two graph layers:
agrl_tpu's init_params weights (with randomized BatchNorm statistics)
go to numpy, into the port through `from_jax_variables`, and both
frameworks extract features from the same clips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrl_torch.models import build_model, default_num_vertices
from agrl_torch.models.weight_convert import from_jax_variables
from agrl_tpu.models import init_model as jax_init_model
from agrl_tpu.models import init_params
from agrl_tpu.models.weight_convert import export_torch_state_dict

torch.set_num_threads(2)

S, H, W, B = 4, 128, 64, 2


def _randomize(variables, seed=0):
    """Non-trivial BN statistics and affine terms, so the bridge's BN
    mapping is exercised (init leaves mean 0 / var 1 / scale 1 / bias 0)."""
    rng = np.random.RandomState(seed)

    def walk(tree, coll):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, coll)
            elif k == "mean":
                out[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "scale":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "bias" and coll == "params":
                out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out

    return {c: walk(variables[c], c) for c in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def bridged():
    jmodel = jax_init_model("vmgn_tiny", num_classes=10)
    variables = init_params(jmodel, jax.random.PRNGKey(0), seq_len=S, height=H, width=W)
    variables = _randomize(jax.tree.map(np.asarray, dict(variables)))
    tmodel = build_model("vmgn_tiny", num_classes=10)
    from_jax_variables(variables, tmodel)
    return jmodel, variables, tmodel.eval()


def test_features_match_jax(bridged):
    jmodel, variables, tmodel = bridged
    rng = np.random.RandomState(3)
    x = rng.rand(B, S, H, W, 3).astype(np.float32)
    V = default_num_vertices(tmodel, S)
    adj = (rng.rand(B, V, V) > 0.5).astype(np.float32) + np.eye(V, dtype=np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), jnp.asarray(adj), train=False))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(adj)).numpy()
    assert got.shape == want.shape == (B, 4096)
    # the bar agrl_tpu met against the reference (test_reverse_export.py:173)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-4)


def test_bridge_agrees_with_reverse_export(bridged):
    """agrl_tpu's own reverse export fills a port-named state dict with the
    same values the bridge loaded; only entries with no flax counterpart
    are kept (tests/test_reverse_export.py:EXPECTED_KEPT)."""
    _, variables, tmodel = bridged
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    state, filled, kept = export_torch_state_dict(variables, sd, "vmgn")
    assert kept and all(n.endswith(("num_batches_tracked", "bottleneck.bias")) for n in kept)
    assert len(filled) + len(kept) == len(sd)
    for name in filled:
        np.testing.assert_array_equal(state[name], sd[name], err_msg=name)


def test_bridge_rejects_missing_and_extra_leaves(bridged):
    _, variables, _ = bridged
    fresh = build_model("vmgn_tiny", num_classes=10)
    missing = {c: dict(variables[c]) for c in variables}
    del missing["params"]["att_classifier"]
    with pytest.raises(KeyError):
        from_jax_variables(missing, fresh)
    extra = {c: dict(variables[c]) for c in variables}
    extra["params"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        from_jax_variables(extra, fresh)


def test_unported_model_modes_raise(bridged):
    """`frame_mask` is still unported; the train forward (ported since)
    returns a logits list and a feature list, one entry per head."""
    tmodel = bridged[2]
    x = torch.zeros(1, S, H, W, 3)
    adj = torch.ones(1, 28, 28)
    with pytest.raises(NotImplementedError):
        tmodel(x, adj, frame_mask=torch.ones(1, S))
    x2 = torch.from_numpy(np.random.RandomState(0).rand(2, S, H, W, 3).astype(np.float32))
    outputs, features = build_model("vmgn_tiny", num_classes=10).train()(x2, adj.expand(2, -1, -1))
    assert [tuple(o.shape) for o in outputs] == [(2, 10)] * 2
    assert [tuple(f.shape) for f in features] == [(2, 2048)] * 2
