"""The port's masked and long graph layer held against agrl_tpu's.

The vertex mask of the bucketed `--test-sample all` eval, and clips of
more than 128 vertices (which the card's kernel takes on its long
schedule). Inputs come from a numpy seed and go through both frameworks;
on CPU tensors the port runs its plain version. The JAX side is agrl_tpu's
GraphConvLayer, and at V = 200 its Pallas kernel in interpret mode, as
tests/test_ops_pallas.py runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrl_torch.models.layers import GraphConvLayer as TorchGraphConvLayer
from agrl_torch.models.layers import _pair_mask as torch_pair_mask
from agrl_torch.ops import graph_conv as tgc
from agrl_tpu.models.layers import GraphConvLayer as JaxGraphConvLayer
from agrl_tpu.models.layers import _pair_mask as jax_pair_mask
from agrl_tpu.ops.graph_conv import graph_propagate_pallas

torch.set_num_threads(2)

C = 128
PARTS = 7  # vertices per frame with 4-way pyramid parts


def _inputs(B, V, seed):
    rng = np.random.RandomState(seed)
    return dict(
        f=(rng.randn(B, V, C) * 0.1).astype(np.float32),
        adj=(rng.rand(B, V, V) > 0.5).astype(np.float32),
        W=(rng.randn(C, C) * 0.01).astype(np.float32),
        scale=(rng.rand(C) + 0.5).astype(np.float32),
        bias=(rng.randn(C) * 0.1).astype(np.float32),
        mean=(rng.randn(C) * 0.1).astype(np.float32),
        var=(rng.rand(C) + 0.5).astype(np.float32),
    )


def _frame_mask(real_frames, frames):
    """(B, frames * PARTS) frame-major vertex mask: trailing frames pad."""
    fm = (np.arange(frames)[None, :] < np.asarray(real_frames)[:, None]).astype(np.float32)
    return np.repeat(fm, PARTS, axis=1)


def _variables(a):
    return {
        "params": {"linear": {"kernel": jnp.asarray(a["W"])},
                   "bn": {"scale": jnp.asarray(a["scale"]), "bias": jnp.asarray(a["bias"])}},
        "batch_stats": {"bn": {"mean": jnp.asarray(a["mean"]), "var": jnp.asarray(a["var"])}},
    }


def _torch_layer(a, train):
    layer = TorchGraphConvLayer(C, C).train(train)
    with torch.no_grad():
        layer.linear.weight.copy_(torch.from_numpy(a["W"].T))
        layer.bn.weight.copy_(torch.from_numpy(a["scale"]))
        layer.bn.bias.copy_(torch.from_numpy(a["bias"]))
        layer.bn.running_mean.copy_(torch.from_numpy(a["mean"]))
        layer.bn.running_var.copy_(torch.from_numpy(a["var"]))
    return layer


def test_pair_mask_matches_jax():
    vm = _frame_mask([3, 8, 1], 8)
    np.testing.assert_array_equal(torch_pair_mask(torch.from_numpy(vm)).numpy(),
                                  np.asarray(jax_pair_mask(jnp.asarray(vm))))


# V = 56: 5 real frames of 8 (and a clip with one real frame); V = 168: an
# `all` bucket of 24 frames, 17 and 24 of them real
@pytest.mark.parametrize("real,frames", [((5, 1), 8), ((17, 24), 24)])
def test_masked_eval_layer_matches_jax(real, frames):
    """The port's eval layer (its plain twin on the CPU) vs agrl_tpu's
    GraphConvLayer.apply(train=False, vertex_mask=), same weights: atol
    1e-5, padded rows included (both give them a zero graph row)."""
    V = frames * PARTS
    a = _inputs(len(real), V, seed=V)
    vm = _frame_mask(real, frames)
    want = np.asarray(JaxGraphConvLayer(in_features=C, out_features=C).apply(
        _variables(a), jnp.asarray(a["f"]), jnp.asarray(a["adj"]), train=False,
        vertex_mask=jnp.asarray(vm)))
    with torch.no_grad():
        got = _torch_layer(a, train=False)(torch.from_numpy(a["f"]), torch.from_numpy(a["adj"]),
                                           vertex_mask=torch.from_numpy(vm)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_masked_graph_zeroes_padded_rows_and_columns():
    """The masked G: padded rows are 0; real rows sum to 1 over real columns
    only (each half row-normalized, then averaged)."""
    a = _inputs(2, 8 * PARTS, seed=1)
    vm = torch.from_numpy(_frame_mask([5, 8], 8))
    G = tgc.blended_graph(torch.from_numpy(a["f"]), torch.from_numpy(a["adj"]), vm)
    real = vm[:, :, None] * vm[:, None, :] > 0
    assert float(G[~real].abs().max()) == 0.0
    torch.testing.assert_close(G.sum(dim=2), vm, atol=1e-6, rtol=0)


def test_unmasked_long_clip_matches_pallas():
    """V = 200 (more than the 128 the card's short schedule holds): the
    port's plain op vs agrl_tpu's Pallas kernel, which pads V to 256, at
    C = 128 in interpret mode: atol 1e-5."""
    a = _inputs(2, 200, seed=2)
    args = [a[k] for k in ("f", "adj", "W", "scale", "bias", "mean", "var")]
    want = np.asarray(graph_propagate_pallas(*args, weight_tile=128, interpret=True))
    got = tgc.graph_propagate(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_masked_train_layer_and_gradients_match_jax():
    """Train mode with a vertex mask: BN on the batch statistics of every
    row (padded ones too, as agrl_tpu's layer takes them), then the
    gradients of sum(out * g) with respect to the features and the Linear
    weight. The eval layer's 1e-5 does not hold here: train-mode BN
    divides G @ h by its batch std, which amplifies the two frameworks'
    fp32 summation orders (tests/test_torch_graph_conv.py keeps 1e-3 for
    the unmasked train layer). Here they differ by ~2.5e-5 of the largest
    output and ~2e-5 of each gradient's largest entry (seeds 3, 5, 7); the
    bar is 1e-4 of the largest entry for all three."""
    frames = 8
    V = frames * PARTS
    a = _inputs(2, V, seed=3)
    vm = _frame_mask([5, 8], frames)
    g = np.random.RandomState(4).randn(2, V, C).astype(np.float32)
    layer_j = JaxGraphConvLayer(in_features=C, out_features=C)
    variables = _variables(a)

    def loss(params, x):
        out, _ = layer_j.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                               jnp.asarray(a["adj"]), train=True, vertex_mask=jnp.asarray(vm),
                               mutable=["batch_stats"])
        return jnp.sum(out * g), out

    (_, want), (dparams, dx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(a["f"]))

    layer = _torch_layer(a, train=True)
    x = torch.from_numpy(a["f"]).requires_grad_(True)
    out = layer(x, torch.from_numpy(a["adj"]), vertex_mask=torch.from_numpy(vm))
    (out * torch.from_numpy(g)).sum().backward()

    want = np.asarray(want)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)
    for got_g, want_g in ((x.grad.numpy(), np.asarray(dx)),
                          (layer.linear.weight.grad.numpy().T,
                           np.asarray(dparams["linear"]["kernel"]))):
        np.testing.assert_allclose(got_g, want_g, atol=1e-4 * np.abs(want_g).max(), rtol=0)
