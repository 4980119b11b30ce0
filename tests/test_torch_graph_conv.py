"""The port's graph op and GraphConvLayer held against agrl_tpu's.

Inputs come from a numpy seed and go through both frameworks; the JAX
side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_ops_pallas.py does. On CPU tensors the port dispatches to its
plain version (the CUDA kernel is checked in tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrl_torch.models.layers import GraphConvLayer as TorchGraphConvLayer
from agrl_torch.ops import graph_conv as tgc
from agrl_tpu.models.layers import GraphConvLayer as JaxGraphConvLayer
from agrl_tpu.ops.graph_conv import graph_propagate_pallas, graph_propagate_reference
from agrl_tpu.ops.graph_conv_v2 import graph_propagate_pallas_v2

torch.set_num_threads(2)

NAMES = ("f", "adj", "W", "scale", "bias", "mean", "var")


def _inputs(B, V, C, seed=0):
    rng = np.random.RandomState(seed)
    return (
        (rng.randn(B, V, C) * 0.1).astype(np.float32),
        (rng.rand(B, V, V) > 0.5).astype(np.float32),
        (rng.randn(C, C) * 0.01).astype(np.float32),
        (rng.rand(C) + 0.5).astype(np.float32),
        (rng.randn(C) * 0.1).astype(np.float32),
        (rng.randn(C) * 0.1).astype(np.float32),
        (rng.rand(C) + 0.5).astype(np.float32),
    )


@pytest.fixture(scope="module")
def fp32_case():
    """B=2, V=56, C=1024: the port's plain output and both JAX ones."""
    args = _inputs(2, 56, 1024)
    tgc.launches = 0
    got = tgc.graph_propagate(*map(torch.from_numpy, args)).numpy()
    return dict(
        args=args,
        got=got,
        launches=tgc.launches,
        reference=np.asarray(graph_propagate_reference(*args)),
        pallas=np.asarray(graph_propagate_pallas(*args, weight_tile=512, interpret=True)),
    )


@pytest.mark.parametrize("oracle", ["reference", "pallas"])
def test_plain_matches_jax(fp32_case, oracle):
    np.testing.assert_allclose(fp32_case["got"], fp32_case[oracle], atol=2e-4)


def test_cpu_tensors_take_the_plain_version(fp32_case):
    assert fp32_case["launches"] == 0
    want = tgc.graph_propagate_reference(*map(torch.from_numpy, fp32_case["args"])).numpy()
    np.testing.assert_array_equal(fp32_case["got"], want)


def test_v2_matches_pallas_v2():
    """v2 entry (bf16-held f and adj, fp32 math) vs the Pallas v2 kernel."""
    args = _inputs(4, 56, 1024, seed=1)
    got = tgc.graph_propagate_v2(*map(torch.from_numpy, args)).numpy()
    want = np.asarray(graph_propagate_pallas_v2(*args, weight_tile=256, interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_bf16_rounding_matches_jax():
    x = np.random.RandomState(2).randn(4096).astype(np.float32) * 3
    got = tgc.round_bf16(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    np.testing.assert_array_equal(got, want)


def test_graph_conv_layer_eval_matches_jax():
    """Port GraphConvLayer (eval) vs JAX GraphConvLayer.apply(train=False)
    with the same weights: flax (in, out) kernel = torch weight.T."""
    f, adj, W, scale, bias, mean, var = _inputs(2, 56, 1024, seed=3)
    jax_layer = JaxGraphConvLayer(in_features=1024, out_features=1024)
    variables = {
        "params": {"linear": {"kernel": jnp.asarray(W)},
                   "bn": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
        "batch_stats": {"bn": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}},
    }
    want = np.asarray(jax_layer.apply(variables, jnp.asarray(f), jnp.asarray(adj), train=False))

    layer = TorchGraphConvLayer(1024, 1024).eval()
    with torch.no_grad():
        layer.linear.weight.copy_(torch.from_numpy(W.T))
        layer.bn.weight.copy_(torch.from_numpy(scale))
        layer.bn.bias.copy_(torch.from_numpy(bias))
        layer.bn.running_mean.copy_(torch.from_numpy(mean))
        layer.bn.running_var.copy_(torch.from_numpy(var))
        got = layer(torch.from_numpy(f), torch.from_numpy(adj)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(dist_method="dot"),
        dict(mask_diag=True),
        dict(residual="additive"),
        dict(use_pose=False),
        dict(learn_graph=False),
    ],
)
def test_unported_layer_variants_raise(kwargs):
    with pytest.raises(NotImplementedError):
        TorchGraphConvLayer(128, 128, **kwargs)


def test_unported_layer_modes_raise():
    """`vertex_mask` is still unported; train mode (ported since) is held
    against JAX's apply(train=True) in test_graph_conv_layer_train_matches_jax."""
    layer = TorchGraphConvLayer(128, 128)
    x, adj = torch.zeros(1, 4, 128), torch.ones(1, 4, 4)
    with pytest.raises(NotImplementedError):
        layer.eval()(x, adj, vertex_mask=torch.ones(1, 4))
    assert layer.train()(x, adj).shape == (1, 4, 128)


def test_graph_conv_layer_train_matches_jax():
    """Train mode: BN over the B * V rows on batch statistics, and the
    running statistics updated with flax's rule (biased variance,
    momentum 0.9). Gradients are held at the model level
    (tests/test_torch_train.py)."""
    f, adj, W, scale, bias, mean, var = _inputs(2, 56, 1024, seed=4)
    jax_layer = JaxGraphConvLayer(in_features=1024, out_features=1024)
    params = {"linear": {"kernel": jnp.asarray(W)},
              "bn": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    stats = {"bn": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}

    want, mutated = jax_layer.apply({"params": params, "batch_stats": stats}, jnp.asarray(f),
                                    jnp.asarray(adj), train=True, mutable=["batch_stats"])
    want_stats = mutated["batch_stats"]["bn"]

    layer = TorchGraphConvLayer(1024, 1024).train()
    with torch.no_grad():
        layer.linear.weight.copy_(torch.from_numpy(W.T))
        layer.bn.weight.copy_(torch.from_numpy(scale))
        layer.bn.bias.copy_(torch.from_numpy(bias))
        layer.bn.running_mean.copy_(torch.from_numpy(mean))
        layer.bn.running_var.copy_(torch.from_numpy(var))
        got = layer(torch.from_numpy(f), torch.from_numpy(adj))
    # The l2 affinity's diagonal is the square root of fp32 cancellation
    # noise (d2_ii ~ 1e-6 -> dist_ii ~ 1e-3, not 0), different in the two
    # frameworks' summation orders: ~3e-4 in G against float64. Train-mode
    # BN divides G @ h by its batch std (6e-3 at the smallest channel
    # here), so the outputs differ by up to ~5e-4 (eval: 2e-4, above).
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    for ours, theirs in ((layer.bn.running_mean, "mean"), (layer.bn.running_var, "var")):
        np.testing.assert_allclose(ours.numpy(), np.asarray(want_stats[theirs]), rtol=1e-5,
                                   atol=1e-7)
