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
        # the pose-only and learned-only graphs are ported
        # (tests/test_torch_graph_modes.py); neither is refused, as agrl_tpu's
        # layer asserts, and the unported variants stay so under either graph
        dict(use_pose=False, learn_graph=False),
        dict(mask_diag=True, learn_graph=False),
    ],
)
def test_unported_layer_variants_raise(kwargs):
    neither = not (kwargs.get("use_pose", True) or kwargs.get("learn_graph", True))
    with pytest.raises(ValueError if neither else NotImplementedError):
        TorchGraphConvLayer(128, 128, **kwargs)


def test_unported_layer_modes_raise():
    """No mode of the forward is left unported: `vertex_mask` (held against
    agrl_tpu in tests/test_torch_graph_conv_mask.py) goes to the fused op
    in eval, and train mode is held against JAX's apply(train=True) in
    test_graph_conv_layer_train_matches_jax."""
    layer = TorchGraphConvLayer(128, 128)
    x, adj = torch.zeros(1, 4, 128), torch.ones(1, 4, 4)
    mask = torch.tensor([[1.0, 1.0, 0.0, 0.0]])
    with torch.no_grad():
        got = layer.eval()(x, adj, vertex_mask=mask)
        want = tgc.graph_propagate_reference(
            x, adj, layer.linear.weight.t(), layer.bn.weight, layer.bn.bias,
            layer.bn.running_mean, layer.bn.running_var, layer.gamma, vertex_mask=mask)
    assert torch.equal(got, want)
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


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> tf32 as cvt.rna.tf32.f32 does: round to nearest (ties away
    from zero) on the low 13 mantissa bits, which become 0."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_3xtf32_split_keeps_fp32_accuracy():
    """Why the CUDA kernel's f @ W takes three tf32 products: with x = hi +
    lo, hi = tf32(x), lo = tf32(x - hi), the products lo*hi + hi*lo +
    hi*hi in fp32 stay within 2e-6 of max|f @ W| from float64 at the
    serving shape (B*V = 16*56 rows, C = 2048), as an fp32 product does,
    while one tf32 pass (hi*hi) is ~100x further off. CPU fp32 products
    of tf32 values are exact, so this emulates the tensor cores' inputs;
    their accumulation is another matter (next test)."""
    rng = np.random.RandomState(5)
    f = torch.from_numpy((rng.rand(16 * 56, 2048) * 2.0).astype(np.float32))
    W = torch.from_numpy((rng.randn(2048, 2048) * 0.01).astype(np.float32))
    exact = f.double() @ W.double()
    scale = float(exact.abs().max())

    def err(x):
        return float((x.double() - exact).abs().max()) / scale

    f_hi, W_hi = _round_tf32(f), _round_tf32(W)
    f_lo, W_lo = _round_tf32(f - f_hi), _round_tf32(W - W_hi)
    assert torch.equal(_round_tf32(f_hi), f_hi) and float((f - f_hi - f_lo).abs().max()) > 0
    hi_hi = f_hi @ W_hi
    three = (f_lo @ W_hi + f_hi @ W_lo) + hi_hi
    assert err(three) <= 2e-6
    assert err(f @ W) <= 2e-6
    assert err(hi_hi) > 1e-4


def _round_fp32_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> fp32, truncating (round toward zero)."""
    y = x.float()
    over = y.double().abs() > x.abs()
    y[over] = torch.nextafter(y[over], torch.zeros_like(y[over]))
    return y.double()


def test_3xtf32_truncating_accumulation_needs_promotion():
    """Why the CUDA kernel promotes each K chunk's wgmma accumulators into
    separate fp32 registers. Model of the tensor cores: each k8 step adds
    its 8 exact products to the accumulator and truncates the sum to fp32.
    On one accumulator, the 3 x 256 truncating steps of a C = 2048
    reduction drift well past 2e-6 of max|f @ W| from float64 at the
    serving shape; holding each 32-deep chunk (12 steps) in its own
    accumulator and adding it to the total in fp32 (round to nearest)
    stays within 2e-6, as an fp32 product does. 128 of the 2048 columns
    keep this quick."""
    rng = np.random.RandomState(5)
    f = torch.from_numpy((rng.rand(16 * 56, 2048) * 2.0).astype(np.float32))
    W = torch.from_numpy((rng.randn(2048, 128) * 0.01).astype(np.float32))
    exact = f.double() @ W.double()
    scale = float(exact.abs().max())
    f_hi, W_hi = _round_tf32(f), _round_tf32(W)
    f_lo, W_lo = _round_tf32(f - f_hi), _round_tf32(W - W_hi)
    parts = [(x.double(), y.double()) for x, y in ((f_lo, W_hi), (f_hi, W_lo), (f_hi, W_hi))]

    def product(chunk_steps):
        acc = torch.zeros_like(exact)
        total = torch.zeros_like(exact)
        for step, k in enumerate(range(0, 2048, 8)):
            for x, y in parts:  # the kernel's order: small terms first
                acc = _round_fp32_toward_zero(acc + x[:, k:k + 8] @ y[k:k + 8])
            if chunk_steps and (step + 1) % chunk_steps == 0:
                total = (total + acc).float().double()
                acc = torch.zeros_like(exact)
        return total if chunk_steps else acc

    one_accumulator = float((product(None) - exact).abs().max()) / scale
    promoted = float((product(4) - exact).abs().max()) / scale
    assert one_accumulator > 5e-6
    assert promoted <= 2e-6
