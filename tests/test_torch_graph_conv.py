"""The port's graph op and GraphConvLayer held against agrl_tpu's.

Inputs come from a numpy seed and go through both frameworks; the JAX
side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_ops_pallas.py does. On CPU tensors the port dispatches to its
plain version (the CUDA kernel is checked in tests/test_torch_cuda.py).
"""

import jax
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
        # ganet's diagonal mask and additive residual are ported
        # (tests/test_torch_graph_conv_variants.py); the dot affinity stays
        # refused under them
        dict(dist_method="dot", mask_diag=True),
        dict(dist_method="dot", residual="additive"),
        # the pose-only and learned-only graphs are ported
        # (tests/test_torch_graph_modes.py); neither is refused, as agrl_tpu's
        # layer asserts, and the unported variants stay so under either graph
        dict(use_pose=False, learn_graph=False),
        dict(dist_method="dot", mask_diag=True, learn_graph=False),
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


# ---- the CUDA kernel's long schedule (V > 128), emulated -----------------
#
# The card's long schedule computes its three products (f @ W, the Gram
# f f^T and G @ h) as one 3xTF32 tile product: each operand split into
# tf32 hi/lo, each k8 step's exact products added to a truncating fp32
# accumulator, each 32-deep chunk promoted into the total in fp32. The Gram
# launches only upper tiles and mirrors them; d2 comes from the Gram's own
# diagonal. These tests replay that arithmetic in torch on the CPU.

LONG_C = 2048
LONG_N = 128  # output columns emulated: one of the kernel's column tiles


def _tile_product_3xtf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a (M, K) @ b (K, N), fp32, as the kernel's tile product computes it:
    x = hi + lo, hi = tf32(x), lo = tf32(x - hi); per k8 step lo*hi, hi*lo,
    hi*hi (passes=3; hi*hi alone at passes=1) each added exactly to the
    accumulator, which truncates to fp32; every 4 steps (a 32-deep chunk)
    the accumulator is added into the total (fp32, round to nearest). K
    past the end is TMA's zero fill, which adds nothing."""
    a_hi, b_hi = _round_tf32(a), _round_tf32(b)
    a_lo, b_lo = _round_tf32(a - a_hi), _round_tf32(b - b_hi)
    parts = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)] if passes == 3 else [(a_hi, b_hi)]
    parts = [(x.double(), y.double()) for x, y in parts]
    K = a.shape[1]
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float64)
    total = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for step, k in enumerate(range(0, K, 8)):
        for x, y in parts:
            acc = _round_fp32_toward_zero(acc + x[:, k:k + 8] @ y[k:k + 8])
        if (step + 1) % 4 == 0 or k + 8 >= K:
            total = total + acc.float()
            acc = torch.zeros_like(acc)
    return total


def _long_d2(f: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """(V, C) -> d2 (V, V) as the long schedule's blend reads it: the Gram's
    upper half (upper tiles, and each diagonal tile's upper triangle)
    mirrored, d2_ij = G2_ii + G2_jj - 2 G2_ij in fp32."""
    g = _tile_product_3xtf32(f, f.t().contiguous(), passes)
    g = torch.triu(g) + torch.triu(g, 1).t()
    diag = torch.diagonal(g)
    return diag[:, None] + diag[None, :] - 2.0 * g


def _long_schedule(f, adj, W, scale, bias, mean, var, mask=None, gamma=0.1, passes=3):
    """One clip (V, C) -> its first LONG_N output columns, as the long
    schedule computes them: the Gram stage (_long_d2), the blend (masked
    affinity and pose rows, row L1 sums, mode "both"), h = f @ W and G @ h
    as 3xTF32 tile products, then BN, LeakyReLU(0.1) and the convex
    residual; `passes` applies to the Gram."""
    d2 = _long_d2(f, passes)
    pair = torch.ones_like(adj) if mask is None else mask[:, None] * mask[None, :]
    s = 2.0 / (1.0 + torch.exp(torch.sqrt(torch.clamp(d2, min=1e-12)))) * pair
    a = adj * pair
    G = 0.5 * (a / torch.clamp(a.abs().sum(1, keepdim=True), min=1e-12)
               + s / torch.clamp(s.abs().sum(1, keepdim=True), min=1e-12))
    h = _tile_product_3xtf32(f, W[:, :LONG_N].contiguous())
    hp = _tile_product_3xtf32(G, h)
    mul = torch.rsqrt(var[:LONG_N] + tgc.BN_EPS) * scale[:LONG_N]
    y = (hp - mean[:LONG_N]) * mul + bias[:LONG_N]
    y = torch.where(y >= 0, y, 0.1 * y)
    return (1.0 - gamma) * f[:, :LONG_N] + gamma * y


def _video_inputs(B, V, seed):
    """Long clips of 7 parts a frame, video-like: each part is its clip's
    ReLU-like base plus 1e-3-scale noise per frame, so every vertex has
    near-duplicates (d ~ 0.06) in the other frames; W ~ N(0, 0.01), a 0/1
    pose graph, BN running statistics."""
    rng = np.random.RandomState(seed)
    base = rng.rand(B, 1, 7, LONG_C) * 2.0
    f = base + rng.randn(B, V // 7, 7, LONG_C) * 1e-3
    return (
        f.reshape(B, V, LONG_C).astype(np.float32),
        (rng.rand(B, V, V) > 0.5).astype(np.float32),
        (rng.randn(LONG_C, LONG_C) * 0.01).astype(np.float32),
        (rng.rand(LONG_C) + 0.5).astype(np.float32),
        (rng.randn(LONG_C) * 0.1).astype(np.float32),
        (rng.randn(LONG_C) * 0.1).astype(np.float32),
        (rng.rand(LONG_C) + 0.5).astype(np.float32),
    )


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("B,V", [(2, 168), (1, 392)])
def test_long_schedule_emulation_matches_jax(B, V, masked):
    """The long schedule's arithmetic (3xTF32 products with per-chunk
    promotion, mirrored upper Gram tiles, d2 from the Gram's diagonal, the
    vertex mask) on near-duplicate vertices at the `all` eval's V = 168 and
    392, C = 2048, against agrl_tpu: graph_propagate_reference unmasked,
    GraphConvLayer(vertex_mask=) masked (trailing frames padded, their pose
    rows zeroed). Output columns 0..127 within 1e-5 of max|reference| (both
    fp32 with other summation orders; padded rows included)."""
    args = _video_inputs(B, V, seed=V + masked)
    f, adj, W, scale, bias, mean, var = args
    mask = None
    if masked:
        real = np.random.RandomState(V).randint(V // 14, V // 7, size=B)
        mask = np.repeat((np.arange(V // 7)[None] < real[:, None]).astype(np.float32), 7, axis=1)
        adj = adj * mask[:, :, None] * mask[:, None, :]
        want = np.asarray(JaxGraphConvLayer(in_features=LONG_C, out_features=LONG_C).apply(
            {"params": {"linear": {"kernel": jnp.asarray(W)},
                        "bn": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
             "batch_stats": {"bn": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}},
            jnp.asarray(f), jnp.asarray(adj), train=False, vertex_mask=jnp.asarray(mask)))
    else:
        want = np.asarray(graph_propagate_reference(f, adj, W, scale, bias, mean, var))
    want = want[:, :, :LONG_N]
    t = [torch.from_numpy(x) for x in (f, adj, W, scale, bias, mean, var)]
    got = np.stack([
        _long_schedule(t[0][b], t[1][b], *t[2:],
                       mask=None if mask is None else torch.from_numpy(mask[b])).numpy()
        for b in range(B)])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("V", [168, 392])
def test_long_schedule_gram_needs_three_tf32_passes(V):
    """Why the long schedule keeps all three tf32 products in its Gram. On
    near-duplicate vertices (C = 2048, |f|^2 ~ 2700) the d2 the blend reads
    (mirrored upper tiles, the Gram's own diagonal) stays within 1e-5 of
    max|d2| of agrl_tpu's l2 affinity (fp32, Precision.HIGHEST) with three
    passes, and misses it with one (hi*hi: ~11 bits of each operand, ~0.09
    off on pairs whose tf32 roundings are independent). Mirroring makes d2
    symmetric bit for bit and d2_ii exactly 0. On these inputs the layer's
    output would not tell them apart: a Gram error reweights neighbours
    whose h are nearly equal, and one pass stays within 1e-5 of the
    output's max there as well (checked here too)."""
    f, adj, W, scale, bias, mean, var = _video_inputs(1, V, seed=V)
    fj = jnp.asarray(f)
    sq = jnp.sum(fj * fj, axis=2)
    want = np.asarray(sq[:, None, :] + sq[:, :, None] - 2.0 * jnp.einsum(
        "bic,bjc->bij", fj, fj, precision=jax.lax.Precision.HIGHEST))[0]
    bar = 1e-5 * np.abs(want).max()
    ft = torch.from_numpy(f[0])
    three, one = _long_d2(ft, 3), _long_d2(ft, 1)
    assert torch.equal(three, three.t()) and not bool(torch.diagonal(three).any())
    assert np.abs(three.numpy() - want).max() <= bar
    assert np.abs(one.numpy() - want).max() > bar
    out = np.asarray(graph_propagate_reference(f, adj, W, scale, bias, mean, var))[0, :, :LONG_N]
    t = [torch.from_numpy(x) for x in (adj[0], W, scale, bias, mean, var)]
    got_one = _long_schedule(ft, *t, passes=1).numpy()
    assert np.abs(got_one - out).max() <= 1e-5 * np.abs(out).max()
