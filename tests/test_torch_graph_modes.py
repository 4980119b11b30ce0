"""GraphConvLayer's graphs by flag held against agrl_tpu: the pose graph
alone (`--use-pose`), the l2 learned graph alone (`--learn-graph`) and
both (agrl_tpu/models/layers.py:219-238), the layer's eval and train
forward and its gradients against `GraphConvLayer.apply`, the vmgn_tiny
eval features and train gradients against `VMGN.apply`; the fused op's
four modes against a float64 composition; `blend_graph_l2`'s forward and
hand-written backward against agrl_tpu's custom VJP. Inputs from numpy
seeds; agrl_tpu on the CPU."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn
from torch.utils.flop_counter import FlopCounterMode

from agrl_torch.models import build_model, default_num_vertices
from agrl_torch.models.layers import GraphConvLayer, blend_graph_l2
from agrl_torch.models.weight_convert import from_jax_variables
from agrl_torch.ops import graph_conv as tgc
from agrl_tpu.models import backbone as jax_backbone
from agrl_tpu.models import init_model as jax_init_model
from agrl_tpu.models import init_params
from agrl_tpu.models import layers as jax_layers
from agrl_tpu.models.weight_convert import convert_torch_state_dict
from tests.test_torch_vmgn import _randomize

torch.set_num_threads(2)

# (use_pose, learn_graph) -> the fused op's mode
FLAGS = {"pose": (True, False), "learned": (False, True), "both": (True, True)}


def _layer_inputs(B, V, C, seed):
    rng = np.random.RandomState(seed)
    return dict(
        f=(rng.randn(B, V, C) * 0.1).astype(np.float32),
        adj=((rng.rand(B, V, V) > 0.5) + np.eye(V)).astype(np.float32),
        W=(rng.randn(C, C) * 0.05).astype(np.float32),
        scale=(rng.rand(C) + 0.5).astype(np.float32),
        bias=(rng.randn(C) * 0.1).astype(np.float32),
        mean=(rng.randn(C) * 0.1).astype(np.float32),
        var=(rng.rand(C) + 0.5).astype(np.float32),
        mask=np.concatenate([np.ones((B, V - 5)), np.zeros((B, 5))], 1).astype(np.float32),
        cot=rng.randn(B, V, C).astype(np.float32),
    )


def _both_layers(mode, a):
    use_pose, learn_graph = FLAGS[mode]
    C = a["W"].shape[0]
    jlayer = jax_layers.GraphConvLayer(in_features=C, out_features=C, use_pose=use_pose,
                                       learn_graph=learn_graph)
    jvars = {"params": {"linear": {"kernel": jnp.asarray(a["W"])},
                        "bn": {"scale": jnp.asarray(a["scale"]), "bias": jnp.asarray(a["bias"])}},
             "batch_stats": {"bn": {"mean": jnp.asarray(a["mean"]), "var": jnp.asarray(a["var"])}}}
    layer = GraphConvLayer(C, C, use_pose=use_pose, learn_graph=learn_graph)
    with torch.no_grad():
        layer.linear.weight.copy_(torch.from_numpy(a["W"].T))
        layer.bn.weight.copy_(torch.from_numpy(a["scale"]))
        layer.bn.bias.copy_(torch.from_numpy(a["bias"]))
        layer.bn.running_mean.copy_(torch.from_numpy(a["mean"]))
        layer.bn.running_var.copy_(torch.from_numpy(a["var"]))
    assert layer.mode == mode
    return jlayer, jvars, layer


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["pose", "learned"])
def test_layer_eval_matches_jax(mode, masked):
    """The eval forward (the fused op's plain twin on the CPU) vs
    GraphConvLayer.apply(train=False), with and without a vertex mask:
    the bar of the both-graph layer (tests/test_torch_graph_conv.py)."""
    a = _layer_inputs(2, 56, 512, seed=1)
    jlayer, jvars, layer = _both_layers(mode, a)
    vm = a["mask"] if masked else None
    want = jlayer.apply(jvars, jnp.asarray(a["f"]), jnp.asarray(a["adj"]), train=False,
                        vertex_mask=None if vm is None else jnp.asarray(vm))
    with torch.no_grad():
        got = layer.eval()(torch.from_numpy(a["f"]), torch.from_numpy(a["adj"]),
                           vertex_mask=None if vm is None else torch.from_numpy(vm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("mode", ["pose", "learned", "both"])
def test_layer_train_forward_and_gradients_match_jax(mode):
    """Train mode (BN on batch statistics, two-pass variance on the JAX
    side as tests/test_torch_train.py takes it): the output, the running
    statistics, and the gradients of <out, cot> with respect to the
    input, the linear kernel and the BN affine terms."""
    a = _layer_inputs(2, 28, 128, seed=2)
    jlayer, jvars, layer = _both_layers(mode, a)
    two_pass = partial(flax_nn.BatchNorm, momentum=0.9, epsilon=1e-5, use_fast_variance=False)
    shipped = jax_layers.BatchNorm
    jax_layers.BatchNorm = two_pass
    try:
        def loss(params, f):
            out, mutated = jlayer.apply({"params": params, "batch_stats": jvars["batch_stats"]},
                                        f, jnp.asarray(a["adj"]), train=True,
                                        mutable=["batch_stats"])
            return jnp.sum(out * a["cot"]), (out, mutated["batch_stats"])

        (_, (want, stats)), (gp, gf) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            jvars["params"], jnp.asarray(a["f"]))
    finally:
        jax_layers.BatchNorm = shipped
    f = torch.from_numpy(a["f"]).requires_grad_()
    out = layer.train()(f, torch.from_numpy(a["adj"]))
    (out * torch.from_numpy(a["cot"])).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-3)
    np.testing.assert_allclose(layer.bn.running_mean.numpy(), np.asarray(stats["bn"]["mean"]),
                               rtol=1e-5, atol=1e-7)
    pairs = [(f.grad, gf), (layer.linear.weight.grad.t(), gp["linear"]["kernel"]),
             (layer.bn.weight.grad, gp["bn"]["scale"]), (layer.bn.bias.grad, gp["bn"]["bias"])]
    for got, want in pairs:
        got, want = got.numpy(), np.asarray(want)
        assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)


S, H, W, B = 4, 64, 32, 2


@pytest.fixture(scope="module", params=["pose", "learned"])
def tiny(request):
    """agrl_tpu's vmgn_tiny with one graph mode, its weights (BN statistics
    randomized) bridged into the port's."""
    use_pose, learn_graph = FLAGS[request.param]
    jmodel = jax_init_model("vmgn_tiny", num_classes=6, use_pose=use_pose,
                            learn_graph=learn_graph)
    variables = init_params(jmodel, jax.random.PRNGKey(0), seq_len=S, height=H, width=W)
    variables = _randomize(jax.tree.map(np.asarray, dict(variables)), seed=2)
    tmodel = build_model("vmgn_tiny", num_classes=6, use_pose=use_pose, learn_graph=learn_graph)
    from_jax_variables(variables, tmodel)
    rng = np.random.RandomState(4)
    base = rng.rand(B, 1, 1, 1, 3)
    x = np.clip(base + rng.randn(B, S, H, W, 3) * 0.2, 0, 1).astype(np.float32)
    V = default_num_vertices(tmodel, S)
    adj = ((rng.rand(B, V, V) > 0.5) + np.eye(V)).astype(np.float32)
    return request.param, jmodel, variables, tmodel, x, adj


def test_vmgn_eval_features_match_jax(tiny):
    mode, jmodel, variables, tmodel, x, adj = tiny
    assert {layer.mode for layer in tmodel.graph_layers} == {mode}
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), jnp.asarray(adj), train=False))
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(x), torch.from_numpy(adj)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-4)


def test_vmgn_train_gradients_match_jax(tiny):
    """Gradients of sum over heads of <logits, cot> through the train
    forward, per parameter leaf: the bars of tests/test_torch_train.py
    (Frobenius 1e-2, worst entry 5e-2 of the leaf's largest; fp32 alone is
    ~3e-3 from float64 here), two-pass BN variance on the JAX side."""
    mode, jmodel, variables, tmodel, x, adj = tiny
    cot = np.random.RandomState(5).randn(B, 6).astype(np.float32)
    two_pass = partial(flax_nn.BatchNorm, momentum=0.9, epsilon=1e-5, use_fast_variance=False)
    shipped = jax_backbone.BatchNorm
    jax_backbone.BatchNorm = jax_layers.BatchNorm = two_pass
    try:
        def loss(params):
            (outputs, _), _ = jmodel.apply(
                {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
                jnp.asarray(adj), train=True, mutable=["batch_stats"])
            return sum(jnp.sum(o * cot) for o in outputs)

        grads = jax.grad(loss)(jax.tree.map(jnp.asarray, variables["params"]))
    finally:
        jax_backbone.BatchNorm = jax_layers.BatchNorm = shipped
    tmodel.train()
    outputs, _ = tmodel(torch.from_numpy(x), torch.from_numpy(adj))
    tmodel.zero_grad()
    sum((o * torch.from_numpy(cot)).sum() for o in outputs).backward()
    got = convert_torch_state_dict(
        {n: p.grad for n, p in tmodel.named_parameters() if p.requires_grad})[0]["params"]
    want = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert len(want) == len(jax.tree_util.tree_leaves(got))
    for path, w in want:
        g = got
        for k in path:
            g = g[k.key]
        w, g = np.asarray(w), np.asarray(g)
        fro = np.linalg.norm(g - w) / np.linalg.norm(w)
        worst = np.abs(g - w).max() / np.abs(w).max()
        assert fro <= 1e-2 and worst <= 5e-2, (path, fro, worst)


def _graph64(a, mode, masked):
    """The mode's graph in float64, from the module docstring's formulas."""
    f, adj = a["f"].astype(np.float64), a["adj"].astype(np.float64)
    pm = a["mask"][:, :, None] * a["mask"][:, None, :] if masked else 1.0
    d2 = ((f[:, :, None, :] - f[:, None, :, :]) ** 2).sum(-1)
    s = 2.0 / (1.0 + np.exp(np.sqrt(np.maximum(d2, 1e-12)))) * pm
    p = adj * pm

    def row_l1(x):
        return x / np.maximum(np.abs(x).sum(2, keepdims=True), 1e-12)

    return {"pose": row_l1(p), "learned": row_l1(s), "both": (row_l1(p) + row_l1(s)) / 2}[mode]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", tgc.GRAPH_MODES)
def test_op_modes_match_float64(mode, masked):
    """The op on CPU tensors (its plain twin) in each mode: within fp32 of
    a float64 composition."""
    a = _layer_inputs(3, 40, 256, seed=6)
    args = [torch.from_numpy(a[k]) for k in ("f", "adj", "W", "scale", "bias", "mean", "var")]
    vm = torch.from_numpy(a["mask"]) if masked else None
    got = tgc.graph_propagate(*args, 0.1, vertex_mask=vm, mode=mode).numpy()
    f64 = {k: a[k].astype(np.float64) for k in a}
    h = f64["f"] @ f64["W"]
    hp = _graph64(a, mode, masked) @ h
    hp = (hp - f64["mean"]) / np.sqrt(f64["var"] + 1e-5) * f64["scale"] + f64["bias"]
    want = 0.9 * f64["f"] + 0.1 * np.where(hp >= 0, hp, 0.1 * hp)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    if mode == "pose":  # no Gram: f enters through f @ W and the residual only
        other = tgc.graph_propagate(args[0] * 1.0, *args[1:], 0.1, vertex_mask=vm, mode=mode)
        assert torch.equal(other, torch.from_numpy(got))
    with pytest.raises(ValueError):
        tgc.graph_propagate(*args, 0.1, mode="dot")


def test_flop_formula_counts_the_gram_per_mode():
    B, V, C = 2, 28, 128
    a = _layer_inputs(B, V, C, seed=7)
    args = [torch.from_numpy(a[k]) for k in ("f", "adj", "W", "scale", "bias", "mean", "var")]
    counts = {}
    for mode in tgc.GRAPH_MODES:
        with FlopCounterMode(display=False) as counter:
            tgc.graph_propagate(*args, 0.1, mode=mode)
        counts[mode] = counter.get_total_flops()
    products = 2 * B * V * C * C + 2 * B * V * V * C
    gram = 2 * B * V * V * C
    assert counts == {"both": products + gram, "learned": products + gram, "pose": products}


@pytest.mark.parametrize("mode", ["pose", "learned"])
def test_flops_line_counts_each_mode_as_its_plain_layer(mode, monkeypatch):
    """The startup FLOPs line (utils/model_complexity.py) of vmgn_tiny in
    each graph mode: the op's formula gives the count FlopCounterMode
    takes from the plain layer's own products (no Gram for pose), and
    pose counts the both-graph model's count less two layers' Grams."""
    from agrl_torch.models import init_model
    from agrl_torch.utils import model_complexity as tmc

    def count(use_pose, learn_graph):
        model = init_model("vmgn_tiny", num_classes=8, device="cpu", seed=0,
                           use_pose=use_pose, learn_graph=learn_graph)
        return tmc.count_eval_flops(model, 2, 64, 32)

    import agrl_torch.models.layers as layers

    with_op = count(*FLAGS[mode])
    monkeypatch.setattr(layers, "graph_propagate", tgc.graph_propagate_reference)
    assert count(*FLAGS[mode]) == with_op
    monkeypatch.undo()
    gram = 2 * 1 * 14 * 14 * 2048  # one clip of 2 frames x 7 parts, 2048 channels
    assert with_op == count(True, True) - (2 * gram if mode == "pose" else 0)


def test_op_schema_keeps_its_earlier_calls():
    """The registered ops gained `mode` with a default, so a call without it
    (an artifact exported before the modes) still binds, to "both"."""
    for op in (torch.ops.agrl_torch.graph_propagate, torch.ops.agrl_torch.graph_propagate_v2):
        schema = str(op.default._schema)
        assert 'str mode="both"' in schema, schema
    a = _layer_inputs(2, 14, 128, seed=9)
    args = [torch.from_numpy(a[k]) for k in ("f", "adj", "W", "scale", "bias", "mean", "var")]
    old = torch.ops.agrl_torch.graph_propagate(*args, 0.1, None)
    assert torch.equal(old, tgc.graph_propagate(*args, 0.1, mode="both"))


def test_layer_flags_need_a_graph():
    with pytest.raises(ValueError, match="use_pose or learn_graph"):
        GraphConvLayer(64, 64, use_pose=False, learn_graph=False)


def test_blend_graph_l2_matches_jax_forward_and_vjp():
    """blend_graph_l2 and its hand-written backward vs agrl_tpu's custom
    VJP and vs autograd of the plain composition; the pose adjacency has
    an all-zero row (a missing pose) and zero entries in live rows. The
    features are multiples of 1/4, so every squared distance is exact in
    fp32 in both frameworks: otherwise the diagonal's d2 is each
    framework's own cancellation noise, whose square root differs by
    ~1e-3 (the layer tests' bars allow for that)."""
    rng = np.random.RandomState(8)
    x = (rng.randint(-4, 5, (2, 20, 64)) / 4).astype(np.float32)
    x[0, 3] = x[0, 4]  # a zero distance off the diagonal: the clamped sqrt
    adj = (rng.rand(2, 20, 20) > 0.4).astype(np.float32) * rng.choice([-1.0, 1.0], (2, 20, 20))
    adj = adj.astype(np.float32)
    adj[1, 5] = 0.0
    dG = rng.randn(2, 20, 20).astype(np.float32)
    want, vjp = jax.vjp(jax_layers.blend_graph_l2, jnp.asarray(x), jnp.asarray(adj))
    want_dx, want_dadj = vjp(jnp.asarray(dG))

    xt = torch.from_numpy(x).requires_grad_()
    at = torch.from_numpy(adj).requires_grad_()
    got = blend_graph_l2(xt, at)
    got.backward(torch.from_numpy(dG))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    for g, w in ((xt.grad, want_dx), (at.grad, want_dadj)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max())
    # and autograd of the composition it fuses (the layer's "both" graph)
    xa = torch.from_numpy(x).double().requires_grad_()
    aa = torch.from_numpy(adj).double().requires_grad_()
    tgc.blended_graph(xa, aa).backward(torch.from_numpy(dG).double())
    np.testing.assert_allclose(xt.grad.numpy(), xa.grad.numpy(),
                               atol=1e-4 * float(xa.grad.abs().max()))
    np.testing.assert_allclose(at.grad.numpy(), aa.grad.numpy(),
                               atol=1e-5 * float(aa.grad.abs().max()))
