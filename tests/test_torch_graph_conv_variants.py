"""ganet's graph layer held against agrl_tpu: the fused op's plain twin
with `mask_diag` and `additive` (K1's two flags) vs agrl_tpu's
GraphConvLayer(mask_diag=True, residual="additive") in eval, at gamma 0.3
and 0.0 (ganet's own: x + 0 * h' hides the graph, so 0.3 is where a wrong
diagonal or epilogue would show), with and without a vertex mask, in the
modes both, pose and learned; then the layer's train forward, gradients
and BN running statistics against apply(train=True). Inputs from numpy
seeds; agrl_tpu on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrl_torch.models.layers import GraphConvLayer
from agrl_torch.ops import graph_conv as tgc
from agrl_tpu.models import layers as jax_layers
from tests.test_torch_graph_modes import FLAGS, _layer_inputs

torch.set_num_threads(2)

B, V, C = 2, 56, 256


def _ganet_layers(mode, gamma, a):
    use_pose, learn_graph = FLAGS[mode]
    jlayer = jax_layers.GraphConvLayer(in_features=C, out_features=C, use_pose=use_pose,
                                       learn_graph=learn_graph, gamma=gamma, mask_diag=True,
                                       residual="additive")
    jvars = {"params": {"linear": {"kernel": jnp.asarray(a["W"])},
                        "bn": {"scale": jnp.asarray(a["scale"]), "bias": jnp.asarray(a["bias"])}},
             "batch_stats": {"bn": {"mean": jnp.asarray(a["mean"]), "var": jnp.asarray(a["var"])}}}
    layer = GraphConvLayer(C, C, use_pose=use_pose, learn_graph=learn_graph, gamma=gamma,
                           mask_diag=True, residual="additive")
    with torch.no_grad():
        layer.linear.weight.copy_(torch.from_numpy(a["W"].T))
        layer.bn.weight.copy_(torch.from_numpy(a["scale"]))
        layer.bn.bias.copy_(torch.from_numpy(a["bias"]))
        layer.bn.running_mean.copy_(torch.from_numpy(a["mean"]))
        layer.bn.running_var.copy_(torch.from_numpy(a["var"]))
    return jlayer, jvars, layer


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("gamma", [0.3, 0.0])
@pytest.mark.parametrize("mode", ["both", "pose", "learned"])
def test_plain_twin_matches_ganet_layer(mode, gamma, masked):
    """graph_propagate_reference(mask_diag=True, additive=True) and the
    port's layer in eval (which is that op on the CPU) vs agrl_tpu's ganet
    layer: within 1e-5 of max."""
    a = _layer_inputs(B, V, C, seed=7)
    jlayer, jvars, layer = _ganet_layers(mode, gamma, a)
    vm = a["mask"] if masked else None
    want = np.asarray(jlayer.apply(jvars, jnp.asarray(a["f"]), jnp.asarray(a["adj"]), train=False,
                                   vertex_mask=None if vm is None else jnp.asarray(vm)))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = tgc.graph_propagate_reference(
        t["f"], t["adj"], t["W"], t["scale"], t["bias"], t["mean"], t["var"], gamma,
        vertex_mask=None if vm is None else t["mask"], mode=mode, mask_diag=True,
        additive=True).numpy()
    with torch.no_grad():
        layer_out = layer.eval()(t["f"], t["adj"],
                                 vertex_mask=None if vm is None else t["mask"]).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(layer_out - want).max() <= 1e-5 * scale
    if gamma == 0.0:
        np.testing.assert_array_equal(got, a["f"])  # x + 0 * h'


@pytest.mark.parametrize("mode", ["both", "pose", "learned"])
def test_flags_change_the_output(mode):
    """At gamma 0.3 each flag moves the output: the diagonal mask changes
    G, the additive epilogue keeps all of f. The plain twin's graph has a
    zero diagonal and rows summing to 1 (unmasked vertices)."""
    a = _layer_inputs(B, V, C, seed=8)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    args = (t["f"], t["adj"], t["W"], t["scale"], t["bias"], t["mean"], t["var"], 0.3)
    base = tgc.graph_propagate_reference(*args, mode=mode)
    diag = tgc.graph_propagate_reference(*args, mode=mode, mask_diag=True)
    add = tgc.graph_propagate_reference(*args, mode=mode, additive=True)
    assert float((diag - base).abs().max()) > 1e-4
    torch.testing.assert_close(add - base, 0.3 * t["f"], atol=1e-6, rtol=0)
    G = tgc.blended_graph(t["f"], t["adj"], None, mode, mask_diag=True)
    assert float(torch.diagonal(G, dim1=1, dim2=2).abs().max()) == 0.0
    torch.testing.assert_close(G.sum(dim=2), torch.ones(B, V), atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["both", "pose", "learned"])
def test_train_forward_gradients_and_stats_match_jax(mode):
    """The train forward (plain autograd composition, BN on batch
    statistics) at gamma 0.3 with a vertex mask: outputs, the gradients of
    a seeded cotangent w.r.t. x and W, and the BN running statistics
    after the step, each within 1e-5 of max of agrl_tpu's."""
    a = _layer_inputs(B, V, C, seed=9)
    jlayer, jvars, layer = _ganet_layers(mode, 0.3, a)

    def jloss(params, x):
        out, mutated = jlayer.apply({"params": params, "batch_stats": jvars["batch_stats"]}, x,
                                    jnp.asarray(a["adj"]), train=True,
                                    vertex_mask=jnp.asarray(a["mask"]), mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(a["cot"])), (out, mutated["batch_stats"])

    (_, (jout, jstats)), (jg_params, jg_x) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jvars["params"], jnp.asarray(a["f"]))
    x = torch.from_numpy(a["f"]).requires_grad_(True)
    out = layer.train()(x, torch.from_numpy(a["adj"]), vertex_mask=torch.from_numpy(a["mask"]))
    (out * torch.from_numpy(a["cot"])).sum().backward()

    def close(got, want):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    close(out.detach().numpy(), jout)
    close(x.grad.numpy(), jg_x)
    close(layer.linear.weight.grad.numpy().T, jg_params["linear"]["kernel"])
    close(layer.bn.running_mean.numpy(), jstats["bn"]["mean"])
    close(layer.bn.running_var.numpy(), jstats["bn"]["var"])
