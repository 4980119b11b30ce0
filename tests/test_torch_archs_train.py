"""One train step of each single-scale arch held against agrl_tpu's.

gsta, ganet (both with the consistent loss: 2 heads), res50tp,
resnet50_s1, sta and simple_sta at depth (1,1,1,1), 64x32 clips, S=4, a
2x2 P x K batch, with the bars of tests/test_torch_train.py. agrl_tpu's
weights (BN statistics and affine terms randomized, ganet's PAM gamma
nonzero) are bridged into the port; the same uint8 clips, flips and
consistent-loss draws go to both. The frame each clip drops is made known
on the JAX side by replacing `jax.random.randint` inside this test and
handed to the port as `subclip_indices`; the flips are read off the JAX
key and handed to the port as `flip`. ganet's graph layers return
x + 0 * h' (gamma 0.0), so their effect shows only in their BN running
statistics and in PAM's gamma gradient, both compared here.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from agrl_torch.engine.trainer import make_train_step
from agrl_torch.models.weight_convert import from_jax_variables
from agrl_torch.optim import init_optim
from agrl_tpu import losses as jl
from agrl_tpu.data.transforms import preprocess_clips as jax_preprocess
from agrl_tpu.models import backbone as jax_backbone
from agrl_tpu.models import layers as jax_layers
from agrl_tpu.models import sta as jax_sta
from agrl_tpu.models.weight_convert import convert_torch_state_dict
from tests.test_torch_archs import ARCHS, H, S, W, jax_model, jax_variables, port_model
from tests.test_torch_train import _flat

torch.set_num_threads(2)

B, NUM_CLASSES = 4, 10
DROP = np.array([2, 0, 3, 1])  # the frame each clip drops (gsta, ganet)
CONSISTENT = ("gsta", "ganet")


def _flip_decisions(key):
    """agrl_tpu's per-clip flip draws from `key` (transforms.py:298-307)."""
    return np.array([bool(jax.random.uniform(jax.random.split(k, 4)[0]) < 0.5)
                     for k in jax.random.split(key, B)])


@pytest.fixture(scope="module", params=ARCHS)
def step(request):
    """agrl_tpu's loss, gradients (two-pass BN variance, as
    tests/test_torch_train.py takes them) and mutated batch_stats, and the
    port's make_train_step on the same batch."""
    arch = request.param
    jmodel = jax_model(arch, consistent_loss=arch in CONSISTENT)
    variables = jax_variables(arch)
    rng = np.random.RandomState(5)
    base = rng.randint(0, 256, (B, 1, 1, 1, 3))
    imgs = np.clip(base + rng.randint(-40, 41, (B, S, H, W, 3)), 0, 255).astype(np.uint8)
    pids = np.array([0, 0, 1, 1], np.int32)
    V = S * 7
    adj = ((rng.rand(B, V, V) > 0.5) + np.eye(V)).astype(np.float32)
    key = next(k for k in map(jax.random.PRNGKey, range(100))
               if 0 < _flip_decisions(k).sum() < B)
    x = jax_preprocess(jnp.asarray(imgs), key, train=True, flip_aug=True)
    xent_fn = partial(jl.cross_entropy_label_smooth, epsilon=0.0)
    htri_fn = partial(jl.batch_hard_triplet, margin=0.3, soft=True)

    def loss_fn(params, batch_stats):
        (outputs, features), mutated = jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, x, jnp.asarray(adj), train=True,
            mutable=["batch_stats"], rngs={"subclip": jax.random.PRNGKey(9)})
        outputs = outputs if isinstance(outputs, list) else [outputs]
        features = features if isinstance(features, list) else [features]
        xent = jl.deep_supervision(xent_fn, outputs, jnp.asarray(pids))
        htri = jl.deep_supervision(htri_fn, features, jnp.asarray(pids))
        return xent + htri, (mutated["batch_stats"], xent, htri, len(outputs))

    def value_and_grad(bn):
        real_randint, real = jax.random.randint, (jax_backbone.BatchNorm, jax_sta.BatchNorm)
        jax.random.randint = lambda key, shape, lo, hi: jnp.asarray(DROP)
        jax_backbone.BatchNorm = jax_layers.BatchNorm = jax_sta.BatchNorm = bn
        try:
            return jax.value_and_grad(loss_fn, has_aux=True)(variables["params"],
                                                             variables["batch_stats"])
        finally:
            jax.random.randint = real_randint
            jax_backbone.BatchNorm = jax_layers.BatchNorm = real[0]
            jax_sta.BatchNorm = real[1]

    (loss, (stats, xent, htri, n_heads)), _ = value_and_grad(jax_backbone.BatchNorm)
    two_pass = partial(flax_nn.BatchNorm, momentum=0.9, epsilon=1e-5, use_fast_variance=False)
    _, grads = value_and_grad(two_pass)

    model = port_model(arch, consistent_loss=arch in CONSISTENT)
    from_jax_variables(variables, model)
    opt = init_optim("adam", model.parameters(), 1e-4, weight_decay=5e-4)
    train_step = make_train_step(model, opt, lambda s: 1e-4, label_smooth=False,
                                 aug={"flip_aug": True})
    metrics = train_step(imgs, pids, adj, flip=_flip_decisions(key),
                         subclip_indices=DROP if arch in CONSISTENT else None)
    return dict(arch=arch, loss=float(loss), xent=float(xent), htri=float(htri),
                n_heads=n_heads, grads=dict(_flat(grads)), stats=dict(_flat(stats)),
                model=model, metrics=metrics)


def test_step_heads_and_losses_match_jax(step):
    assert step["n_heads"] == (2 if step["arch"] in CONSISTENT else 1)
    m = step["metrics"]
    for name, got in (("loss", m["loss"]), ("xent", m["xent_loss"]), ("htri", m["htri_loss"])):
        np.testing.assert_allclose(float(got), step[name], rtol=1e-5, err_msg=name)


def test_step_gradients_match_jax(step):
    """Every gradient leaf, with tests/test_torch_train.py's bars:
    Frobenius within 1e-2 and the largest entry within 5e-2 of the leaf's
    largest (fp32 gradients ahead of a train-mode BN cancel). ganet's PAM
    gamma is among them; its graph layers' leaves are exactly 0 in both."""
    model = step["model"]
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    mapped = dict(_flat(convert_torch_state_dict(grads)[0]["params"]))
    assert mapped.keys() == step["grads"].keys()
    if step["arch"] == "ganet":
        assert "pam_layer/gamma" in mapped and np.abs(step["grads"]["pam_layer/gamma"]).max() > 0
    for name, want in step["grads"].items():
        got = mapped[name]
        assert got.shape == want.shape, name
        if not want.any():  # ganet's graph layers: x + 0 * h' passes no gradient
            assert not got.any(), name
            continue
        if name == "pam_layer/key_conv/bias":
            # q_i . (k_j + b) shifts row i's logits by q_i . b for every j,
            # which the softmax ignores: the gradient is 0 up to rounding
            # (~1e-8 here) in both frameworks
            ref = np.abs(step["grads"]["pam_layer/key_conv/kernel"]).max()
            assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-5 * ref, name
            continue
        fro = np.linalg.norm(got - want) / np.linalg.norm(want)
        worst = np.abs(got - want).max() / np.abs(want).max()
        assert fro <= 1e-2 and worst <= 5e-2, (name, fro, worst)


def test_step_batch_stats_match_jax(step):
    """The running statistics after the step, flax's rule, within 1e-5 of
    max per leaf: the trunk, layer4, the BNNeck (per frame in
    resnet50_s1, over B * S rows), sta's fc1 BN and ganet's graph-layer
    BNs, which carry the masked graph's effect."""
    model = step["model"]
    state = {k: v for k, v in model.state_dict().items() if "running" in k}
    got = dict(_flat(convert_torch_state_dict(state)[0]["batch_stats"]))
    assert got.keys() == step["stats"].keys()
    if step["arch"] == "ganet":
        assert any(k.startswith("graph_layer_") for k in got)
    for name, want in step["stats"].items():
        assert np.abs(got[name] - want).max() <= 1e-5 * np.abs(want).max(), name
