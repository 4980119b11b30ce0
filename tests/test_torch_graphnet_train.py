"""One train step of msppn and msppgn held against agrl_tpu's.

Depth (1,1,1,1), 64x32 clips, S=4, a 2x2 P x K batch, --num-split 4: 22
heads of cross-entropy and of the soft-margin batch-hard triplet loss,
with the bars of tests/test_torch_train.py. agrl_tpu's weights (BN
statistics and affine terms randomized) are bridged into the port; the
same uint8 clips, flips (read off the JAX key) and a non-uniform
adjacency go to both. msppgn runs the paper's graph (pose + learned) and
the pose-only one. Compared: the losses and top-1 over the 22 heads,
every gradient leaf (GraphBlock's emb_q and emb_k among them) and the
running statistics of the trunk, of the three reduce BNs (over
B * total_split * S rows) and of the GraphBlocks' BNs (over B * V rows).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from agrl_torch.engine.trainer import make_train_step
from agrl_torch.optim import init_optim
from agrl_tpu import losses as jl
from agrl_tpu.data.transforms import preprocess_clips as jax_preprocess
from agrl_tpu.models import backbone as jax_backbone
from agrl_tpu.models import graphnet as jax_graphnet
from agrl_tpu.models import layers as jax_layers
from agrl_tpu.models.weight_convert import convert_graphnet_state_dict
from tests.test_torch_archs_train import _flip_decisions
from tests.test_torch_graphnet import (
    NUM_V,
    VARIANTS,
    H,
    S,
    W,
    clip_inputs,
    jax_model,
    jax_variables,
    port_model,
)
from tests.test_torch_train import _flat

torch.set_num_threads(2)

B = 4
STEP_VARIANTS = ("msppn", "msppgn", "msppgn-pose")


@pytest.fixture(scope="module", params=STEP_VARIANTS)
def step(request):
    """agrl_tpu's loss, top-1, gradients (two-pass BN variance, as
    tests/test_torch_train.py takes them) and mutated batch_stats, and the
    port's make_train_step on the same batch."""
    variant = request.param
    arch = VARIANTS[variant][0]
    jmodel = jax_model(variant)
    variables = jax_variables(variant)
    rng = np.random.RandomState(5)
    base = rng.randint(0, 256, (B, 1, 1, 1, 3))
    imgs = np.clip(base + rng.randint(-40, 41, (B, S, H, W, 3)), 0, 255).astype(np.uint8)
    pids = np.array([0, 0, 1, 1], np.int32)
    _, adj = clip_inputs(seed=6, batch=B)
    key = next(k for k in map(jax.random.PRNGKey, range(100))
               if 0 < _flip_decisions(k).sum() < B)
    x = jax_preprocess(jnp.asarray(imgs), key, train=True, flip_aug=True)
    xent_fn = partial(jl.cross_entropy_label_smooth, epsilon=0.0)
    htri_fn = partial(jl.batch_hard_triplet, margin=0.3, soft=True)

    def loss_fn(params, batch_stats, x):
        (outputs, features), mutated = jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, x, jnp.asarray(adj, x.dtype),
            train=True,
            mutable=["batch_stats"])
        xent = jl.deep_supervision(xent_fn, outputs, jnp.asarray(pids))
        htri = jl.deep_supervision(htri_fn, features, jnp.asarray(pids))
        top1 = jnp.mean(jnp.stack([jnp.mean(jnp.argmax(o, axis=1) == pids) for o in outputs]))
        return xent + htri, (mutated["batch_stats"], xent, htri, top1, len(outputs))

    def value_and_grad(bn, variables, x):
        real = jax_backbone.BatchNorm
        jax_backbone.BatchNorm = jax_layers.BatchNorm = jax_graphnet.BatchNorm = bn
        try:
            return jax.jit(jax.value_and_grad(partial(loss_fn, x=x), has_aux=True))(
                variables["params"], variables["batch_stats"])
        finally:
            jax_backbone.BatchNorm = jax_layers.BatchNorm = jax_graphnet.BatchNorm = real

    (loss, (stats, xent, htri, top1, n_heads)), _ = value_and_grad(
        jax_backbone.BatchNorm, variables, x)
    two_pass = partial(flax_nn.BatchNorm, momentum=0.9, epsilon=1e-5, use_fast_variance=False)
    with jax.enable_x64(True):
        as64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        _, grads = value_and_grad(two_pass, as64, jnp.asarray(np.asarray(x), jnp.float64))
        grads = jax.tree.map(lambda a: np.asarray(a, np.float32), grads)

    model = port_model(variant)
    from agrl_torch.models.weight_convert import from_jax_variables

    from_jax_variables(variables, model)
    opt = init_optim("adam", model.parameters(), 1e-4, weight_decay=5e-4)
    train_step = make_train_step(model, opt, lambda s: 1e-4, label_smooth=False,
                                 aug={"flip_aug": True})
    metrics = train_step(imgs, pids, adj, flip=_flip_decisions(key))
    return dict(arch=arch, variant=variant, loss=float(loss), xent=float(xent),
                htri=float(htri), top1=float(top1), n_heads=n_heads,
                grads=dict(_flat(grads)), stats=dict(_flat(stats)), model=model,
                metrics=metrics)


def test_step_heads_and_losses_match_jax(step):
    assert step["n_heads"] == NUM_V + 1 == 22
    m = step["metrics"]
    for name, got in (("loss", m["loss"]), ("xent", m["xent_loss"]), ("htri", m["htri_loss"])):
        np.testing.assert_allclose(float(got), step[name], rtol=1e-5, err_msg=name)
    assert float(m["top1"]) == pytest.approx(step["top1"], abs=1e-6)


def test_step_gradients_match_jax(step):
    """Every gradient leaf, with tests/test_torch_train.py's bars:
    Frobenius within 1e-2 and the largest entry within 5e-2 of the leaf's
    largest. msppgn's emb_q and emb_k kernels are among them (not in the
    pose-only graph, which has none)."""
    model = step["model"]
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    mapped = dict(_flat(convert_graphnet_state_dict(grads, step["arch"])[0]["params"]))
    assert mapped.keys() == step["grads"].keys()
    if step["variant"] == "msppgn":
        assert {"gb_0/emb_q/kernel", "gb_1/emb_k/kernel"} <= mapped.keys()
    bad = []
    for name, want in step["grads"].items():
        got = mapped[name]
        assert got.shape == want.shape, name
        if name.endswith(("emb_k/bias", "reduce/bias")):
            # zero up to rounding in both frameworks: q_i . (k_j + b) shifts
            # row i's logits by q_i . b for every j, which the softmax
            # ignores; a reduce bias is taken out again by the train-mode
            # BN's batch mean right after it
            ref = np.abs(step["grads"][name[:-4] + "kernel"]).max()
            if max(np.abs(got).max(), np.abs(want).max()) > 1e-4 * ref:
                bad.append((name, np.abs(got).max(), np.abs(want).max(), ref))
            continue
        fro = np.linalg.norm(got - want) / np.linalg.norm(want)
        worst = np.abs(got - want).max() / np.abs(want).max()
        if not (fro <= 1e-2 and worst <= 5e-2):
            bad.append((name, fro, worst))
    assert not bad, bad


def test_step_batch_stats_match_jax(step):
    """The running statistics after the step, flax's rule, within 1e-5 of
    max per leaf: the trunk, the three reduce BNs and the GraphBlocks'."""
    model = step["model"]
    state = {k: v for k, v in model.state_dict().items() if "running" in k}
    got = dict(_flat(convert_graphnet_state_dict(state, step["arch"])[0]["batch_stats"]))
    assert got.keys() == step["stats"].keys()
    assert {"reduce_f1/bn/mean", "reduce_f3/bn/var"} <= got.keys()
    if step["arch"] == "msppgn":
        assert {"gb_0/bn/mean", "gb_1/bn/var"} <= got.keys()
    for name, want in step["stats"].items():
        assert np.abs(got[name] - want).max() <= 1e-5 * np.abs(want).max(), name
