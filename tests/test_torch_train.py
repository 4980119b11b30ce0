"""The port's train step held against agrl_tpu's at vmgn_tiny.

vmgn_tiny (depth 1,1,1,1) with the consistent loss (5 heads), 128x64
clips, S=6, a 2x2 P x K batch. agrl_tpu's weights (with randomized BN
statistics) are bridged into the port by `from_jax_variables`; the same
uint8 clips, flips and consistent-loss subclips go to both. The subclips
are made known on the JAX side by replacing `jax.random.permutation`
inside this test, and handed to the port as `subclip_indices`; the flips
are read off the JAX key and handed to the port as `flip`.
"""

import copy
import itertools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from agrl_torch import losses as tl
from agrl_torch.data.transforms import preprocess_clips
from agrl_torch.engine.trainer import make_train_step
from agrl_torch.models import build_model, default_num_vertices
from agrl_torch.models.weight_convert import from_jax_variables
from agrl_torch.optim import init_optim, multistep_lr, per_step, warmup_multistep_lr
from agrl_tpu import losses as jl
from agrl_tpu import optim as jopt
from agrl_tpu.data.transforms import preprocess_clips as jax_preprocess
from agrl_tpu.models import backbone as jax_backbone
from agrl_tpu.models import init_model as jax_init_model
from agrl_tpu.models import layers as jax_layers
from agrl_tpu.models import init_params
from agrl_tpu.models.weight_convert import convert_torch_state_dict
from tests.test_torch_vmgn import _randomize

torch.set_num_threads(2)

S, H, W, B, NUM_CLASSES = 6, 128, 64, 4, 10
PERMS = [np.array(p) for p in ([3, 0, 5, 1, 4, 2], [5, 4, 0, 2, 3, 1], [1, 2, 3, 4, 5, 0])]
SUBCLIPS = [np.sort(p[:n]) for p, n in zip(PERMS, (S - 3, S - 2, S - 1))]


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _flip_decisions(key):
    """The per-clip flip decisions agrl_tpu's preprocess_clips draws from
    `key` (transforms.py:298-307)."""
    return np.array([
        bool(jax.random.uniform(jax.random.split(k, 4)[0]) < 0.5)
        for k in jax.random.split(key, B)
    ])


@pytest.fixture(scope="module")
def jax_step():
    """Everything the JAX side computes, once: variables, the batch, the
    loss of agrl_tpu's make_train_step loss_fn, its gradients and the
    mutated batch_stats."""
    jmodel = jax_init_model("vmgn_tiny", num_classes=NUM_CLASSES, consistent_loss=True)
    variables = init_params(jmodel, jax.random.PRNGKey(0), seq_len=S, height=H, width=W)
    variables = _randomize(jax.tree.map(np.asarray, dict(variables)), seed=1)

    rng = np.random.RandomState(5)
    # a colour per clip under the noise: clips of one batch must differ for
    # batch-statistics BN over 4 rows not to amplify rounding
    base = rng.randint(0, 256, (B, 1, 1, 1, 3))
    imgs = np.clip(base + rng.randint(-40, 41, (B, S, H, W, 3)), 0, 255).astype(np.uint8)
    pids = np.array([0, 0, 1, 1], np.int32)
    V = S * 7
    adj = ((rng.rand(B, V, V) > 0.5) + np.eye(V)).astype(np.float32)
    key = next(k for k in map(jax.random.PRNGKey, range(100))
               if 0 < _flip_decisions(k).sum() < B)  # both kinds of clip
    x = jax_preprocess(jnp.asarray(imgs), key, train=True, flip_aug=True)

    xent_fn = partial(jl.cross_entropy_label_smooth, epsilon=0.0)
    htri_fn = partial(jl.batch_hard_triplet, margin=0.3, soft=True)

    def loss_fn(params, batch_stats):
        (outputs, features), mutated = jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, x, jnp.asarray(adj), train=True,
            mutable=["batch_stats"], rngs={"subclip": jax.random.PRNGKey(9)},
        )
        xent = jl.deep_supervision(xent_fn, outputs, jnp.asarray(pids))
        htri = jl.deep_supervision(htri_fn, features, jnp.asarray(pids))
        return xent + htri, (mutated["batch_stats"], outputs, features, xent, htri)

    def value_and_grad():
        perms = itertools.cycle(PERMS)
        real = jax.random.permutation
        jax.random.permutation = lambda key, n: jnp.asarray(next(perms))
        try:
            return jax.value_and_grad(loss_fn, has_aux=True)(
                variables["params"], variables["batch_stats"]
            )
        finally:
            jax.random.permutation = real

    (loss, (stats, outputs, features, xent, htri)), grads_one_pass = value_and_grad()
    # Gradients: agrl_tpu's two-pass BatchNorm variance (its configuration
    # when flax lacks the variance clamp, agrl_tpu/models/backbone.py:44-59).
    # Its fp32 gradients lie much closer to a float64 run of the same
    # function than those of the one-pass E[x^2] - E[x]^2 it ships here
    # (test_fp32_gradients_against_float64 prints both).
    two_pass = partial(flax_nn.BatchNorm, momentum=0.9, epsilon=1e-5, use_fast_variance=False)
    shipped = jax_backbone.BatchNorm
    jax_backbone.BatchNorm = jax_layers.BatchNorm = two_pass
    try:
        _, grads = value_and_grad()
    finally:
        jax_backbone.BatchNorm = jax_layers.BatchNorm = shipped
    return dict(
        variables=variables, imgs=imgs, pids=pids, adj=adj, flip=_flip_decisions(key),
        x=np.asarray(x), loss=float(loss), xent=float(xent), htri=float(htri),
        outputs=[np.asarray(o) for o in outputs], features=[np.asarray(f) for f in features],
        grads=dict(_flat(grads)), grads_one_pass=dict(_flat(grads_one_pass)),
        stats=dict(_flat(stats)),
    )


def _port_model(variables):
    model = build_model("vmgn_tiny", num_classes=NUM_CLASSES, consistent_loss=True)
    from_jax_variables(variables, model)
    return model


@pytest.fixture(scope="module")
def port_step(jax_step):
    """One make_train_step call of the port on the same batch (lr 1e-4,
    Adam, eps 0 as the recipe): the model after it and its metrics."""
    model = _port_model(jax_step["variables"])
    before = copy.deepcopy(model)
    opt = init_optim("adam", model.parameters(), 1e-4, weight_decay=5e-4)
    step = make_train_step(model, opt, lambda s: 1e-4, label_smooth=False,
                           aug={"flip_aug": True})
    metrics = step(jax_step["imgs"], jax_step["pids"], jax_step["adj"],
                   flip=jax_step["flip"], subclip_indices=SUBCLIPS)
    return before, model, metrics


def test_train_forward_matches_jax(jax_step, port_step):
    model = port_step[0].train()
    x = preprocess_clips(torch.from_numpy(jax_step["imgs"]), train=True,
                         flip=torch.from_numpy(jax_step["flip"]))
    np.testing.assert_array_equal(x.numpy(), jax_step["x"])
    assert default_num_vertices(model, S) == jax_step["adj"].shape[1]
    with torch.no_grad():
        outputs, features = model(x, torch.from_numpy(jax_step["adj"]),
                                  subclip_indices=SUBCLIPS)
    assert len(outputs) == len(features) == 5
    for got, want in zip(outputs + features, jax_step["outputs"] + jax_step["features"]):
        assert got.shape == want.shape
        # rel 1e-4 of the head's largest entry: fp32 both ways
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_step_loss_and_gradients_match_jax(jax_step, port_step):
    _, model, metrics = port_step
    for name in ("loss", "xent", "htri"):
        got = float(metrics["loss" if name == "loss" else f"{name}_loss"])
        np.testing.assert_allclose(got, jax_step[name], rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    mapped = dict(_flat(convert_torch_state_dict(grads)[0]["params"]))
    assert mapped.keys() == jax_step["grads"].keys()
    # Per leaf, fp32 both ways. The conv kernels ahead of a train-mode BN
    # get gradients whose terms cancel (the loss is invariant to their
    # scale), so fp32 alone, in either framework, lies ~0.3% (Frobenius)
    # and ~3% (largest entry, relative to the leaf's largest) from a
    # float64 run here (test_fp32_gradients_against_float64). The bars sit
    # above that, far under the O(1) of a wrong term.
    for name, want in jax_step["grads"].items():
        got = mapped[name]
        assert got.shape == want.shape, name
        fro = np.linalg.norm(got - want) / np.linalg.norm(want)
        worst = np.abs(got - want).max() / np.abs(want).max()
        assert fro <= 1e-2 and worst <= 5e-2, (name, fro, worst)


def _port_grads_float64(jax_step):
    """The same loss and gradients from the port in float64 throughout."""
    model = _port_model(jax_step["variables"]).double().train()
    x = preprocess_clips(torch.from_numpy(jax_step["imgs"]), train=True,
                         flip=torch.from_numpy(jax_step["flip"])).double()
    outputs, features = model(x, torch.from_numpy(jax_step["adj"]).double(),
                              subclip_indices=SUBCLIPS)
    pids = torch.from_numpy(jax_step["pids"]).long()
    loss = (tl.deep_supervision(partial(tl.cross_entropy_label_smooth, epsilon=0.0), outputs,
                                pids)
            + tl.deep_supervision(tl.batch_hard_triplet, features, pids))
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    return float(loss.detach()), dict(_flat(convert_torch_state_dict(grads)[0]["params"]))


def test_fp32_gradients_against_float64(jax_step, port_step):
    """How far fp32 gradients can be trusted at this size: the port's and
    agrl_tpu's (two-pass BN variance) fp32 gradients both lie within 1e-2
    (Frobenius, worst leaf) of the port's float64 gradients; agrl_tpu's
    shipped one-pass variance is reported beside them."""
    loss64, g64 = _port_grads_float64(jax_step)
    np.testing.assert_allclose(jax_step["loss"], loss64, rtol=1e-5)
    port32 = {n: p.grad for n, p in port_step[1].named_parameters() if p.requires_grad}
    port32 = dict(_flat(convert_torch_state_dict(port32)[0]["params"]))

    def worst(grads):
        return max(np.linalg.norm(grads[n] - g) / np.linalg.norm(g) for n, g in g64.items())

    errs = {"port fp32": worst(port32), "agrl_tpu two-pass": worst(jax_step["grads"]),
            "agrl_tpu one-pass": worst(jax_step["grads_one_pass"])}
    print("worst-leaf Frobenius distance to float64:", errs)
    assert errs["port fp32"] <= 1e-2 and errs["agrl_tpu two-pass"] <= 1e-2, errs


def test_step_batch_stats_match_jax(jax_step, port_step):
    """The running statistics after one step: flax's rule (biased batch
    variance, momentum 0.9) in the trunk, the graph layers and the
    BNNecks (the attention BNNeck updated by all 4 of its calls)."""
    model = port_step[1]
    state = {k: v for k, v in model.state_dict().items() if "running" in k}
    got = dict(_flat(convert_torch_state_dict(state)[0]["batch_stats"]))
    assert got.keys() == jax_step["stats"].keys()
    for name, want in jax_step["stats"].items():
        assert np.abs(got[name] - want).max() <= 1e-5 * np.abs(want).max(), name


def test_step_metrics_are_device_scalars(jax_step, port_step):
    metrics = port_step[2]
    assert set(metrics) == {"loss", "xent_loss", "htri_loss", "top1"}
    assert all(v.dim() == 0 and not v.requires_grad for v in metrics.values())
    top1 = np.mean([(o.argmax(1) == jax_step["pids"]).mean() for o in jax_step["outputs"]])
    np.testing.assert_allclose(float(metrics["top1"]), top1, atol=1e-6)


def test_adam_update_matches_optax_on_the_same_gradients():
    """Three steps on shared gradients, with the lr decaying after the
    first epoch of 2 steps: the port sets lr_fn(step) before each step
    as the trainer does; optax reads lr(count) before counting."""
    rng = np.random.RandomState(0)
    shapes = {"conv": (8, 4, 3, 3), "bn": (8,), "fc": (10, 8)}
    # magnitudes of trained weights (|p| < 1): an ulp of p stays under 1e-7
    params = {k: np.clip(rng.randn(*s) * 0.3, -0.99, 0.99).astype(np.float32)
              for k, s in shapes.items()}
    grads = [
        {k: (rng.randn(*s) * 10.0 ** rng.randint(-9, -1, s)).astype(np.float32)
         for k, s in shapes.items()}
        for _ in range(3)
    ]
    lr_fn = per_step(multistep_lr(1e-4, [1]), steps_per_epoch=2)
    j_lr_fn = jopt.per_step(jopt.multistep_lr(1e-4, [1]), steps_per_epoch=2)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = init_optim("adam", tparams.values(), lr_fn(0), weight_decay=5e-4)
    tx = jopt.init_optim("adam", j_lr_fn, weight_decay=5e-4)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    for step, g in enumerate(grads):
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        for group in opt.param_groups:
            group["lr"] = lr_fn(step)
        before = {k: p.detach().clone() for k, p in tparams.items()}
        opt.step()
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        for k in shapes:
            np.testing.assert_allclose((tparams[k].detach() - before[k]).numpy(),
                                       np.asarray(updates[k]), atol=1e-7, rtol=0,
                                       err_msg=f"{k} update of step {step + 1}")
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                       atol=1e-7, rtol=0, err_msg=f"{k} after step {step + 1}")


def test_adam_leaves_frozen_parameters_out():
    model = build_model("vmgn_tiny", num_classes=NUM_CLASSES)
    opt = init_optim("adam", model.parameters(), 1e-4)
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    assert id(model.global_bottleneck.bias) not in held
    assert len(held) == sum(p.requires_grad for p in model.parameters())
    # every name is ported now (tests/test_torch_optim.py); an unknown one raises
    with pytest.raises(KeyError):
        init_optim("lamb", model.parameters(), 1e-4)


@pytest.mark.parametrize("warmup", [False, True])
def test_schedules_match_jax_across_epoch_boundaries(warmup):
    spe = 7
    if warmup:
        ours = warmup_multistep_lr(1e-4, [3, 5], 0.1, warmup_factor=0.01, warmup_iters=2)
        theirs = jopt.warmup_multistep_lr(1e-4, [3, 5], 0.1, warmup_factor=0.01, warmup_iters=2)
    else:
        ours, theirs = multistep_lr(1e-4, [3, 5]), jopt.multistep_lr(1e-4, [3, 5])
    ours, theirs = per_step(ours, spe), jopt.per_step(theirs, spe)
    for step in range(0, 6 * spe + 1):
        assert ours(step) == theirs(step), step
