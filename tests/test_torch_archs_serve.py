"""Serving and checkpoints of the single-scale archs.

For gsta, ganet, res50tp, resnet50_s1, sta and simple_sta at depth
(1,1,1,1), 64x32, S=4 on the CPU: the exported eval artifact
(`export_eval_forward` -> `save_exported` -> `FeatureExtractor.
from_exported`) serves the live model's features, `FeatureExtractor`
takes no adjacency (all ones, as agrl_tpu's) and the archs that read none
give the same features with any; an agrl_tpu `.msgpack` of each arch
loads through `load_any_checkpoint` with every leaf matched and gives
agrl_tpu's eval features; an agrl_tpu gsta run resumes in the port
(`resume_agrl_tpu`, what `--resume x.msgpack` calls) with its optimizer
state copied exactly, and its next step follows agrl_tpu's.
"""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from agrl_torch.cli.train_vidreid_xent_htri import resume_agrl_tpu
from agrl_torch.core.checkpoint import load_any_checkpoint
from agrl_torch.core.flax_msgpack import read_checkpoint
from agrl_torch.engine.export import FeatureExtractor, export_eval_forward, save_exported
from agrl_torch.engine.trainer import make_train_step
from agrl_torch.models import default_num_vertices
from agrl_torch.models.weight_convert import (
    NO_COUNTERPART,
    _to_torch_layout,
    from_jax_variables,
    torch_name_map,
)
from agrl_torch.optim import init_optim
from agrl_tpu import optim as jopt
from agrl_tpu.core.checkpoint import save_checkpoint as jax_save_checkpoint
from agrl_tpu.engine.export import FeatureExtractor as JaxFeatureExtractor
from agrl_tpu.engine.train_state import create_train_state
from agrl_tpu.engine.trainer import make_train_step as jax_make_train_step
from agrl_tpu.models import backbone as jax_backbone
from agrl_tpu.models import layers as jax_layers
from agrl_tpu.models.gsta import GSTA as JGSTA
from agrl_tpu.models.weight_convert import convert_torch_state_dict, export_torch_state_dict
from tests.test_torch_archs import ARCHS, H, S, W, WIDTH, _bridged, jax_model, port_model
from tests.test_torch_resume import _batches
from tests.test_torch_train import _flat
from tests.test_torch_vmgn import _randomize

torch.set_num_threads(2)

N = 3  # clips per request: one full batch of 2 and a ragged one


def _clips(V=S * 7, seed=6):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (N, S, H, W, 3)).astype(np.uint8)
    adjs = ((rng.rand(N, V, V) > 0.5) + np.eye(V)).astype(np.float32)
    return imgs, adjs


@pytest.mark.parametrize("arch", ARCHS)
def test_artifact_serves_the_live_features(arch, tmp_path):
    _, _, model = _bridged(arch)
    # agrl_tpu's default_num_vertices: S * 7 for the graph archs, S for the others
    V = default_num_vertices(model, S)
    imgs, adjs = _clips(V)
    live = FeatureExtractor(model, batch_size=2, seq_len=S, bf16=False, device="cpu")
    want = live(imgs, adjs)
    assert want.shape == (N, WIDTH[arch])
    path = str(tmp_path / f"{arch}.pt2")
    save_exported(path, export_eval_forward(model, model.state_dict(), batch_size=2,
                                            seq_len=S, height=H, width=W, bf16=False,
                                            device="cpu"))
    fx = FeatureExtractor.from_exported(path, model.state_dict())
    assert fx.batch_size == 2 and fx.seq_len == S
    np.testing.assert_allclose(fx(imgs, adjs), want, atol=1e-5, rtol=1e-5)
    if arch not in ("gsta", "ganet"):  # no adjacency read: any one, or none, serves
        np.testing.assert_array_equal(live(imgs), want)
        np.testing.assert_array_equal(live(imgs, np.zeros_like(adjs)), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_msgpack_of_agrl_tpu_loads_every_leaf(arch, tmp_path):
    """An agrl_tpu checkpoint ({params, batch_stats}, its save_checkpoint)
    through --load-weights' loader: every entry matched, nothing skipped,
    and the eval features agrl_tpu computes from those variables."""
    _, variables, _ = _bridged(arch)
    fpath = str(tmp_path / f"{arch}.msgpack")
    jax_save_checkpoint(variables, fpath, epoch=0)
    model = port_model(arch, consistent_loss=arch in ("gsta", "ganet"))
    matched, skipped = load_any_checkpoint(model, fpath)
    assert not skipped and len(matched) == sum(
        len(dict(_flat(variables[c]))) for c in ("params", "batch_stats"))
    imgs, adjs = _clips()
    x = imgs.astype(np.float32) / 255.0
    want = np.asarray(jax_model(arch).apply(variables, jnp.asarray(x), jnp.asarray(adjs),
                                            train=False))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(adjs)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-4)


def test_resume_of_an_agrl_tpu_gsta_run(tmp_path):
    """agrl_tpu trains gsta (depth 1,1,1,1, one graph layer) two Adam steps
    and saves {params, batch_stats, opt_state}; the port's resume_agrl_tpu
    loads it (optax's count 2): weights, statistics and Adam's moments
    equal the checkpoint's; its next step on the third batch is within
    2e-4 of max per leaf of agrl_tpu's third step, where a fresh optimizer
    state misses by more than 10x. agrl_tpu's BN takes its two-pass
    variance, as in tests/test_torch_resume.py."""
    num_classes, lr = 8, 1e-4
    jmodel = JGSTA(num_classes=num_classes, layers=(1, 1, 1, 1), num_gb=1)
    lr_fn = jopt.per_step(jopt.multistep_lr(lr, [1], gamma=0.1), 4)
    tx = jopt.init_optim("adam", lr_fn, weight_decay=5e-4, base_lr=lr)
    state = create_train_state(jmodel, tx, jax.random.PRNGKey(0), seq_len=S, height=H, width=W)
    variables = _randomize({"params": jax.tree.map(np.asarray, state.params),
                            "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})
    state = state.replace(params=jax.tree.map(jnp.asarray, variables["params"]),
                          batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
    two_pass = partial(flax_nn.BatchNorm, momentum=0.9, epsilon=1e-5, use_fast_variance=False)
    shipped = jax_backbone.BatchNorm
    jax_backbone.BatchNorm = jax_layers.BatchNorm = two_pass
    fpath = str(tmp_path / "gsta.msgpack")
    try:
        step = jax_make_train_step(jmodel, tx, label_smooth=False, soft_margin=True,
                                   aug={"flip_aug": False}, donate=False)
        batches = _batches(num_classes)
        for i, (imgs, pids, adj) in enumerate(batches):
            if i == 2:  # the checkpoint after two steps
                jax_save_checkpoint({"params": state.params, "batch_stats": state.batch_stats,
                                     "opt_state": state.opt_state}, fpath, epoch=0)
            state, _ = step(state, jnp.asarray(imgs), jnp.asarray(pids), jnp.asarray(adj),
                            jax.random.PRNGKey(1))
    finally:
        jax_backbone.BatchNorm = jax_layers.BatchNorm = shipped

    from agrl_torch.models.gsta import GSTA

    def resumed():
        model = GSTA(num_classes=num_classes, layers=(1, 1, 1, 1), num_gb=1)
        optimizer = init_optim("adam", model.parameters(), lr, weight_decay=5e-4)
        return model, optimizer, resume_agrl_tpu(fpath, model, optimizer, "adam")

    try:
        model, optimizer, (meta, start) = resumed()
        fresh, _, _ = resumed()
        saved = read_checkpoint(fpath)[0]
    finally:
        for path in (fpath, fpath + ".json"):
            os.remove(path)
    assert start == 2 and meta["epoch"] == 0
    # the migration is a copy: weights, statistics and Adam's moments
    # equal the checkpoint's, leaf by leaf, in the port's layout
    adam = saved["opt_state"]["1"]["0"]  # optax: chain(weight decay, adam)
    mu, nu = adam["mu"], adam["nu"]
    for name, p in model.named_parameters():
        if p.requires_grad:
            path, _, kind = torch_name_map(name)
            for moment, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
                leaf = dict(_flat(tree))["/".join(path)]
                np.testing.assert_array_equal(optimizer.state[p][moment].numpy(),
                                              _to_torch_layout(leaf, kind), err_msg=name)
    for m in (model, fresh):
        make_train_step(m, optimizer if m is model else init_optim(
            "adam", m.parameters(), lr, weight_decay=5e-4), lambda s: lr, label_smooth=False,
            aug={"flip_aug": False}, start_step=start)(*batches[2])

    def leaf_errors(m):
        sd = {k: v for k, v in m.state_dict().items()
              if not k.endswith(("num_batches_tracked", "bottleneck.bias"))}
        got, errs = convert_torch_state_dict(sd)[0], {}
        for coll, tree in (("params", state.params), ("batch_stats", state.batch_stats)):
            want = dict(_flat(jax.tree.map(np.asarray, tree)))
            mine = dict(_flat(got[coll]))
            assert mine.keys() == want.keys()
            errs.update({f"{coll}/{k}": np.abs(mine[k] - w).max() / np.abs(w).max()
                         for k, w in want.items()})
        return errs

    errs, fresh_errs = leaf_errors(model), leaf_errors(fresh)
    worst = max(errs, key=errs.get)
    print("worst leaf", worst, errs[worst], "fresh state", max(fresh_errs.values()))
    # Adam's m / sqrt(v) magnifies the fp32 rounding of gradient entries
    # small against their history: layer4's conv2 and the graph Linear land
    # at ~1.2e-4 of max here, every other leaf under 2.1e-5; the same step
    # from a fresh optimizer state lands at ~4.6e-3, so the bar sees the
    # migration (checked exactly above)
    assert errs[worst] <= 2e-4, (worst, errs[worst])
    assert max(fresh_errs.values()) > 10 * errs[worst]


def test_bridged_weights_need_every_leaf():
    """from_jax_variables stays strict for the new archs: a missing PAM or
    fc1 leaf and a stray one raise."""
    for arch, leaf in (("ganet", "pam_layer"), ("sta", "fc1")):
        _, variables, _ = _bridged(arch)
        missing = {c: dict(variables[c]) for c in variables}
        del missing["params"][leaf]
        with pytest.raises(KeyError):
            from_jax_variables(missing, port_model(arch))
        extra = {c: dict(variables[c]) for c in variables}
        extra["params"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
        with pytest.raises(KeyError):
            from_jax_variables(extra, port_model(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_default_bf16_feature_extractor_matches_agrl_tpu(arch, monkeypatch):
    """Both serving APIs default to bf16 (weights, pixels and adjacency
    rounded); these tiny models follow their input (dtype None), so the
    trunk runs in bf16 in both packages: within 1e-2 of max, the bar of
    tests/test_torch_bf16_eval.py for VMGN's dtype None. A ragged 3-clip
    request at batch 2; the archs with no graph take no adjacency. gsta's
    pooled vertex features are float32 (the pooling matrix promotes them)
    and both graph layers take K1's entry; ganet's stripe means stay bf16,
    so its first layer takes K2's (`graph_propagate_v2`) and, its output
    being float32, the second K1's, as agrl_tpu's promotion goes.

    sta and simple_sta pick each part's best frame by an arg-max: on these
    random-weight inputs the two best frames' scores lie 1e-4 to 4e-3
    apart (relative), inside bf16's 3.9e-3 step, so bf16 rounding in
    either package may flip a pick. For them the bf16 features are only
    checked finite and of the arch's width (their fp32 features are held
    against agrl_tpu in tests/test_torch_archs.py)."""
    _, variables, tmodel = _bridged(arch)
    graph = arch in ("gsta", "ganet")
    imgs, adjs = _clips(S * 7 if graph else S, seed=8)
    adjs = adjs if graph else None
    import agrl_torch.models.layers as layers

    calls = {"graph_propagate": 0, "graph_propagate_v2": 0}
    for name in calls:
        def spy(*a, _name=name, _real=getattr(layers, name), **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(layers, name, spy)
    got = FeatureExtractor(tmodel, batch_size=2, seq_len=S, device="cpu")(imgs, adjs)
    assert got.shape == (N, WIDTH[arch]) and np.isfinite(got).all()
    forwards = -(-N // 2)
    want = {"gsta": (2 * forwards, 0), "ganet": (forwards, forwards)}.get(arch, (0, 0))
    assert (calls["graph_propagate"], calls["graph_propagate_v2"]) == want
    if arch in ("sta", "simple_sta"):
        return
    want = JaxFeatureExtractor(jax_model(arch), variables, batch_size=2, seq_len=S)(imgs, adjs)
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_named_state_dict_loads(arch, tmp_path):
    """A reference-named torch checkpoint of the arch (agrl_tpu's reverse
    export of the same variables, saved as {"state_dict": ...}) loads
    through load_any_checkpoint with nothing skipped, and gives the
    bridged model's eval features."""
    _, variables, tmodel = _bridged(arch)
    template = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    state, _, _ = export_torch_state_dict(variables, template, arch)
    path = str(tmp_path / f"{arch}.pth.tar")
    torch.save({"state_dict": {k: torch.tensor(np.asarray(v)) for k, v in state.items()}},
               path)
    model = port_model(arch, consistent_loss=arch in ("gsta", "ganet"))
    matched, skipped = load_any_checkpoint(model, path)
    assert not skipped and len(matched) == sum(
        not k.endswith(NO_COUNTERPART) for k in template)
    imgs, adjs = _clips()
    x, a = torch.from_numpy(imgs.astype(np.float32) / 255.0), torch.from_numpy(adjs)
    with torch.inference_mode():
        torch.testing.assert_close(model.eval()(x, a), tmodel(x, a), atol=0, rtol=0)


@pytest.mark.parametrize("arch", ["gsta", "sta"])
def test_imagenet_init_fills_the_single_layer4(arch):
    """--pretrained-weights: a torchvision ResNet-50 state dict (random
    values, torchvision names) fills the trunk and the one layer4; only
    the `fc` head is dropped."""
    from agrl_torch.models import build_model
    from agrl_torch.models.weight_convert import init_pretrained_weights
    from tests.test_imagenet_init import synth_resnet50_state_dict

    source = synth_resnet50_state_dict(np.random.RandomState(0))
    model = build_model(arch, num_classes=10)
    matched, skipped = init_pretrained_weights(model, {k: torch.as_tensor(v)
                                                       for k, v in source.items()})
    assert not skipped
    assert sum(k.startswith("layer4.") for k in matched) == sum(
        k.startswith("layer4.") and not k.endswith("num_batches_tracked") for k in source)
    np.testing.assert_array_equal(model.layer4[2].conv3.weight.detach().numpy(),
                                  source["layer4.2.conv3.weight"])
