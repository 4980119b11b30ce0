"""Resuming an agrl_tpu run in the port (`--resume x.msgpack`).

agrl_tpu's train step (vmgn_tiny at the CLI's synthetic config) takes two
steps under each optimizer and writes its checkpoint with
`save_checkpoint` ({params, batch_stats, opt_state} + the .json sidecar).
The port's CLI resumes it with `--resume`: weights, batch statistics,
the optimizer state migrated from optax's layout, and the schedule at
optax's count. Its first step (on the test's batch, in place of the
loader's) must equal agrl_tpu's third step on that batch: every
parameter and running statistic within 1e-5 of its leaf's largest entry.
The same step from a fresh optimizer state misses that bar by far, so the
bar sees the migration. agrl_tpu's BN takes its two-pass variance here,
as in tests/test_torch_train.py (its shipped one-pass variance puts its
fp32 gradients 6e-2 from float64 at this size).
"""

import copy
import io
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from agrl_torch.cli import train_vidreid_xent_htri as tcli
from agrl_torch.core.flax_msgpack import read_checkpoint
from agrl_torch.core.optax_state import load_optax_state
from agrl_torch.engine.trainer import make_train_step as port_make_train_step
from agrl_torch.models import build_model
from agrl_torch.optim import init_optim
from agrl_tpu import optim as jopt
from agrl_tpu.core.checkpoint import save_checkpoint as jax_save_checkpoint
from agrl_tpu.data.datasets import init_vidreid_dataset as jax_dataset
from agrl_tpu.engine.train_state import create_train_state
from agrl_tpu.engine.trainer import make_train_step as jax_make_train_step
from agrl_tpu.models import backbone as jax_backbone
from agrl_tpu.models import init_model as jax_init_model
from agrl_tpu.models import layers as jax_layers
from agrl_tpu.models.weight_convert import convert_torch_state_dict
from tests.test_torch_vmgn import _randomize

torch.set_num_threads(2)

S, H, W, B, SPE = 4, 64, 32, 4, 4  # the CLI's synthetic config: 4 steps an epoch
LR = 1e-4


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume")
    ds = jax_dataset("synthetic", root=str(root / "data"), verbose=False)
    return root, ds.num_train_pids


def _batches(num_classes, n=3):
    rng = np.random.RandomState(11)
    out = []
    for _ in range(n):
        base = rng.randint(0, 256, (B, 1, 1, 1, 3))
        imgs = np.clip(base + rng.randint(-40, 41, (B, S, H, W, 3)), 0, 255).astype(np.uint8)
        pids = rng.choice(num_classes, 2, replace=False).repeat(2).astype(np.int32)
        V = S * 7
        adj = ((rng.rand(B, V, V) > 0.5) + np.eye(V)).astype(np.float32)
        out.append((imgs, pids, adj))
    return out


def _jax_run(optim, num_classes, fpath):
    """agrl_tpu: two steps, its checkpoint at epoch 0, then the third step.
    Returns the state after the third step."""
    jmodel = jax_init_model("vmgn_tiny", num_classes=num_classes, num_gb=1)
    lr_fn = jopt.per_step(jopt.multistep_lr(LR, [1], gamma=0.1), SPE)
    tx = jopt.init_optim(optim, lr_fn, weight_decay=5e-4, base_lr=LR)
    state = create_train_state(jmodel, tx, jax.random.PRNGKey(0), seq_len=S, height=H,
                               width=W)
    variables = _randomize({"params": jax.tree.map(np.asarray, state.params),
                            "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})
    state = state.replace(params=jax.tree.map(jnp.asarray, variables["params"]),
                          batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
    two_pass = partial(flax_nn.BatchNorm, momentum=0.9, epsilon=1e-5, use_fast_variance=False)
    shipped = jax_backbone.BatchNorm
    jax_backbone.BatchNorm = jax_layers.BatchNorm = two_pass
    try:
        step = jax_make_train_step(jmodel, tx, label_smooth=False, soft_margin=True,
                                   aug={"flip_aug": False}, donate=False)
        batches = _batches(num_classes)
        for imgs, pids, adj in batches[:2]:
            state, _ = step(state, jnp.asarray(imgs), jnp.asarray(pids), jnp.asarray(adj),
                            jax.random.PRNGKey(1))
        jax_save_checkpoint({"params": state.params, "batch_stats": state.batch_stats,
                             "opt_state": state.opt_state}, fpath, epoch=0, rank1=0.25,
                            mAP=0.5)
        imgs, pids, adj = batches[2]
        state, _ = step(state, jnp.asarray(imgs), jnp.asarray(pids), jnp.asarray(adj),
                        jax.random.PRNGKey(1))
    finally:
        jax_backbone.BatchNorm = jax_layers.BatchNorm = shipped
    return state, batches[2]


class _Stop(Exception):
    pass


def _port_resumed_step(root, optim, fpath, batch, monkeypatch):
    """The port's CLI with --resume fpath: its first train step runs on
    `batch`, then the run stops. Returns (model after the step, the model
    before it, the CLI's output, the step's start_step)."""
    from agrl_torch.engine import trainer

    seen, real = {}, trainer.make_train_step

    def recording_make(model, optimizer, lr_fn, **kw):
        step = real(model, optimizer, lr_fn, **kw)
        seen["start_step"] = kw["start_step"]

        def first(*args, **kwargs):
            seen["before"] = copy.deepcopy(model)
            step(*batch)
            seen["after"] = model
            raise _Stop

        return first

    monkeypatch.setattr(trainer, "make_train_step", recording_make)
    argv = ["--use-cpu", "--root", str(root / "data"), "-d", "synthetic", "-a", "vmgn_tiny",
            "--height", str(H), "--width", str(W), "--seq-len", str(S), "--train-batch", str(B),
            "--num-instances", "2", "--train-sampler", "RandomIdentitySamplerV1",
            "--test-sample", "evenly", "--num-split", "4", "--pyramid-part", "--use-pose",
            "--learn-graph", "--num-gb", "1", "--soft-margin", "--lr", str(LR),
            "--stepsize", "1", "--optim", optim, "--max-epoch", "2", "-j", "1",
            "--save-dir", str(root / f"log_{optim}"), "--resume", fpath]
    buf, stdout = io.StringIO(), sys.stdout
    sys.stdout = buf
    try:
        with pytest.raises(_Stop):
            tcli.main(argv)
    finally:
        sys.stdout = stdout
    return seen["after"], seen["before"], buf.getvalue(), seen["start_step"]


def _leaf_errors(model, state):
    """Per flax leaf of params and batch_stats: max|port - agrl_tpu| over
    the leaf's largest |agrl_tpu| entry."""
    sd = {k: v for k, v in model.state_dict().items()
          if not k.endswith(("num_batches_tracked", "bottleneck.bias"))}
    got = convert_torch_state_dict(sd)[0]
    errs = {}
    for coll, tree in (("params", state.params), ("batch_stats", state.batch_stats)):
        want = dict(_flat(jax.tree.map(np.asarray, tree)))
        mine = dict(_flat(got[coll]))
        assert mine.keys() == want.keys()
        for k, w in want.items():
            errs[f"{coll}/{k}"] = float(np.abs(mine[k] - w).max() / np.abs(w).max())
    return errs


@pytest.mark.parametrize("optim", ["adam", "sgd", "radam"])
def test_resumed_step_equals_agrl_tpus_third(optim, data_root, monkeypatch):
    root, num_classes = data_root
    fpath = str(root / f"checkpoint_{optim}.msgpack")
    state3, batch = _jax_run(optim, num_classes, fpath)
    try:
        after, before, out, start_step = _port_resumed_step(root, optim, fpath, batch,
                                                            monkeypatch)
    finally:
        for path in (fpath, fpath + ".json"):  # ~100 MB of weights and moments
            os.remove(path)
    assert start_step == 2  # optax's count, not (epoch + 1) * steps_per_epoch
    assert f"Resumed agrl_tpu's {optim} state at step 2" in out
    assert "- start_epoch: 1" in out and "- rank1: 0.25" in out
    errs = _leaf_errors(after, state3)
    worst = max(errs, key=errs.get)
    print(optim, "worst leaf", worst, errs[worst])
    assert errs[worst] <= 1e-5, (worst, errs[worst])

    # the same step from a fresh optimizer state is far outside the bar
    fresh = copy.deepcopy(before)
    step = port_make_train_step(fresh, init_optim(optim, fresh.parameters(), LR, weight_decay=5e-4),
                           lambda s: LR, label_smooth=False, aug={"flip_aug": False},
                           start_step=2)
    step(*batch)
    fresh_err = max(_leaf_errors(fresh, state3).values())
    print(optim, "fresh state", fresh_err)
    assert fresh_err > 10 * max(errs.values())


@pytest.fixture(scope="module")
def tiny_variables():
    """agrl_tpu's vmgn_tiny variables (one graph layer, 4 classes)."""
    from agrl_tpu.models import init_params

    jmodel = jax_init_model("vmgn_tiny", num_classes=4, num_gb=1)
    variables = init_params(jmodel, jax.random.PRNGKey(0), seq_len=S, height=H, width=W)
    return {c: jax.tree.map(jnp.asarray, variables[c]) for c in ("params", "batch_stats")}


def _checkpoint(tmp_path, variables, opt_state):
    """The tree agrl_tpu's save_checkpoint writes, read back by the port's
    reader (the file is removed once read)."""
    fpath = str(tmp_path / "ckpt.msgpack")
    jax_save_checkpoint({**variables, "opt_state": opt_state}, fpath, epoch=0)
    tree = read_checkpoint(fpath)[0]
    os.remove(fpath)
    return tree


@pytest.mark.parametrize("optim", ["amsgrad", "nesterov", "rmsprop", "adabound"])
def test_migration_fills_every_port_state(optim, tiny_variables, tmp_path):
    """The other names' layouts, from agrl_tpu's opt_state after one step
    of its optimizer: every trainable parameter takes its moments in the
    port's layout, equal to the port's own state after the same step on
    the same parameters and gradients."""
    from agrl_torch.models.weight_convert import (
        _to_torch_layout,
        from_jax_variables,
        torch_name_map,
    )

    params = tiny_variables["params"]
    tx = jopt.init_optim(optim, lambda s: LR, weight_decay=5e-4, base_lr=LR)
    rng = np.random.RandomState(2)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32) * 1e-2),
                         params)
    _, opt_state = tx.update(grads, tx.init(params), params)
    tree = _checkpoint(tmp_path, tiny_variables, opt_state)

    model = build_model("vmgn_tiny", num_classes=4, num_gb=1)
    from_jax_variables({"params": tree["params"], "batch_stats": tree["batch_stats"]}, model)
    twin = copy.deepcopy(model)
    mine = init_optim(optim, model.parameters(), LR, weight_decay=5e-4)
    assert load_optax_state(mine, model, tree["opt_state"], optim) == 1

    # the port's own step from the same parameters and gradients
    own = init_optim(optim, twin.parameters(), LR, weight_decay=5e-4)
    flat_g = dict(_flat(jax.tree.map(np.asarray, grads)))
    for n, p in twin.named_parameters():
        if p.requires_grad:
            path, _, kind = torch_name_map(n)
            p.grad = torch.from_numpy(_to_torch_layout(flat_g["/".join(path)], kind).copy())
    own.step()
    assert len(mine.state) == len(own.state) == sum(p.requires_grad for p in model.parameters())
    by_name = dict(model.named_parameters())
    for n, p in twin.named_parameters():
        if p.requires_grad:
            got, want = mine.state[by_name[n]], own.state[p]
            assert got.keys() == want.keys(), (n, got.keys(), want.keys())
            for k, v in want.items():
                g = torch.as_tensor(got[k], dtype=torch.float32)
                assert torch.allclose(g, torch.as_tensor(v, dtype=torch.float32), rtol=1e-5,
                                      atol=1e-9), (n, k)


def test_migration_refuses_another_optimizers_state(tiny_variables, tmp_path):
    tx = jopt.init_optim("sgd", lambda s: LR, base_lr=LR)
    tree = _checkpoint(tmp_path, tiny_variables, tx.init(tiny_variables["params"]))
    model = build_model("vmgn_tiny", num_classes=4, num_gb=1)
    with pytest.raises(ValueError, match="layout"):
        load_optax_state(init_optim("adam", model.parameters(), LR), model, tree["opt_state"],
                         "adam")
