"""Two data-parallel train steps at world 2 (gloo, two CPU processes) held
against agrl_tpu's single-device make_train_step on the global batch.

vmgn_tiny (depth 1,1,1,1) with the consistent loss (5 heads), 32x16
clips, S=5, a 4x2 P x K batch of 8 clips split 4 + 4 over the ranks,
flips on, SGD (momentum 0.9) at lr 1e-3 with weight decay 5e-4: its
update is linear in the gradient, where Adam's first updates are
lr * sign(g) and turn the fp32 noise of a near-zero gradient entry into a
2 lr step. agrl_tpu's weights (BN statistics and affine terms randomized)
are bridged into the port. The
flips are read off agrl_tpu's keys and handed to every rank as the global
batch's `flip`; the subclips are made known by replacing
`jax.random.permutation` while agrl_tpu's step traces (one trace: both
steps take the same subclips) and handed to the ranks as
`subclip_indices`. The port's own step without a process group on the
global batch is held beside it, and a step drawing its flips and erasures
from a seeded generator at world 2 is held against the same draws made
for the global batch without a group.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrl_torch.engine.trainer import make_train_step
from agrl_torch.models import build_model
from agrl_torch.models.weight_convert import from_jax_variables
from agrl_torch.optim import init_optim
from agrl_tpu.engine import make_train_step as jax_make_train_step
from agrl_tpu.engine.train_state import TrainState
from agrl_tpu.models import init_model as jax_init_model
from agrl_tpu.models import init_params
from agrl_tpu.models.weight_convert import convert_torch_state_dict
from agrl_tpu.optim import init_optim as jax_init_optim
from tests.test_torch_train import _flat
from tests.test_torch_vmgn import _randomize
from tests.torch_parallel_worker import spawn

torch.set_num_threads(2)

S, H, W, B, NUM_CLASSES, OPTIM, LR, SEED = 5, 32, 16, 8, 4, "sgd", 1e-3, 3
PERMS = [np.array(p) for p in ([3, 0, 4, 1, 2], [4, 2, 0, 1, 3], [1, 2, 3, 4, 0])]
SUBCLIPS = [np.sort(p[:n]) for p, n in zip(PERMS, (S - 3, S - 2, S - 1))]


def _flip_decisions(key):
    """agrl_tpu's per-clip flip draws from `key` (transforms.py:298-307)."""
    return np.array([bool(jax.random.uniform(jax.random.split(k, 4)[0]) < 0.5)
                     for k in jax.random.split(key, B)])


def _step_keys():
    """Two step keys whose flips (drawn from the step key's second half, as
    agrl_tpu's train_step splits it) hold both kinds of clip."""
    keys = (jax.random.PRNGKey(i) for i in itertools.count())
    good = (k for k in keys if 0 < _flip_decisions(jax.random.split(k)[1]).sum() < B)
    return [next(good), next(good)]


def _batches():
    rng = np.random.RandomState(5)
    out = []
    for _ in range(2):
        base = rng.randint(0, 256, (B, 1, 1, 1, 3))
        imgs = np.clip(base + rng.randint(-40, 41, (B, S, H, W, 3)), 0, 255).astype(np.uint8)
        pids = np.repeat(np.arange(B // 2), 2).astype(np.int32)
        V = S * 7
        adj = ((rng.rand(B, V, V) > 0.5) + np.eye(V)).astype(np.float32)
        out.append((imgs, pids, adj))
    return out


def _port_state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """agrl_tpu's two steps, the port's two steps without a group, and the
    two ranks' results."""
    jmodel = jax_init_model("vmgn_tiny", num_classes=NUM_CLASSES, consistent_loss=True)
    variables = init_params(jmodel, jax.random.PRNGKey(0), seq_len=S, height=H, width=W)
    variables = _randomize(jax.tree.map(np.asarray, dict(variables)), seed=1)
    batches = _batches()
    keys = _step_keys()
    flips = [_flip_decisions(jax.random.split(k)[1]) for k in keys]

    tx = jax_init_optim(OPTIM, LR, weight_decay=5e-4)
    state = TrainState(step=jnp.zeros([], jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    jstep = jax_make_train_step(jmodel, tx, label_smooth=False, soft_margin=True, donate=False,
                                aug={"flip_aug": True})
    perms = itertools.cycle(PERMS)
    real = jax.random.permutation
    jax.random.permutation = lambda key, n: jnp.asarray(next(perms))
    try:
        jax_history = []
        for (imgs, pids, adj), key in zip(batches, keys):
            state, m = jstep(state, imgs, pids, adj, key)
            jax_history.append({k: float(v) for k, v in m.items()})
    finally:
        jax.random.permutation = real

    model = build_model("vmgn_tiny", num_classes=NUM_CLASSES, consistent_loss=True)
    from_jax_variables(variables, model)
    init = _port_state(model)

    def port_run(aug, use_generator):
        m = build_model("vmgn_tiny", num_classes=NUM_CLASSES, consistent_loss=True)
        m.load_state_dict(init)
        opt = init_optim(OPTIM, m.parameters(), LR, weight_decay=5e-4)
        step = make_train_step(m, opt, lambda s: LR, label_smooth=False, aug=aug)
        if use_generator:
            imgs, pids, adj = batches[0]
            metrics = step(imgs, pids, adj, generator=torch.Generator().manual_seed(SEED))
            return [{k: float(v) for k, v in metrics.items()}], _port_state(m)
        history = []
        for (imgs, pids, adj), flip in zip(batches, flips):
            metrics = step(imgs, pids, adj, flip=flip, subclip_indices=SUBCLIPS)
            history.append({k: float(v) for k, v in metrics.items()})
        return history, _port_state(m)

    inputs = dict(num_classes=NUM_CLASSES, optim=OPTIM, lr=LR, seed=SEED, state=init,
                  steps=[(torch.from_numpy(i), torch.from_numpy(p), torch.from_numpy(a), f,
                          SUBCLIPS) for (i, p, a), f in zip(batches, flips)])
    ranks = spawn("train", inputs, tmp_path_factory.mktemp("train"))
    return dict(jax_history=jax_history, jax_params=dict(_flat(state.params)),
                jax_stats=dict(_flat(state.batch_stats)), init=init,
                port=port_run({"flip_aug": True}, False),
                port_generator=port_run({"flip_aug": True, "rand_erase": True}, True),
                ranks=ranks)


def _tree(state, collection):
    """The port state dict's parameters or running statistics, in agrl_tpu's
    layout and names."""
    keys = [k for k in state if ("running" in k) == (collection == "batch_stats")
            and "num_batches_tracked" not in k]
    return dict(_flat(convert_torch_state_dict({k: state[k] for k in keys})[0][collection]))


def test_ranks_hold_bit_equal_states(runs):
    """Both ranks end with the same parameters, running statistics and
    metrics, bit for bit: every rank takes the same averaged update."""
    a, b = runs["ranks"]
    assert a["state"].keys() == b["state"].keys()
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k
    assert a["history"] == b["history"]
    assert a["generator_metrics"] == b["generator_metrics"]
    for k in a["generator_state"]:
        assert torch.equal(a["generator_state"][k], b["generator_state"][k]), k


def test_losses_and_top1_match_agrl_tpu_global_batch(runs):
    """loss, xent, htri (rtol 1e-5: fp32 both ways, agrl_tpu's one-pass BN
    variance against the port's combined two-pass one) and top1 (exact
    counts over 8 clips: atol 1e-6) of both steps."""
    got = runs["ranks"][0]["history"]
    for g, want in zip(got, runs["jax_history"]):
        for k in ("loss", "xent_loss", "htri_loss"):
            np.testing.assert_allclose(g[k], want[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(g["top1"], want["top1"], atol=1e-6)


def _worst_update_err(got, want, init):
    """The worst leaf's ||got - want|| / ||want - init|| (Frobenius): the
    distance between two runs' parameters over the size of the update."""
    errs = {name: np.linalg.norm(got[name] - w) / max(np.linalg.norm(w - init[name]), 1e-12)
            for name, w in want.items()}
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


# The bar on the parameters after step 2: 2e-2 of each leaf's update
# (Frobenius). The conv kernels and BN terms ahead of a train-mode BN over
# 8 clips of 32x16 get gradients whose terms cancel, so fp32 gradients
# here are noisy: the port's own single-device step lies 7.3e-3 from
# agrl_tpu's at its worst leaf, the world-2 step 9.0e-3 from agrl_tpu's
# and 6.9e-3 from the port's single-device one. A gradient off by the
# world size is 1.0 off.
UPDATE_BAR = 2e-2
# The bar on the running statistics after step 2: 1e-4 of each leaf's
# largest entry. Step 2's statistics come from step 1's parameters, which
# differ as above; the worst leaves lie 3.7e-5 (agrl_tpu) and 2.1e-5 (the
# port without a group) off. A rank normalizing with its own 4 clips in
# place of the global 8 moves the losses themselves, held to rtol 1e-5.
STATS_BAR = 1e-4


def test_parameters_and_running_stats_match_agrl_tpu(runs):
    """After step 2: every parameter leaf within UPDATE_BAR of agrl_tpu's,
    relative to its update; every running statistic within STATS_BAR of
    the leaf's largest entry (flax's biased rule over the global batch)."""
    state = runs["ranks"][0]["state"]
    got = _tree(state, "params")
    assert got.keys() == runs["jax_params"].keys()
    worst, err = _worst_update_err(got, runs["jax_params"], _tree(runs["init"], "params"))
    assert err <= UPDATE_BAR, (worst, err)
    stats = _tree(state, "batch_stats")
    assert stats.keys() == runs["jax_stats"].keys()
    for name, want in runs["jax_stats"].items():
        assert np.abs(stats[name] - want).max() <= STATS_BAR * np.abs(want).max(), name


def test_world_two_matches_the_port_without_a_group(runs):
    """The same two steps without a process group on the global batch:
    losses within rtol 1e-5, parameters within UPDATE_BAR of their update,
    running statistics within STATS_BAR of max."""
    history, state = runs["port"]
    for g, want in zip(runs["ranks"][0]["history"], history):
        for k in ("loss", "xent_loss", "htri_loss", "top1"):
            np.testing.assert_allclose(g[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    worst, err = _worst_update_err(_tree(runs["ranks"][0]["state"], "params"),
                                   _tree(state, "params"), _tree(runs["init"], "params"))
    assert err <= UPDATE_BAR, (worst, err)
    got, want = _tree(runs["ranks"][0]["state"], "batch_stats"), _tree(state, "batch_stats")
    for name in want:
        assert np.abs(got[name] - want[name]).max() <= STATS_BAR * np.abs(want[name]).max(), name


def test_generator_draws_are_the_global_batch_draws(runs):
    """With flips and random erasing drawn from a seeded generator (and the
    subclips after them), the world-2 step equals the step without a group
    on the global batch from the same seed: every rank drew the global
    batch's draws and kept its slice. Losses rtol 1e-5, parameters within
    UPDATE_BAR of their update."""
    (want,), state = runs["port_generator"]
    got = runs["ranks"][0]["generator_metrics"]
    for k in ("loss", "xent_loss", "htri_loss", "top1"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    worst, err = _worst_update_err(_tree(runs["ranks"][0]["generator_state"], "params"),
                                   _tree(state, "params"), _tree(runs["init"], "params"))
    assert err <= UPDATE_BAR, (worst, err)

