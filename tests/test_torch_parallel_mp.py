"""Tensor parallelism (`--mesh-mp`) in gloo CPU processes, held against
agrl_tpu: its placement rule, its single-device step on the global batch,
its Evaluator, and its checkpoints.

vmgn_tiny (depth 1,1,1,1, full width) at the sizes of
tests/test_torch_parallel_train.py: 32x16 clips, S=5 with the consistent
loss (5 heads), a 4x2 P x K batch of 8, flips injected, SGD (momentum
0.9) at lr 1e-3 with weight decay 5e-4, agrl_tpu's weights randomized and
bridged. With `min_size=1024` (agrl_tpu's tests lower it the same way)
the mesh shards both graph linears (2048 x 2048) and both classifiers
(4 classes) over mp = 2; at the production `min_size` only the graph
linears shard (tested below per arch). Two meshes run: dp 1 x mp 2 (two
processes) and dp 2 x mp 2 (four: the only layout in which a collective
on the world group and one on the dp group give different results, since
at dp 1 the two mp ranks hold the same batch). The 2x2 CLI epoch runs
beside a one-process epoch of the same seed.
"""

import glob
import itertools
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from agrl_torch.core.checkpoint import save_checkpoint
from agrl_torch.core.flax_msgpack import read_checkpoint
from agrl_torch.core.optax_state import load_optax_state
from agrl_torch.engine.export import FeatureExtractor
from agrl_torch.engine.trainer import make_train_step
from agrl_torch.models import build_model
from agrl_torch.models.weight_convert import LSTM_GATES, from_jax_variables, torch_name_map
from agrl_torch.optim import OPTIMIZER_NAMES, init_optim
from agrl_torch.parallel import MIN_SHARD_SIZE, Mesh, param_shardings, place_state
from agrl_tpu.core.checkpoint import save_checkpoint as jax_save_checkpoint
from agrl_tpu.engine import make_train_step as jax_make_train_step
from agrl_tpu.engine.evaluator import Evaluator as JaxEvaluator
from agrl_tpu.engine.export import FeatureExtractor as JaxFeatureExtractor
from agrl_tpu.engine.train_state import TrainState
from agrl_tpu.models import init_model as jax_init_model
from agrl_tpu.models import init_params
from agrl_tpu.optim import init_optim as jax_init_optim
from agrl_tpu.parallel import make_mesh as jax_make_mesh
from agrl_tpu.parallel import param_shardings as jax_param_shardings
from tests.test_torch_parallel_eval import ALL_GALLERY, ALL_QUERY, CLIP_BATCH, _all, _evenly
from tests.test_torch_parallel_train import (
    B,
    H,
    LR,
    NUM_CLASSES,
    OPTIM,
    PERMS,
    S,
    STATS_BAR,
    SUBCLIPS,
    UPDATE_BAR,
    W,
    _batches,
    _flip_decisions,
    _port_state,
    _step_keys,
    _tree,
    _worst_update_err,
)
from tests.test_torch_parallel_cli import METER, RESULT
from tests.test_torch_train import _flat
from tests.test_torch_vmgn import _randomize
from tests.torch_parallel_worker import REPO, free_port, spawn

torch.set_num_threads(2)

MIN_SIZE = 1024
LAYOUTS = {"1x2": (2, 2), "2x2": (4, 2)}  # dp x mp -> (world, mp)
# The bars against agrl_tpu's step: the parameters after step 2 (of each
# leaf's update, Frobenius), the step-2 losses (rtol) and the step-2
# running statistics (of each leaf's largest entry). At dp 2 x mp 2
# tests/test_torch_parallel_train.py's (UPDATE_BAR, STATS_BAR; measured
# 9.0e-3, as its world-2 step). At dp 1 every data-parallel collective
# runs over one rank, and the global BatchNorm's arithmetic there (the
# data-parallel path's, with or without mp) puts the trunk's noisy leaves
# (the conv kernels and BN terms ahead of a train-mode BN) 4.0e-2 of
# their update from agrl_tpu's, where the step without a group lies
# 7.3e-3 off; its step-2 losses lie 4.2e-4 off and its step-2 statistics
# 7.0e-4 (the world-2 ones: 3.7e-5). So dp 1 x
# mp 2 is held to 5e-2, 1e-3 and 1.5e-3 against agrl_tpu, and to the dp 1
# x mp 1 group (one process, the same arithmetic but the sharded
# products) within MP_UPDATE_BAR (measured 2.4e-3), rtol 1e-6 and
# STATS_BAR.
BARS = {"2x2": (UPDATE_BAR, 1e-5, STATS_BAR), "1x2": (5e-2, 1e-3, 1.5e-3)}
MP_UPDATE_BAR = 1e-2
Q_IDS, G_IDS = [0, 1, 2, 3, 0], [0, 1, 2, 3, 0, 1, 4]


def _jax_mp_leaves(params, mp, min_size):
    """agrl_tpu's param_shardings(make_mesh(1, mp), params): the paths of its
    P(None, 'mp') leaves."""
    shardings = jax_param_shardings(jax_make_mesh(dp=1, mp=mp), params, min_size=min_size)
    return {"/".join(str(getattr(k, "key", k)) for k in path)
            for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]
            if s.spec == P(None, "mp")}


def _port_mp_leaves(plan, model):
    """The flax leaves of the port's placement, through the bridge's name
    map: one kernel a Linear weight, four gate kernels an LSTM weight."""
    out = set()
    for name in plan:
        path, _, kind = torch_name_map(name, model)
        if kind in ("lstm_ih", "lstm_hh"):
            side = "i" if kind == "lstm_ih" else "h"
            out |= {"/".join(path + (side + g, "kernel")) for g in LSTM_GATES}
        else:
            out.add("/".join(path))
    return out


def _mesh(mp, mp_index=0):
    """A process-group mesh of dp 1 for the placement rule alone (no
    collective runs in place_state)."""
    return Mesh(dp=1, dp_index=0, devices=(torch.device("cpu"),), dp_group=object(), mp=mp,
                mp_index=mp_index)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """agrl_tpu's two steps on the global batch (and its .msgpack of them),
    its Evaluator on the initial weights, the port without a group (two
    steps, a third, its no-mp checkpoint, the .msgpack resumed and
    stepped), and the ranks of both meshes."""
    tmp = tmp_path_factory.mktemp("mp")
    jmodel = jax_init_model("vmgn_tiny", num_classes=NUM_CLASSES, consistent_loss=True)
    variables = init_params(jmodel, jax.random.PRNGKey(0), seq_len=S, height=H, width=W)
    variables = _randomize(jax.tree.map(np.asarray, dict(variables)), seed=1)
    batches = _batches()
    flips = [_flip_decisions(jax.random.split(k)[1]) for k in _step_keys()]

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
        for (imgs, pids, adj), key in zip(batches, _step_keys()):
            state, m = jstep(state, imgs, pids, adj, key)
            jax_history.append({k: float(v) for k, v in m.items()})
    finally:
        jax.random.permutation = real
    msgpack = str(tmp / "agrl_tpu_ep1.msgpack")
    jax_save_checkpoint({"params": state.params, "batch_stats": state.batch_stats,
                         "opt_state": state.opt_state}, msgpack, epoch=1)

    loaders = {"evenly": (_evenly(Q_IDS, 0, np.random.RandomState(0)),
                          _evenly(G_IDS, 1, np.random.RandomState(1))),
               "all": (_all(ALL_QUERY, np.random.RandomState(2)),
                       _all(ALL_GALLERY, np.random.RandomState(3)))}
    jax_eval = {}
    for sample, (query, gallery) in loaders.items():
        ev = JaxEvaluator(jmodel, test_sample=sample, clip_batch=CLIP_BATCH)
        jax_eval[sample] = np.asarray(ev.extract(variables, query, "query")[0])

    model = build_model("vmgn_tiny", num_classes=NUM_CLASSES, consistent_loss=True)
    from_jax_variables(variables, model)
    init = _port_state(model)
    steps = [(torch.from_numpy(i), torch.from_numpy(p), torch.from_numpy(a), f, SUBCLIPS)
             for (i, p, a), f in zip(batches, flips)]
    nxt = steps[:1]  # the step after the checkpoint: batch 1 again

    def port_steps(m, opt, run, start=0):
        step = make_train_step(m, opt, lambda s: LR, label_smooth=False, aug={"flip_aug": True},
                               start_step=start)
        return [{k: float(v) for k, v in step(i, p, a, flip=f, subclip_indices=s).items()}
                for i, p, a, f, s in run]

    plain = build_model("vmgn_tiny", num_classes=NUM_CLASSES, consistent_loss=True)
    plain.load_state_dict(init)
    plain_opt = init_optim(OPTIM, plain.parameters(), LR, weight_decay=5e-4)
    port_history = port_steps(plain, plain_opt, steps)
    no_mp_ckpt = str(tmp / "no_mp.pth.tar")
    save_checkpoint(plain, plain_opt, no_mp_ckpt, 1, rank1=0.5, mAP=0.25)
    port_state = _port_state(plain)
    port_next = port_steps(plain, plain_opt, nxt, start=2)

    tree, _ = read_checkpoint(msgpack)
    resumed = build_model("vmgn_tiny", num_classes=NUM_CLASSES, consistent_loss=True)
    from_jax_variables({"params": tree["params"], "batch_stats": tree["batch_stats"]}, resumed)
    resumed_opt = init_optim(OPTIM, resumed.parameters(), LR, weight_decay=5e-4)
    count = load_optax_state(resumed_opt, resumed, tree["opt_state"], OPTIM)
    msgpack_next = port_steps(resumed, resumed_opt, nxt, start=count)

    # serving: 5 clips behind a batch of 4 (a ragged second chunk), through
    # agrl_tpu's FeatureExtractor and the port's on the whole weights
    rng = np.random.RandomState(9)
    fx_imgs = rng.randint(0, 256, (5, S, H, W, 3)).astype(np.uint8)
    fx_adjs = ((rng.rand(5, S * 7, S * 7) > 0.5) + np.eye(S * 7)).astype(np.float32)
    jax_fx = np.asarray(JaxFeatureExtractor(jmodel, variables, batch_size=4, seq_len=S,
                                            bf16=False)(fx_imgs, fx_adjs))
    whole = build_model("vmgn_tiny", num_classes=NUM_CLASSES, consistent_loss=True)
    whole.load_state_dict(init)
    port_fx = FeatureExtractor(whole, batch_size=4, seq_len=S, bf16=False,
                               device="cpu")(fx_imgs, fx_adjs)

    def inputs(parts):
        return dict(num_classes=NUM_CLASSES, optim=OPTIM, lr=LR, state=init, steps=steps,
                    next=nxt, min_size=MIN_SIZE, parts=parts, loaders=loaders,
                    clip_batch=CLIP_BATCH, ckpt=str(tmp / "mp.pth.tar"), msgpack=msgpack,
                    fx_imgs=fx_imgs, fx_adjs=fx_adjs, fx_batch=4)

    jobs = {"2x2": (4, 2, {"place", "eval", "ckpt"}), "1x2": (2, 2, set()), "1x1": (1, 1, set())}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {}
        for layout, (world, mp, parts) in jobs.items():
            (tmp / layout).mkdir()
            futures[layout] = pool.submit(spawn, "mp", inputs(parts), tmp / layout, world=world,
                                          mp=mp, timeout=400.0)
        ranks = {layout: f.result() for layout, f in futures.items()}
    return dict(jax_history=jax_history, jax_params=dict(_flat(state.params)),
                jax_stats=dict(_flat(state.batch_stats)), jax_variables=variables,
                jax_eval=jax_eval, jax_fx=jax_fx, port_fx=port_fx, init=init,
                port_history=port_history,
                port_state=port_state, port_next=port_next, no_mp_ckpt=no_mp_ckpt,
                msgpack_next=msgpack_next, msgpack_state=_port_state(resumed), ranks=ranks,
                tmp=tmp)


# --- the placement ------------------------------------------------------------

def test_placement_is_agrl_tpu_param_shardings(runs):
    """vmgn_tiny at min_size 1024: the sharded weights, under the bridge's
    name map, are agrl_tpu's P(None, 'mp') leaves (both graph linears and
    both classifiers); each rank of both meshes holds half of each weight's
    rows; Adam's sharded moments are twice the count of sharded weights,
    each of its block's shape."""
    want = _jax_mp_leaves(runs["jax_variables"]["params"], 2, MIN_SIZE)
    assert want == {"graph_layer_0/linear/kernel", "graph_layer_1/linear/kernel",
                    "global_classifier/kernel", "att_classifier/kernel"}
    model = build_model("vmgn_tiny", num_classes=NUM_CLASSES, consistent_loss=True)
    whole = dict(model.named_parameters())
    for layout in LAYOUTS:
        for r in runs["ranks"][layout]:
            assert _port_mp_leaves(r["plan"], model) == want, layout
    adam = runs["ranks"]["2x2"][0]["placed"]["adam"]
    moments = [k for shapes in adam["shapes"].values() for k, s in shapes.items() if len(s) == 2]
    assert len(moments) == 2 * len(want)
    for name, shape in adam["param_shapes"].items():
        rows, cols = whole[name].shape
        assert shape == (rows // 2, cols)
        assert adam["shapes"][name] == {"step": (), "exp_avg": shape, "exp_avg_sq": shape}


@pytest.mark.parametrize("optim", OPTIMIZER_NAMES)
def test_every_optimizer_places_its_state(runs, optim):
    """After one whole update on each rank alone, place_state hands the
    optimizer each sharded weight's block in the weight's place, and each
    state tensor of the weight's shape (moments, momentum buffers) becomes
    exactly its block; step counts stay."""
    for r in runs["ranks"]["2x2"]:
        placed = r["placed"][optim]
        assert placed["blocks_equal"] and placed["params_in_optimizer"]
        assert set(placed["plan"]) == set(r["plan"])
        for name, shapes in placed["shapes"].items():
            tensors = [s for s in shapes.values() if len(s) == 2]
            assert tensors and all(s == placed["param_shapes"][name] for s in tensors), name


ARCHS = {"vmgn": {}, "gsta": {}, "ganet": {}, "sta": {}, "res50tp": {}, "res50rnn": {},
         "resnet3d50": {}, "msppgn": {"num_split": 4}}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_placement_at_the_default_min_size(arch):
    """At agrl_tpu's default min_size (2048 * 256) on the full-width arch
    (625 classes, MARS's), mp 2 and mp 5: the port's sharded weights are
    agrl_tpu's P(None, 'mp') leaves (at mp 2 the 2048-wide outputs, at mp
    5 the classifiers; res50rnn's LSTM input kernels ii/if/ig/io at mp 2)."""
    kw = dict(num_classes=625, loss={"xent", "htri"}, **ARCHS[arch])
    jmodel = jax_init_model(arch, **kw)
    shapes = jax.eval_shape(lambda: init_params(jmodel, jax.random.PRNGKey(0), seq_len=4,
                                                height=256, width=128))
    with torch.device("meta"):  # the structure alone
        model = build_model(arch, **kw)
    for mp in (2, 5):
        want = _jax_mp_leaves(shapes["params"], mp, MIN_SHARD_SIZE)
        got = _port_mp_leaves(param_shardings(_mesh(mp), model), model)
        assert got == want, (mp, sorted(got ^ want))
    assert _port_mp_leaves(param_shardings(_mesh(1), model), model) == set()


def test_res50rnn_input_kernel_shards_per_gate():
    """res50rnn's packed weight_ih_l0 (4 x 512 rows of 2048) shards as
    agrl_tpu's four lstm/ii, if, ig, io kernels (2048, 512): each mp
    rank's block is, gate by gate, its column shard of that gate's leaf
    as jax.device_put places it on a (1, 2) mesh; weight_hh_l0 (512 x 512
    a gate) and the biases replicate."""
    jmodel = jax_init_model("res50rnn", num_classes=625, loss={"xent", "htri"})
    shapes = jax.eval_shape(lambda: init_params(jmodel, jax.random.PRNGKey(0), seq_len=4,
                                                height=256, width=128))
    rng = np.random.RandomState(0)
    lstm = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                        shapes["params"]["lstm"])
    mesh = jax_make_mesh(dp=1, mp=2)
    placed = jax.tree.map(jax.device_put, lstm,
                          jax_param_shardings(mesh, lstm, min_size=MIN_SHARD_SIZE))
    for m in range(2):
        model = build_model("res50rnn", num_classes=625, loss={"xent", "htri"})
        from_jax_variables({"params": {"lstm": lstm}}, model, partial=True)
        plan = place_state(_mesh(2, m), model)
        assert plan == {"lstm.weight_ih_l0": 4}
        block = model.lstm.weight_ih_l0.detach().numpy()
        assert block.shape == (4 * 256, 2048)
        for g, gate in enumerate(LSTM_GATES):
            leaf = placed["i" + gate]["kernel"]
            assert leaf.sharding.spec == P(None, "mp")
            (shard,) = [s for s in leaf.addressable_shards if s.device == mesh.devices[0, m]]
            np.testing.assert_array_equal(block[g * 256:(g + 1) * 256], np.asarray(shard.data).T)
            assert placed["h" + gate]["kernel"].sharding.spec == P()
        assert tuple(model.lstm.weight_hh_l0.shape) == (2048, 512)


def test_eval_forward_and_serving_refuse_blocks():
    """A graph layer holding a block of W refuses its eval forward before
    K1 (the mesh Evaluator and the FeatureExtractor gather W whole first;
    serving a placed model is test_mp_ranks_serve_the_whole_weights)."""
    model = build_model("vmgn_tiny", num_classes=NUM_CLASSES)
    place_state(_mesh(2), model, min_size=MIN_SIZE)
    model.eval()
    layer = model.graph_layers[0]
    assert tuple(layer.linear.weight.shape) == (1024, 2048)
    with pytest.raises(RuntimeError, match="whole W"):
        layer(torch.zeros(1, 7, 2048), torch.ones(1, 7, 7))


def test_mp_ranks_serve_the_whole_weights(runs):
    """A FeatureExtractor built on each rank's placed model at dp 2 x mp 2
    (both graph linears and both classifiers held as blocks) gathers the
    blocks whole at construction: five clips behind a batch of 4 give the
    whole-weights model's features (1e-6 of max: the ranks run one thread)
    and agrl_tpu's FeatureExtractor's on the same variables (the eval
    forward's bar, atol 5e-4, rtol 1e-4), the same on every rank; the
    model keeps its blocks. The extractor serves a snapshot of the weights
    without the trained model's gradients, which a later change of the
    model's weights does not reach."""
    for r in runs["ranks"]["2x2"]:
        got = r["eval"]["fx"]
        assert got.shape == runs["port_fx"].shape == runs["jax_fx"].shape
        assert np.abs(got - runs["port_fx"]).max() <= 1e-6 * np.abs(runs["port_fx"]).max()
        np.testing.assert_allclose(got, runs["jax_fx"], atol=5e-4, rtol=1e-4)
        np.testing.assert_array_equal(got, runs["ranks"]["2x2"][0]["eval"]["fx"])
        assert r["eval"]["fx_blocks_kept"]
        assert r["eval"]["fx_model_has_grads"] and not r["eval"]["fx_snapshot_has_grads"]
        np.testing.assert_array_equal(r["eval"]["fx_after_model_change"], got)


# --- two train steps ---------------------------------------------------------

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mp_steps_match_agrl_tpu_global_batch(runs, layout):
    """Step 1's loss, xent and htri within rtol 1e-5 of agrl_tpu's
    single-device step on the global batch, step 2's within the layout's
    BARS (top1 atol 1e-6); after step 2 every parameter leaf, the shards
    gathered whole, within the layout's BARS of agrl_tpu's relative to its
    update (a missing input all-reduce leaves the trunk a partial
    gradient, a divide by the world in place of dp halves every update:
    1.0 off) and every running statistic within STATS_BAR of its leaf's
    largest entry (the layout's BARS); the parameters the same against the
    port's own step without a group."""
    update_bar, loss_rtol, stats_bar = BARS[layout]
    r0 = runs["ranks"][layout][0]
    for i, (got, want) in enumerate(zip(r0["history"], runs["jax_history"])):
        for k in ("loss", "xent_loss", "htri_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5 if i == 0 else loss_rtol,
                                       err_msg=k)
        np.testing.assert_allclose(got["top1"], want["top1"], atol=1e-6)
    state, init = r0["state"], _tree(runs["init"], "params")
    got = _tree(state, "params")
    assert got.keys() == runs["jax_params"].keys()
    worst, err = _worst_update_err(got, runs["jax_params"], init)
    assert err <= update_bar, (worst, err)
    worst, err = _worst_update_err(got, _tree(runs["port_state"], "params"), init)
    assert err <= update_bar, (worst, err)
    stats = _tree(state, "batch_stats")
    for name, want in runs["jax_stats"].items():
        assert np.abs(stats[name] - want).max() <= stats_bar * np.abs(want).max(), name


def test_dp_one_mp_two_is_the_dp_one_step(runs):
    """dp 1 x mp 2 against the dp 1 x mp 1 group (the same data-parallel
    arithmetic in one process): both steps' metrics within rtol 1e-6, the
    parameters after step 2 within MP_UPDATE_BAR of their update and the
    running statistics within STATS_BAR of each leaf's largest entry, so
    the sharded products alone move the 1 x 2 run."""
    (one,), r0 = runs["ranks"]["1x1"], runs["ranks"]["1x2"][0]
    assert one["plan"] == {}
    for got, want in zip(r0["history"], one["history"]):
        for k in ("loss", "xent_loss", "htri_loss", "top1"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    init = _tree(runs["init"], "params")
    worst, err = _worst_update_err(_tree(r0["state"], "params"), _tree(one["state"], "params"),
                                   init)
    assert err <= MP_UPDATE_BAR, (worst, err)
    got, want = _tree(r0["state"], "batch_stats"), _tree(one["state"], "batch_stats")
    for name in want:
        assert np.abs(got[name] - want[name]).max() <= STATS_BAR * np.abs(want[name]).max(), name


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_replicated_parameters_equal_across_each_mp_group(runs, layout):
    """After two steps the ranks of each mp group hold every replicated
    parameter and buffer bit for bit alike (every op after a sharded
    Linear's gather runs alike, its input's gradient is summed over the
    group, and the replicated gradients are averaged over every rank),
    each a different block of each sharded weight, and every rank prints
    the same metrics."""
    world, mp = LAYOUTS[layout]
    ranks = runs["ranks"][layout]
    sharded = set(ranks[0]["plan"])
    for d in range(world // mp):
        group = ranks[d * mp:(d + 1) * mp]
        a, b = group[0]["digests"], group[1]["digests"]
        assert a.keys() == b.keys()
        for k in a:
            assert (a[k] != b[k]) if k in sharded else (a[k] == b[k]), k
    assert all(r["history"] == ranks[0]["history"] for r in ranks)
    assert [r["mesh"] for r in ranks] == [(world // mp, mp, i // mp, i % mp)
                                         for i in range(world)]


# --- the mp Evaluator ---------------------------------------------------------

@pytest.mark.parametrize("sample", ["evenly", "all"])
def test_mp_evaluator_matches_agrl_tpu(runs, sample):
    """The Evaluator at dp 2 x mp 2 on the placed initial weights (the
    shards gathered whole, the batches split over dp): query features
    within atol 5e-4, rtol 1e-4 of agrl_tpu's Evaluator (the eval
    forward's bar), the same on every rank with the same rank-1 and mAP,
    and each placed block back in place afterwards."""
    ranks = runs["ranks"]["2x2"]
    want = runs["jax_eval"][sample]
    for r in ranks:
        got = r["eval"][sample]
        assert got["qf"].shape == want.shape
        np.testing.assert_allclose(got["qf"].numpy(), want, atol=5e-4, rtol=1e-4)
        assert torch.equal(got["qf"], ranks[0]["eval"][sample]["qf"])
        assert (got["rank1"], got["mAP"]) == (ranks[0]["eval"][sample]["rank1"],
                                              ranks[0]["eval"][sample]["mAP"])
        assert r["eval"]["blocks_restored"]


# --- checkpoints ----------------------------------------------------------------

def _layout(ckpt):
    sd, opt = ckpt["state_dict"], ckpt["optimizer"]
    return ([(k, tuple(v.shape), v.dtype) for k, v in sd.items()], opt["param_groups"],
            {i: {k: (tuple(v.shape), v.dtype) if torch.is_tensor(v) else v
                 for k, v in st.items()} for i, st in opt["state"].items()},
            sorted(ckpt))


def test_gathered_checkpoint_is_a_no_mp_checkpoint(runs):
    """The file rank 0 wrote at dp 2 x mp 2 after two steps (every rank
    joined the gather) holds the names, shapes, dtypes, optimizer groups
    and state layout of the port's save without a group, in the same
    order, with its values (each leaf within UPDATE_BAR of its update; the
    momentum buffers, SGD's update over lr, within UPDATE_BAR of
    themselves, Frobenius: measured 1.1e-2); the async
    writer's file holds the same tensors bit for bit."""
    sync = torch.load(str(runs["tmp"] / "mp.pth.tar"), weights_only=True)
    asyn = torch.load(str(runs["tmp"] / "mp_async.pth.tar"), weights_only=True)
    plain = torch.load(runs["no_mp_ckpt"], weights_only=True)
    assert _layout(sync) == _layout(plain) == _layout(asyn)
    assert (sync["epoch"], sync["rank1"], sync["mAP"]) == (1, 0.5, 0.25)
    for k, v in sync["state_dict"].items():
        assert torch.equal(v, asyn["state_dict"][k]), k
    for i, st in sync["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, asyn["optimizer"]["state"][i][k])
            want = plain["optimizer"]["state"][i][k]
            assert (v - want).norm() <= UPDATE_BAR * want.norm(), (i, k)
    init = _tree(runs["init"], "params")
    worst, err = _worst_update_err(_tree(sync["state_dict"], "params"),
                                   _tree(plain["state_dict"], "params"), init)
    assert err <= UPDATE_BAR, (worst, err)


def test_resumed_checkpoint_takes_the_next_step(runs):
    """The gathered checkpoint loaded whole and placed anew at dp 2 x mp 2
    takes the next step of the live placed model bit for bit (metrics and
    every rank's parameters and buffers), and that step's losses are the
    port's unsharded third step's within rtol 1e-3 (the two runs'
    parameters already lie their fp32 noise apart, UPDATE_BAR above:
    measured 5.4e-4)."""
    for r in runs["ranks"]["2x2"]:
        assert r["meta"] == {"epoch": 1, "rank1": 0.5, "mAP": 0.25}
        assert r["next_resumed"] == r["next_live"]
        live, resumed = r["next_digests"]
        assert live == resumed
    got, want = runs["ranks"]["2x2"][0]["next_live"][0], runs["port_next"][0]
    for k in ("loss", "xent_loss", "htri_loss", "top1"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-7, err_msg=k)


def test_agrl_tpu_msgpack_resumes_under_mp(runs):
    """agrl_tpu's .msgpack of its two steps (params, batch_stats, its SGD
    optax state) resumed at dp 2 x mp 2, placed after the whole state
    loads: the next step's losses within rtol 1e-5 of the unsharded
    resume's, its parameters (gathered) within UPDATE_BAR of that resume's
    update."""
    r0 = runs["ranks"]["2x2"][0]
    for k in ("loss", "xent_loss", "htri_loss", "top1"):
        np.testing.assert_allclose(r0["msgpack_next"][0][k], runs["msgpack_next"][0][k],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    worst, err = _worst_update_err(_tree(r0["msgpack_state"], "params"),
                                   _tree(runs["msgpack_state"], "params"),
                                   _tree(runs["port_state"], "params"))
    assert err <= UPDATE_BAR, (worst, err)


# --- the CLI --------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """One epoch of vmgn_tiny on the synthetic set as four processes with
    --mesh-mp 2 (dp 2 x mp 2, --async-ckpt) and as one process."""
    root = tmp_path_factory.mktemp("mpcli")
    data = str(root / "data")
    from agrl_torch.data.datasets import init_vidreid_dataset

    init_vidreid_dataset(root=data, name="synthetic")  # written once, before the ranks read it
    base = [sys.executable, "-m", "agrl_torch.cli.train_vidreid_xent_htri", "--use-cpu",
            "--root", data, "-d", "synthetic", "-a", "vmgn_tiny", "--height", "32",
            "--width", "16", "--seq-len", "4", "--train-batch", "4", "--num-instances", "2",
            "--train-sampler", "RandomIdentitySamplerV1", "--test-sample", "evenly",
            "--test-batch", "3", "--num-split", "4", "--pyramid-part", "--use-pose",
            "--learn-graph", "--num-gb", "1", "--flip-aug", "--soft-margin", "--optim", "sgd",
            "--lr", "1e-3", "--max-epoch", "1", "--eval-step", "1", "--print-freq", "1",
            "-j", "1", "--seed", "1"]
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(var, None)
    jobs = {
        f"rank{r}": base + ["--save-dir", str(root / f"rank{r}"), "--mesh-mp", "2",
                            "--async-ckpt", "--dist-coordinator", f"127.0.0.1:{port}",
                            "--dist-num-processes", "4", "--dist-process-id", str(r)]
        for r in range(4)
    }
    jobs["single"] = base + ["--save-dir", str(root / "single")]
    procs = {k: subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, argv in jobs.items()}
    try:
        outs = {k: p.communicate(timeout=400)[0] for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, p in procs.items():
        assert p.returncode == 0, (k, outs[k][-3000:])
    return root, outs


def test_cli_mesh_mp_epoch_matches_one_process(cli_runs):
    """Every rank prints "Mesh: dp=2 mp=2", the graph linear sharded, and
    the same meters and result block; each step's Xent, Htri and Top1
    within 2e-3 of the one-process epoch's (the bar of the 2-process epoch
    in tests/test_torch_parallel_cli.py), the same Rank-1 and mAP; rank
    0's checkpoint has the
    one-process checkpoint's layout, and no other rank writes one."""
    root, outs = cli_runs
    meters = {k: [m.groups() for m in METER.finditer(out)] for k, out in outs.items()}
    for r in range(4):
        out = outs[f"rank{r}"]
        assert f"Mesh: dp=2 mp=2 (process {r} of 4, gloo)" in out
        assert "Sharded over mp=2: 1 weight(s) (graph_layers.0.linear.weight)" in out
        assert meters[f"rank{r}"] == meters["rank0"]
        assert RESULT.findall(out) == RESULT.findall(outs["rank0"])
    assert len(meters["rank0"]) == len(meters["single"]) == 4
    for a, b in zip(meters["rank0"], meters["single"]):
        np.testing.assert_allclose([float(v) for v in a[2:]], [float(v) for v in b[2:]],
                                   atol=2e-3)
    assert RESULT.findall(outs["rank0"]) == RESULT.findall(outs["single"])
    mp_ckpt = torch.load(str(root / "rank0" / "checkpoint_ep1.pth.tar"), weights_only=True)
    one = torch.load(str(root / "single" / "checkpoint_ep1.pth.tar"), weights_only=True)
    assert _layout(mp_ckpt) == _layout(one)
    for r in range(1, 4):
        assert not glob.glob(str(root / f"rank{r}" / "*.pth.tar"))
        (log,) = os.listdir(root / f"rank{r}")
        assert re.fullmatch(rf"log_train-[-\d]+-proc{r}\.txt", log), log
