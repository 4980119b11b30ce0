"""The port's checkpoint IO held against agrl_tpu's, both ways, at
vmgn_tiny: its own torch checkpoints (round trip, best_model), the
msgpack reader against flax's, an agrl_tpu checkpoint evaluated by the
port's CLI against agrl_tpu's Evaluator, the port's .pth.tar read by
agrl_tpu, shape-filtered loads with another class count, and the
ImageNet backbone init."""

import copy
import os.path as osp

import jax
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

from agrl_torch.cli import train_vidreid_xent_htri as tcli
from agrl_torch.core import (
    load_any_checkpoint,
    load_checkpoint,
    load_weights_partial,
    save_checkpoint,
)
from agrl_torch.core import flax_msgpack
from agrl_torch.models import build_model
from agrl_torch.models.weight_convert import from_jax_variables, init_pretrained_weights
from agrl_torch.optim import init_optim
from agrl_torch.utils.model_complexity import count_num_param
from agrl_tpu import optim as jopt
from agrl_tpu.core import load_weights_partial as jax_load_weights_partial
from agrl_tpu.core import save_checkpoint as jax_save_checkpoint
from agrl_tpu.data.datasets import init_vidreid_dataset as jax_dataset
from agrl_tpu.data.loader import ClipLoader as JaxClipLoader
from agrl_tpu.data.loader import VideoClipDataset as JaxClipDataset
from agrl_tpu.engine.evaluator import Evaluator as JaxEvaluator
from agrl_tpu.models import init_model as jax_init_model
from agrl_tpu.models import init_params, load_any_checkpoint as jax_load_any_checkpoint
from agrl_tpu.models.weight_convert import init_pretrained_weights as jax_init_pretrained
from agrl_tpu.utils.model_complexity import count_num_param as jax_count_num_param
from tests.test_imagenet_init import synth_resnet50_state_dict
from tests.test_torch_cli import _run_cli

torch.set_num_threads(2)

H, W, S, NUM_CLASSES = 64, 32, 4, 8  # the synthetic catalog's default 8 identities


@pytest.fixture(scope="module")
def jax_vmgn():
    """agrl_tpu vmgn_tiny variables (numpy) with spread BN statistics, and
    its model."""
    model = jax_init_model("vmgn_tiny", num_classes=NUM_CLASSES)
    variables = jax.tree.map(np.asarray, dict(init_params(
        model, jax.random.PRNGKey(3), seq_len=S, height=H, width=W)))
    rng = np.random.RandomState(0)
    stats = traverse_util.flatten_dict(variables["batch_stats"])
    for path, v in stats.items():
        stats[path] = (rng.rand(*v.shape) + 0.5 if path[-1] == "var"
                       else rng.randn(*v.shape) * 0.1).astype(np.float32)
    variables["batch_stats"] = traverse_util.unflatten_dict(stats)
    return model, variables


def _port_from(variables, num_classes=NUM_CLASSES):
    model = build_model("vmgn_tiny", num_classes=num_classes)
    from_jax_variables(variables, model)
    return model


def _assert_state_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("is_best", [True, False])
def test_save_load_round_trip_bit_equal(tmp_path, is_best):
    model = build_model("vmgn_tiny", num_classes=5)
    model.init_weights(torch.Generator().manual_seed(0))
    opt = init_optim("adam", model.parameters(), 1e-3, weight_decay=5e-4)
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    fpath = str(tmp_path / "checkpoint_ep3.pth.tar")
    save_checkpoint(model, opt, fpath, epoch=2, rank1=0.75, mAP=0.5, is_best=is_best)
    assert osp.exists(tmp_path / "best_model.pth.tar") == is_best

    fresh = build_model("vmgn_tiny", num_classes=5)
    fresh_opt = init_optim("adam", fresh.parameters(), 1e-3, weight_decay=5e-4)
    meta = load_checkpoint(fpath, fresh, fresh_opt)
    assert meta == {"epoch": 2, "rank1": 0.75, "mAP": 0.5}
    _assert_state_equal(model, fresh)
    want, got = opt.state_dict(), fresh_opt.state_dict()
    assert want["param_groups"] == got["param_groups"]
    for k, s in want["state"].items():
        for field in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s[field], got["state"][k][field])


def test_load_refuses_what_weights_only_cannot_read(tmp_path):
    fpath = str(tmp_path / "pickled.pth.tar")
    torch.save({"state_dict": {}, "hook": copy.deepcopy}, fpath)  # a global: needs unpickling
    with pytest.raises(RuntimeError, match="pickled.pth.tar"):
        load_checkpoint(fpath)


@pytest.fixture(scope="module")
def jax_ckpt(jax_vmgn, tmp_path_factory):
    """agrl_tpu's save_checkpoint of the variables plus an adam state after
    one update, as its CLI writes them (epoch 4, rank-1 0.5, mAP 0.25)."""
    variables = jax_vmgn[1]
    tx = jopt.init_optim("adam", 1e-3, weight_decay=5e-4)
    params = variables["params"]
    grads = jax.tree.map(lambda p: np.full_like(p, 0.01), params)
    _, opt_state = jax.jit(tx.update)(grads, tx.init(params), params)
    tree = {"params": params, "batch_stats": variables["batch_stats"], "opt_state": opt_state}
    fpath = str(tmp_path_factory.mktemp("jax_ckpt") / "checkpoint_ep5.msgpack")
    jax_save_checkpoint(tree, fpath, epoch=4, rank1=0.5, mAP=0.25)
    return fpath


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_msgpack_reader_matches_flax(jax_ckpt):
    with open(jax_ckpt, "rb") as f:
        data = f.read()
    want = list(_leaves(serialization.msgpack_restore(data)))
    got = list(_leaves(flax_msgpack.msgpack_restore(data)))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert any(p[0] == "opt_state" for p, _ in want)
    for (path, a), (_, b) in zip(got, want):
        assert type(a) is type(b) and np.asarray(a).dtype == np.asarray(b).dtype, path
        assert np.array_equal(np.asarray(a), np.asarray(b)), path
    _, meta = flax_msgpack.read_checkpoint(jax_ckpt)
    assert meta == {"epoch": 4, "rank1": 0.5, "mAP": 0.25}


@pytest.mark.parametrize("data,match", [
    (b"\xc3", "0xc3"),  # true: outside the subset
    (b"\x81\x01\xc0", "not a str"),  # an int map key
    (b"\xd4\x02\x00", "ext type 2"),  # flax's complex ext
    (b"\x81\xa1a", "truncated"),
])
def test_msgpack_reader_refuses_outside_the_subset(data, match):
    with pytest.raises(ValueError, match=match):
        flax_msgpack.msgpack_restore(data)


def test_msgpack_reader_refuses_chunked_arrays():
    chunked = serialization.msgpack_serialize({"w": {"__msgpack_chunked_array__": 1}})
    with pytest.raises(ValueError, match="chunked"):
        flax_msgpack.msgpack_restore(chunked)


def test_agrl_tpu_checkpoint_evaluates_alike_in_the_port_cli(jax_vmgn, jax_ckpt, tmp_path):
    """--use-cpu --evaluate --load-weights x.msgpack through the port's CLI
    vs agrl_tpu's Evaluator on the same variables and split: the same
    rank-1, mAP within 1e-6 (tests/test_torch_eval.py's bar)."""
    jmodel, variables = jax_vmgn
    root = str(tmp_path / "data")
    (t_r1, t_map), out = _run_cli([
        "--use-cpu", "--evaluate", "--load-weights", jax_ckpt, "--root", root, "-d", "synthetic",
        "-a", "vmgn_tiny", "--height", str(H), "--width", str(W), "--seq-len", str(S),
        "--test-sample", "evenly", "--test-batch", "8", "--num-split", "4", "--pyramid-part",
        "--use-pose", "--learn-graph", "--num-gb", "2", "--dist-metric", "cosine",
        "--save-dir", str(tmp_path / "log"), "-j", "2",
    ])
    n_leaves = sum(1 for c in ("params", "batch_stats") for _ in _leaves(variables[c]))
    assert f"({n_leaves} matched, 0 skipped)" in out

    jds = jax_dataset("synthetic", root=root, materialize=False, verbose=False)
    common = dict(seq_len=S, sample="evenly", height=H, width=W, decode="pil",
                  pose_info=jds.process_poses)
    j_r1, j_map = JaxEvaluator(jmodel).evaluate(
        variables, JaxClipLoader(JaxClipDataset(jds.query, **common), 8, num_workers=1),
        JaxClipLoader(JaxClipDataset(jds.gallery, **common), 8, num_workers=1),
        dist_metric="cosine",
    )
    assert abs(t_r1 - float(j_r1)) < 1e-6
    assert abs(t_map - float(j_map)) < 1e-6


def test_port_checkpoint_reads_bit_equal_in_agrl_tpu(jax_vmgn, tmp_path):
    model = build_model("vmgn_tiny", num_classes=NUM_CLASSES)
    model.init_weights(torch.Generator().manual_seed(7))
    with torch.no_grad():  # BN statistics off their init values
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.uniform_(0.5, 1.5)
    opt = init_optim("adam", model.parameters(), 1e-3)
    fpath = str(tmp_path / "checkpoint_ep1.pth.tar")
    save_checkpoint(model, opt, fpath, epoch=0)
    template = {k: jax_vmgn[1][k] for k in ("params", "batch_stats")}
    new_vars, matched, skipped, unmapped = jax_load_any_checkpoint(template, fpath, "vmgn_tiny")
    assert skipped == [] and unmapped == []
    assert len(matched) == sum(1 for c in template for _ in _leaves(template[c]))
    _assert_state_equal(model, _port_from(new_vars))


def _sliced_heads(variables, n):
    """The variables with both classifiers cut to n classes."""
    out = copy.deepcopy(variables)
    for head in ("global_classifier", "att_classifier"):
        out["params"][head]["kernel"] = out["params"][head]["kernel"][:, :n]
    return out


def test_other_class_count_skips_the_heads_alike(jax_vmgn, tmp_path):
    """A reference-style .pth.tar (module. names) and an agrl_tpu msgpack,
    both of a 5-class model, into 8-class models of either package: the
    same matched and skipped counts, the heads skipped."""
    variables = jax_vmgn[1]
    five = _port_from(_sliced_heads(variables, 5), num_classes=5)
    ref = str(tmp_path / "ref.pth.tar")
    torch.save({"state_dict": {"module." + k: v for k, v in five.state_dict().items()}}, ref)
    msg = str(tmp_path / "ref.msgpack")
    five_vars = _sliced_heads(variables, 5)
    jax_save_checkpoint({k: five_vars[k] for k in ("params", "batch_stats")}, msg, epoch=0)
    template = {k: variables[k] for k in ("params", "batch_stats")}

    target = build_model("vmgn_tiny", num_classes=NUM_CLASSES)
    t_matched, t_skipped = load_weights_partial(target, ref)
    _, j_matched, j_skipped, unmapped = jax_load_any_checkpoint(template, ref, "vmgn_tiny")
    assert (len(t_matched), len(t_skipped)) == (len(j_matched), len(j_skipped))
    assert sorted(t_skipped) == ["att_classifier.weight", "global_classifier.weight"]
    assert unmapped == []

    target = build_model("vmgn_tiny", num_classes=NUM_CLASSES)
    t_matched, t_skipped = load_any_checkpoint(target, msg)
    _, j_matched, j_skipped = jax_load_weights_partial(template, msg)
    assert sorted(t_matched) == sorted(j_matched)
    assert sorted(t_skipped) == sorted(j_skipped) == [
        "params/att_classifier/kernel", "params/global_classifier/kernel"]
    # what did load is the source's
    ref_state = five.state_dict()
    for k, v in target.state_dict().items():
        if "classifier" not in k and not k.endswith("num_batches_tracked"):
            assert torch.equal(v, ref_state[k]), k


def test_pretrained_weights_match_agrl_tpu(jax_vmgn, tmp_path):
    """--pretrained-weights: a torchvision ResNet-50 dict (.npz) into
    vmgn_tiny, layer4 into both branches, shape-filtered."""
    variables = {k: jax_vmgn[1][k] for k in ("params", "batch_stats")}
    fpath = str(tmp_path / "r50.npz")
    np.savez(fpath, **synth_resnet50_state_dict(np.random.RandomState(0)))
    port = _port_from(variables)
    matched, skipped = init_pretrained_weights(port, fpath)
    j_vars, j_matched, j_skipped = jax_init_pretrained(variables, fpath)
    assert (len(matched), len(skipped)) == (len(j_matched), len(j_skipped))
    assert any(m.startswith("layer4_2.") for m in matched)
    _assert_state_equal(port, _port_from(j_vars))


def test_model_size_line_matches_agrl_tpu(jax_vmgn):
    params = jax_vmgn[1]["params"]
    assert count_num_param(_port_from(jax_vmgn[1])) == pytest.approx(
        jax_count_num_param(params), abs=1e-9)
    assert tcli.ARCH_NAMES[0] == "vmgn"
