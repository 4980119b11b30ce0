"""Serving, evaluation and checkpoints of msppn and msppgn.

At depth (1,1,1,1), 64x32, S=4, --num-split 4 on the CPU (weights from
agrl_tpu, tests/test_torch_graphnet.py): the exported eval artifact
serves the live model's features, and the FeatureExtractor's default
all-ones adjacency has default_num_vertices = 3 * 7 * S vertices (msppn
ignores any); the default bf16 serving follows agrl_tpu's; an agrl_tpu
`.msgpack` and a reference-named state dict of each arch load with every
entry matched (the two archs' names differ: msppgn's bn1 is a head BN);
the Evaluator's `dense` and bucketed `all` extraction on a synthetic set
with a 3-scale pose adjacency equals agrl_tpu's (`all` pads msppgn's
adjacency through pad_eval_adjacency, split-major); an agrl_tpu msppgn
run resumes in the port with its Adam state.
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
from agrl_torch.data.loader import ClipLoader as TorchClipLoader
from agrl_torch.data.loader import VideoClipDataset as TorchClipDataset
from agrl_torch.engine.evaluator import Evaluator as TorchEvaluator
from agrl_torch.engine.export import FeatureExtractor, export_eval_forward, save_exported
from agrl_torch.engine.trainer import make_train_step
from agrl_torch.models import default_num_vertices
from agrl_torch.models.weight_convert import NO_COUNTERPART
from agrl_torch.optim import init_optim
from agrl_tpu import optim as jopt
from agrl_tpu.core.checkpoint import save_checkpoint as jax_save_checkpoint
from agrl_tpu.data.loader import ClipLoader as JaxClipLoader
from agrl_tpu.data.loader import VideoClipDataset as JaxClipDataset
from agrl_tpu.engine.evaluator import Evaluator as JaxEvaluator
from agrl_tpu.engine.export import FeatureExtractor as JaxFeatureExtractor
from agrl_tpu.engine.train_state import create_train_state
from agrl_tpu.engine.trainer import make_train_step as jax_make_train_step
from agrl_tpu.models import backbone as jax_backbone
from agrl_tpu.models import graphnet as jax_graphnet
from agrl_tpu.models import layers as jax_layers
from agrl_tpu.models.weight_convert import convert_graphnet_state_dict, export_torch_state_dict
from tests.test_torch_eval_dense import CLIP_BATCH, synthetic  # noqa: F401
from tests.test_torch_graphnet import H, S, VARIANTS, W, _bridged, jax_model, port_model
from tests.test_torch_train import _flat
from tests.test_torch_vmgn import _randomize

torch.set_num_threads(2)

N = 3  # clips per request: one full batch of 2 and a ragged one
ARCHS = ("msppn", "msppgn")
WIDTH = {"msppn": 512, "msppgn": 1536}


def _clips(V=3 * 7 * S, seed=6):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (N, S, H, W, 3)).astype(np.uint8)
    adjs = ((rng.rand(N, V, V) > 0.5) + np.eye(V)).astype(np.float32)
    return imgs, adjs


@pytest.mark.parametrize("arch", ARCHS)
def test_artifact_serves_the_live_features(arch, tmp_path):
    _, _, model = _bridged(arch)
    V = default_num_vertices(model, S)
    assert V == 3 * 7 * S
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
    if arch == "msppn":  # no adjacency read: any one, or none, serves
        np.testing.assert_array_equal(live(imgs), want)
        np.testing.assert_array_equal(live(imgs, np.zeros_like(adjs)), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_default_bf16_feature_extractor_matches_agrl_tpu(arch):
    """Both serving APIs default to bf16 (weights, pixels and adjacency
    rounded); these models follow their input, so the trunk runs in bf16
    in both packages, the GraphBlock logits in float32: within 1e-2 of
    max, the bar of tests/test_torch_bf16_eval.py for VMGN's dtype None.
    msppn takes no adjacency."""
    _, variables, tmodel = _bridged(arch)
    imgs, adjs = _clips(seed=8)
    adjs = adjs if arch == "msppgn" else None
    got = FeatureExtractor(tmodel, batch_size=2, seq_len=S, device="cpu")(imgs, adjs)
    assert got.shape == (N, WIDTH[arch]) and np.isfinite(got).all()
    want = JaxFeatureExtractor(jax_model(arch), variables, batch_size=2, seq_len=S)(imgs, adjs)
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_msgpack_of_agrl_tpu_loads_every_leaf(arch, tmp_path):
    """An agrl_tpu checkpoint ({params, batch_stats}) through
    --load-weights' loader: every entry matched, nothing skipped, and the
    eval features agrl_tpu computes from those variables."""
    _, variables, _ = _bridged(arch)
    fpath = str(tmp_path / f"{arch}.msgpack")
    jax_save_checkpoint(variables, fpath, epoch=0)
    model = port_model(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_named_state_dict_loads(arch, tmp_path):
    """A reference-named checkpoint of the arch (agrl_tpu's reverse export
    of the same variables) loads with nothing skipped and gives the bridged
    model's features; agrl_tpu's converter reads the port's state dict
    back to the same variables, so the names are the reference's in both
    directions."""
    _, variables, tmodel = _bridged(arch)
    template = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    state, _, _ = export_torch_state_dict(variables, template, arch)
    path = str(tmp_path / f"{arch}.pth.tar")
    torch.save({"state_dict": {k: torch.tensor(np.asarray(v)) for k, v in state.items()}},
               path)
    model = port_model(arch)
    matched, skipped = load_any_checkpoint(model, path)
    assert not skipped and len(matched) == sum(
        not k.endswith(NO_COUNTERPART) for k in template)
    imgs, adjs = _clips()
    x, a = torch.from_numpy(imgs.astype(np.float32) / 255.0), torch.from_numpy(adjs)
    with torch.inference_mode():
        torch.testing.assert_close(model.eval()(x, a), tmodel(x, a), atol=0, rtol=0)
    back, skipped = convert_graphnet_state_dict(template, arch)
    assert not skipped
    for coll in ("params", "batch_stats"):
        want = dict(_flat(variables[coll]))
        got = dict(_flat(back[coll]))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _loaders(synthetic, sample):  # noqa: F811
    """The gallery of the synthetic set with the 3-scale pose adjacency
    (--num-scale 3 --num-split 4 --pyramid-part)."""
    tds, jds = synthetic
    common = dict(seq_len=S, sample=sample, height=H, width=W, num_split=4, num_scale=3,
                  pyramid_part=True)
    tset = TorchClipDataset(tds.gallery, pose_info=tds.process_poses, **common)
    jset = JaxClipDataset(jds.gallery, pose_info=jds.process_poses, decode="pil", **common)
    return TorchClipLoader(tset, 1), JaxClipLoader(jset, 1, num_workers=1)


@pytest.mark.parametrize("sample", ["dense", "all"])
@pytest.mark.parametrize("variant", ["msppn", "msppgn", "msppgn-learned"])
def test_extraction_matches_agrl_tpu(synthetic, variant, sample):  # noqa: F811
    """dense packed extraction and bucketed `all` (tracklets of 3-10
    frames padded to 8 or 16 with a frame mask, the adjacency through the
    model's pad_eval_adjacency, also at Sp == num) within the eval
    forward's bar, pids and camids equal."""
    _, variables, tmodel = _bridged(variant)
    tl, jl = _loaders(synthetic, sample)
    pads = []
    real_pad = tmodel.pad_eval_adjacency
    tmodel.pad_eval_adjacency = lambda adj, num, Sp: pads.append((num, Sp)) or real_pad(
        adj, num, Sp)
    try:
        t_f, t_pids, t_cams, _ = TorchEvaluator(tmodel, test_sample=sample,
                                                clip_batch=CLIP_BATCH,
                                                device="cpu").extract(tl, "gallery")
    finally:
        del tmodel.pad_eval_adjacency
    assert t_f.shape == (len(tl.dataset), WIDTH[VARIANTS[variant][0]])
    assert (len(pads) == len(tl.dataset)) == (sample == "all")
    j_f, j_pids, j_cams, _ = JaxEvaluator(jax_model(variant), test_sample=sample,
                                          clip_batch=CLIP_BATCH).extract(variables, jl, "gallery")
    np.testing.assert_allclose(t_f.numpy(), j_f, atol=5e-4, rtol=1e-4)
    np.testing.assert_array_equal(t_pids, j_pids)
    np.testing.assert_array_equal(t_cams, j_cams)


def test_resume_of_an_agrl_tpu_msppgn_run(tmp_path):
    """agrl_tpu trains msppgn (depth 1,1,1,1, --num-gb 1, 22 heads) two Adam
    steps and saves {params, batch_stats, opt_state}; the port's
    resume_agrl_tpu loads it (optax's count 2); its next step on the third
    batch lands within 2e-4 of max per leaf of agrl_tpu's third step,
    where a fresh optimizer state misses by more than 10x. agrl_tpu's BN
    takes its two-pass variance, as in tests/test_torch_resume.py."""
    from agrl_torch.models.graphnet import MSPyraPartGraphNet
    from agrl_tpu.models.graphnet import MSPyraPartGraphNet as JMSPPGN

    num_classes, lr, B = 8, 1e-4, 4
    jmodel = JMSPPGN(num_classes=num_classes, num_split=4, num_gb=1, layers=(1, 1, 1, 1))
    lr_fn = jopt.per_step(jopt.multistep_lr(lr, [1], gamma=0.1), 4)
    tx = jopt.init_optim("adam", lr_fn, weight_decay=5e-4, base_lr=lr)
    state = create_train_state(jmodel, tx, jax.random.PRNGKey(0), seq_len=S, height=H, width=W)
    variables = _randomize({"params": jax.tree.map(np.asarray, state.params),
                            "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})
    state = state.replace(params=jax.tree.map(jnp.asarray, variables["params"]),
                          batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
    rng = np.random.RandomState(11)
    batches = []
    for _ in range(3):
        base = rng.randint(0, 256, (B, 1, 1, 1, 3))
        imgs = np.clip(base + rng.randint(-40, 41, (B, S, H, W, 3)), 0, 255).astype(np.uint8)
        pids = rng.choice(num_classes, 2, replace=False).repeat(2).astype(np.int32)
        V = 3 * 7 * S
        batches.append((imgs, pids, ((rng.rand(B, V, V) > 0.5) + np.eye(V)).astype(np.float32)))
    two_pass = partial(flax_nn.BatchNorm, momentum=0.9, epsilon=1e-5, use_fast_variance=False)
    shipped = jax_backbone.BatchNorm
    jax_backbone.BatchNorm = jax_layers.BatchNorm = jax_graphnet.BatchNorm = two_pass
    fpath = str(tmp_path / "msppgn.msgpack")
    try:
        step = jax_make_train_step(jmodel, tx, label_smooth=False, soft_margin=True,
                                   aug={"flip_aug": False}, donate=False)
        for i, (imgs, pids, adj) in enumerate(batches):
            if i == 2:  # the checkpoint after two steps
                jax_save_checkpoint({"params": state.params, "batch_stats": state.batch_stats,
                                     "opt_state": state.opt_state}, fpath, epoch=0)
            state, _ = step(state, jnp.asarray(imgs), jnp.asarray(pids), jnp.asarray(adj),
                            jax.random.PRNGKey(1))
    finally:
        jax_backbone.BatchNorm = jax_layers.BatchNorm = jax_graphnet.BatchNorm = shipped

    def resumed():
        model = MSPyraPartGraphNet(num_classes=num_classes, num_split=4, num_gb=1,
                                   layers=(1, 1, 1, 1))
        optimizer = init_optim("adam", model.parameters(), lr, weight_decay=5e-4)
        return model, optimizer, resume_agrl_tpu(fpath, model, optimizer, "adam")

    try:
        model, optimizer, (meta, start) = resumed()
        fresh, _, _ = resumed()
    finally:
        for path in (fpath, fpath + ".json"):
            os.remove(path)
    assert start == 2 and meta["epoch"] == 0
    for m in (model, fresh):
        make_train_step(m, optimizer if m is model else init_optim(
            "adam", m.parameters(), lr, weight_decay=5e-4), lambda s: lr, label_smooth=False,
            aug={"flip_aug": False}, start_step=start)(*batches[2])

    def leaf_errors(m):
        sd = {k: v for k, v in m.state_dict().items() if not k.endswith(NO_COUNTERPART)}
        got, errs = convert_graphnet_state_dict(sd, "msppgn")[0], {}
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
    assert errs[worst] <= 2e-4, (worst, errs[worst])
    assert max(fresh_errs.values()) > 10 * errs[worst]


def test_export_model_cli_serves_msppgn(tmp_path):
    """`python -m agrl_torch.cli.export_model -a msppgn` (full ResNet-50
    depth, --num-gb 1, a port checkpoint): the artifact, served with the
    checkpoint's weights by a FeatureExtractor that builds no model, gives
    the live model's fp32 features on a 3 x 7 x S-vertex pose graph."""
    from agrl_torch.cli import export_model
    from agrl_torch.core.checkpoint import load_variables
    from agrl_torch.models import build_model

    model = build_model("msppgn", num_classes=5, num_split=4, num_gb=1)
    model.init_weights(torch.Generator().manual_seed(0))
    ckpt, out = str(tmp_path / "msppgn.pth.tar"), str(tmp_path / "msppgn.pt2")
    torch.save({"state_dict": model.state_dict()}, ckpt)
    export_model.main(["-a", "msppgn", "--num-classes", "5", "--load-weights", ckpt,
                       "--num-split", "4", "--pyramid-part", "--use-pose", "--learn-graph",
                       "--num-gb", "1", "--num-scale", "3", "--batch", "2", "--seq-len", str(S),
                       "--height", str(H), "--width", str(W), "--no-bf16", "--device", "cpu",
                       "--out", out])
    fx = FeatureExtractor.from_exported(out, load_variables(ckpt))
    imgs, adjs = _clips()
    live = FeatureExtractor(model.eval(), batch_size=2, seq_len=S, bf16=False, device="cpu")
    want = live(imgs, adjs)
    assert want.shape == (N, 1024)
    np.testing.assert_allclose(fx(imgs, adjs), want, atol=1e-5, rtol=1e-5)
