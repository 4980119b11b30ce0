"""Serving and checkpoints of the legacy video archs.

On the tiny bridged models of tests/test_torch_legacy.py (depth (1,1,1,1),
resnet3d at depth 10, 64x32, S=4): an agrl_tpu `.msgpack` loads strictly,
res50rnn's LSTM packed gate by gate; res50ta's attention conv is sized by
the frame size it was built for (a 256x128 agrl_tpu checkpoint loads into
a model built for 256x128, not into one built for 64x32); the
FeatureExtractor's bf16 default against agrl_tpu's; the torch.export
artifact against the live features; `--resume` of an agrl_tpu res50rnn
checkpoint with its adam state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrl_torch.models import build_model
from agrl_torch.models.resnet_temporal import ResNet50TA, feature_map_size
from agrl_torch.models.weight_convert import from_jax_variables
from agrl_tpu.core.checkpoint import save_checkpoint as jax_save_checkpoint
from agrl_tpu.models import resnet_temporal as jtmp
from tests.test_torch_legacy import (
    NUM_CLASSES,
    TINY,
    WIDTH,
    XH,
    H,
    S,
    W,
    _bridged,
    jax_model,
    port_model,
)

torch.set_num_threads(2)


def test_msgpack_loads_strictly_and_lstm_leaves_are_packed(tmp_path):
    """An agrl_tpu res50rnn .msgpack: every flax leaf used once, the four
    gate kernels stacked in order i, f, g, o; a missing gate raises."""
    from agrl_torch.core.flax_msgpack import read_checkpoint

    variables, tmodel = _bridged("res50rnn")
    path = str(tmp_path / "rnn.msgpack")
    jax_save_checkpoint(variables, path, epoch=0)
    tree, _ = read_checkpoint(path)
    model = port_model("res50rnn")
    from_jax_variables(tree, model)
    lstm = variables["params"]["lstm"]
    w_ih = model.lstm.weight_ih_l0.detach().numpy()
    for k, g in enumerate("ifgo"):
        np.testing.assert_array_equal(w_ih[k * 512:(k + 1) * 512], lstm[f"i{g}"]["kernel"].T)
    missing = {c: dict(variables[c]) for c in variables}
    missing["params"] = dict(missing["params"], lstm={k: v for k, v in lstm.items() if k != "hg"})
    with pytest.raises(KeyError, match="lstm/hg/kernel"):
        from_jax_variables(missing, port_model("res50rnn"))


def test_res50ta_is_sized_by_its_frame_size(tmp_path):
    """attention_conv spans layer4's map: built for 256x128 it is 8x4 and a
    256x128 agrl_tpu checkpoint loads strictly; built for 64x32 (2x1) it
    refuses that checkpoint by shape and 256x128 frames with a message."""
    from agrl_torch.core.flax_msgpack import read_checkpoint

    assert feature_map_size(256, 128) == (8, 4) and feature_map_size(64, 32) == (2, 1)
    jm = jtmp.ResNet50TA(num_classes=NUM_CLASSES, loss=XH, layers=TINY)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, 2, 256, 128, 3)), train=True))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    assert variables["params"]["attention_conv"]["kernel"].shape[:2] == (8, 4)
    path = str(tmp_path / "ta.msgpack")
    jax_save_checkpoint({"params": variables["params"],
                         "batch_stats": variables["batch_stats"]}, path, epoch=0)
    tree, _ = read_checkpoint(path)
    big = ResNet50TA(num_classes=NUM_CLASSES, loss=XH, layers=TINY, height=256, width=128)
    from_jax_variables(tree, big)
    small = ResNet50TA(num_classes=NUM_CLASSES, loss=XH, layers=TINY, height=H, width=W)
    with pytest.raises(ValueError, match="attention_conv.weight: shape"):
        from_jax_variables(tree, small)
    with pytest.raises(ValueError, match="built for 64x32 frames"), torch.no_grad():
        small.eval()(torch.zeros(1, 2, 256, 128, 3))
    assert build_model("res50ta", num_classes=3).att_hw == (8, 4)  # the factory's default
    assert build_model("res50ta", num_classes=3, height=128, width=64).att_hw == (4, 2)


@pytest.mark.parametrize("arch", ["res50tp_legacy", "res50ta", "res50rnn", "resnet3d50"])
def test_default_bf16_feature_extractor_matches_agrl_tpu(arch):
    """Both serving APIs default to bf16 (weights and pixels rounded); the
    legacy archs follow their input, so they compute in bf16 in both
    packages: a ragged 3-clip request at batch 2 within 1e-2 of max, the
    bar of tests/test_torch_archs_serve.py. res50rnn's bf16 features lie
    ~0.4 of max from its fp32 ones in both packages (each gate's input
    product sums 2,048 terms of both signs, which multiplies the trunk's
    bf16 rounding), so the two packages' bf16 features agree only within
    1e-1 of max there; its LSTM fed the same inputs agrees within 1e-5
    (test_lstm_matches_flax_rnn_in_fp32_and_bf16)."""
    from agrl_torch.engine.export import FeatureExtractor
    from agrl_tpu.engine.export import FeatureExtractor as JaxFeatureExtractor

    variables, tmodel = _bridged(arch)
    imgs = np.random.RandomState(8).randint(0, 256, (3, S, H, W, 3)).astype(np.uint8)
    got = FeatureExtractor(tmodel, batch_size=2, seq_len=S, device="cpu")(imgs)
    want = JaxFeatureExtractor(jax_model(arch), variables, batch_size=2, seq_len=S)(imgs)
    assert got.shape == (3, WIDTH.get(arch, 2048)) and np.isfinite(got).all()
    bar = 1e-1 if arch == "res50rnn" else 1e-2
    assert np.abs(got - want).max() <= bar * np.abs(want).max()
    if arch == "res50rnn":
        f32 = JaxFeatureExtractor(jax_model(arch), variables, batch_size=2, seq_len=S,
                                  bf16=False)(imgs)
        assert np.abs(want - f32).max() > 0.2 * np.abs(f32).max()  # agrl_tpu's own bf16 gap


@pytest.mark.parametrize("arch", ["res50ta", "res50rnn", "resnet3d50"])
def test_artifact_serves_the_live_features(arch, tmp_path):
    """torch.export of the eval forward (res50rnn's LSTM unrolled over the
    artifact's 4 frames, the 3-D convolutions, res50ta's attention) saved,
    loaded and served with the model's weights: the live model's features
    for a ragged 3-clip request, with or without an adjacency."""
    from agrl_torch.engine.export import FeatureExtractor, export_eval_forward, save_exported

    _, model = _bridged(arch)
    imgs = np.random.RandomState(6).randint(0, 256, (3, S, H, W, 3)).astype(np.uint8)
    live = FeatureExtractor(model, batch_size=2, seq_len=S, bf16=False, device="cpu")
    want = live(imgs)
    path = str(tmp_path / f"{arch}.pt2")
    save_exported(path, export_eval_forward(model, model.state_dict(), batch_size=2, seq_len=S,
                                            height=H, width=W, bf16=False, device="cpu"))
    fx = FeatureExtractor.from_exported(path, model.state_dict())
    assert fx.batch_size == 2 and fx.seq_len == S
    np.testing.assert_allclose(fx(imgs), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(live(imgs, np.zeros((3, S, S), np.float32)), want)


def test_resume_of_an_agrl_tpu_res50rnn_checkpoint(tmp_path):
    """--resume x.msgpack (`resume_agrl_tpu`) of res50rnn with agrl_tpu's
    adam state (seeded moments in optax's layout): the weights, and each
    LSTM moment packed from the four gate leaves as its weight is, the
    h-side biases' moments on bias_hh_l0; the frozen bias_ih_l0 has no
    moment."""
    from agrl_torch.cli.train_vidreid_xent_htri import resume_agrl_tpu
    from agrl_torch.optim import init_optim
    from agrl_tpu import optim as jopt

    variables, _ = _bridged("res50rnn")
    params = jax.tree.map(jnp.asarray, variables["params"])
    opt_state = jopt.init_optim("adam", 1e-4, weight_decay=5e-4).init(params)
    rng = np.random.RandomState(9)
    opt_state = jax.tree.map(
        lambda a: (rng.rand(*a.shape).astype(np.float32) if a.dtype == jnp.float32
                   else np.asarray(a) + 3), opt_state)
    path = str(tmp_path / "rnn.msgpack")
    jax_save_checkpoint({**variables, "opt_state": opt_state}, path, epoch=2, rank1=0.5, mAP=0.25)
    model = port_model("res50rnn")
    opt = init_optim("adam", model.parameters(), 1e-4, weight_decay=5e-4)
    meta, step = resume_agrl_tpu(path, model, opt, "adam")
    assert step == 3 and meta["epoch"] == 2
    mu = opt_state[1][0].mu["lstm"]
    state = opt.state[model.lstm.weight_ih_l0]["exp_avg"].numpy()
    for k, g in enumerate("ifgo"):
        np.testing.assert_array_equal(state[k * 512:(k + 1) * 512], mu[f"i{g}"]["kernel"].T)
    np.testing.assert_array_equal(opt.state[model.lstm.bias_hh_l0]["exp_avg"].numpy(),
                                  np.concatenate([mu[f"h{g}"]["bias"] for g in "ifgo"]))
    assert model.lstm.bias_ih_l0 not in opt.state
    np.testing.assert_array_equal(model.lstm.weight_hh_l0.detach().numpy()[:512],
                                  variables["params"]["lstm"]["hi"]["kernel"].T)


@pytest.mark.parametrize("sample,pool", [("dense", "avg"), ("skipdense", "max")])
def test_packed_dense_extraction_matches_agrl_tpu(sample, pool, tmp_path):
    """res50rnn through the Evaluator's dense and skipdense extraction
    (clips of consecutive tracklets packed into batches of 2, pooled per
    tracklet) on a synthetic gallery of 3-10-frame tracklets, against
    agrl_tpu's Evaluator on the same weights: features within the eval
    forward's bar, pids and camids equal."""
    from agrl_torch.data.datasets import init_vidreid_dataset
    from agrl_torch.data.loader import ClipLoader, VideoClipDataset
    from agrl_torch.engine.evaluator import Evaluator
    from agrl_tpu.data.loader import ClipLoader as JaxClipLoader
    from agrl_tpu.data.loader import VideoClipDataset as JaxClipDataset
    from agrl_tpu.engine.evaluator import Evaluator as JaxEvaluator

    variables, tmodel = _bridged("res50rnn")
    ds = init_vidreid_dataset("synthetic", root=str(tmp_path), num_pids=4, tracklets_per_pid=2,
                              frames_per_tracklet=(3, 10), height=H, width=W, verbose=False)
    common = dict(seq_len=S, sample=sample, height=H, width=W, pose_info=ds.process_poses)
    loader = ClipLoader(VideoClipDataset(ds.gallery, **common), 1)
    jloader = JaxClipLoader(JaxClipDataset(ds.gallery, decode="pil", **common), 1, num_workers=1)
    got, pids, camids, _ = Evaluator(tmodel, test_sample=sample, pool=pool, clip_batch=2,
                                     device="cpu").extract(loader, "gallery")
    want, jpids, jcamids, _ = JaxEvaluator(jax_model("res50rnn"), test_sample=sample, pool=pool,
                                           clip_batch=2).extract(variables, jloader, "gallery")
    assert got.shape == (len(ds.gallery), 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=1e-4)
    np.testing.assert_array_equal(pids, jpids)
    np.testing.assert_array_equal(camids, jcamids)


def test_export_model_cli_sizes_res50ta_by_its_frame_size(monkeypatch):
    """`python -m agrl_torch.cli.export_model` builds the arch with its
    --height/--width, as the training CLI does, so res50ta's attention
    conv fits the frames the artifact serves."""
    import agrl_torch.models as models
    from agrl_torch.cli import export_model

    built = {}

    class Built(Exception):
        pass

    def capture(name, **kw):
        built.update(build_model(name, **{k: v for k, v in kw.items() if k != "device"}).__dict__)
        raise Built

    monkeypatch.setattr(models, "init_model", capture)
    with pytest.raises(Built):
        export_model.main(["-a", "res50ta", "--num-classes", "5", "--load-weights", "x.msgpack",
                           "--height", "128", "--width", "64", "--out", "x.pt2"])
    assert built["att_hw"] == (4, 2) and built["frame_size"] == (128, 64)
