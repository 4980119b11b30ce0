"""The port's legacy video archs held against agrl_tpu.

res50tp_legacy, res50ta (under both `att_gen` modes), res50rnn, resnet3d50
and resnet3dt at depth (1,1,1,1) (the 3-D ones at depth 10), 64x32 frames,
S=4, B=2: agrl_tpu's init weights (BN statistics, affine terms and biases
randomized, the LSTM's h-side biases among them) go to numpy and into the
port through `from_jax_variables`, and both extract features from the
same clips. Also: the train forward's heads, agrl_tpu's reverse export of
the port's state dict (every name but `num_batches_tracked` filled, with
the bridged values), `--test-sample all` (whole tracklets, unpadded, one
at a time, against agrl_tpu's Evaluator), the FLOPs line, the CPU bf16
Conv3d fault and the LSTM alone against flax's nn.RNN(OptimizedLSTMCell)
in fp32 and bf16. Serving, checkpoints and res50ta's frame size are held
in tests/test_torch_legacy_serve.py. `init_pretrained_weights` for
the temporal, image, resnet50m and 3-D layouts is held in
tests/test_torch_legacy_image.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrl_torch.engine.evaluator import Evaluator as TorchEvaluator
from agrl_torch.models import build_model, get_names
from agrl_torch.models.resnet3d import ResNet3D
from agrl_torch.models.resnet_temporal import ResNet50RNN, ResNet50TA, ResNet50TPLegacy
from agrl_torch.models.weight_convert import from_jax_variables
from agrl_torch.utils.model_complexity import compute_model_complexity, count_num_param
from agrl_tpu.engine.evaluator import Evaluator as JaxEvaluator
from agrl_tpu.models import get_names as jax_get_names
from agrl_tpu.models.resnet3d import ResNet3D as JResNet3D
from agrl_tpu.models import resnet_temporal as jtmp
from agrl_tpu.models.weight_convert import export_torch_state_dict
from agrl_tpu.utils.model_complexity import compute_model_complexity as jax_complexity
from agrl_tpu.utils.model_complexity import count_num_param as jax_count_num_param
from tests.test_torch_train import _flat
from tests.test_torch_vmgn import _randomize

torch.set_num_threads(2)

S, H, W, B, NUM_CLASSES = 4, 64, 32, 2, 10
TINY = (1, 1, 1, 1)
XH = frozenset({"xent", "htri"})
ARCHS = ("res50tp_legacy", "res50ta", "res50rnn", "resnet3d50", "resnet3dt")
WIDTH = {"res50rnn": 512, "resnet3d50": 512, "resnet3dt": 512}  # depth 10: 512 * 1
CONVERTER = {"res50ta_sigmoid": "res50ta"}  # agrl_tpu's export picks its converter by arch


def jax_model(arch):
    if arch == "res50tp_legacy":
        return jtmp.ResNet50TPLegacy(num_classes=NUM_CLASSES, loss=XH, layers=TINY)
    if arch.startswith("res50ta"):
        return jtmp.ResNet50TA(num_classes=NUM_CLASSES, loss=XH, layers=TINY,
                               att_gen="sigmoid" if arch.endswith("sigmoid") else "softmax")
    if arch == "res50rnn":
        return jtmp.ResNet50RNN(num_classes=NUM_CLASSES, loss=XH, layers=TINY)
    return JResNet3D(num_classes=NUM_CLASSES, loss=XH, depth=10)


def port_model(arch):
    if arch == "res50tp_legacy":
        return ResNet50TPLegacy(num_classes=NUM_CLASSES, loss=XH, layers=TINY)
    if arch.startswith("res50ta"):
        return ResNet50TA(num_classes=NUM_CLASSES, loss=XH, layers=TINY, height=H, width=W,
                          att_gen="sigmoid" if arch.endswith("sigmoid") else "softmax")
    if arch == "res50rnn":
        return ResNet50RNN(num_classes=NUM_CLASSES, loss=XH, layers=TINY)
    return ResNet3D(num_classes=NUM_CLASSES, loss=XH, depth=10)


def init_variables(model, x, seed=0, **kw):
    """Variables of agrl_tpu's `model` with its init's tree and shapes
    (jax.eval_shape of a train-mode init: nothing compiles), as numpy:
    kernels N(0, 2 / fan_in) from a seeded RandomState, then BN terms,
    statistics and biases randomized (tests/test_torch_vmgn.py's
    _randomize)."""
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0),
                                                "dropout": jax.random.PRNGKey(0)},
                                               jnp.asarray(x), train=True, **kw))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        if path[-1].key == "kernel":
            std = np.sqrt(2.0 / np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) * std).astype(np.float32)
        return np.zeros(s.shape, np.float32) if path[-1].key in ("bias", "mean") else np.ones(
            s.shape, np.float32)

    return _randomize({c: jax.tree_util.tree_map_with_path(fill, shapes.get(c, {}))
                       for c in ("params", "batch_stats")}, seed=seed + 1)


def clip_inputs(seed=3, batch=B, seq=S):
    return np.random.RandomState(seed).rand(batch, seq, H, W, 3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_forwards(arch):
    """agrl_tpu's jitted eval and train forwards of the arch (resnet3dt's are
    resnet3d50's)."""
    if arch == "resnet3dt":
        return _jax_forwards("resnet3d50")
    jm = jax_model(arch)
    return (jax.jit(lambda v, x: jm.apply(v, x, train=False)),
            jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"])))


@functools.lru_cache(maxsize=None)
def _bridged(arch):
    if arch == "resnet3dt":  # the same module as resnet3d50 (agrl_tpu's too)
        return _bridged("resnet3d50")
    variables = init_variables(jax_model(arch), clip_inputs())
    tmodel = port_model(arch)
    from_jax_variables(variables, tmodel)
    return variables, tmodel.eval()


@pytest.mark.parametrize("arch", ARCHS + ("res50ta_sigmoid",))
def test_eval_features_match_jax(arch):
    variables, tmodel = _bridged(arch)
    x = clip_inputs()
    want = np.asarray(_jax_forwards(arch)[0](variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, WIDTH.get(arch, 2048))
    # the bar of tests/test_torch_archs.py
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-4)


def test_resnet3d_depth_50_eval_matches_jax():
    """ResNet-3D at depth 50 (Bottleneck3D, (3,4,6,3)) on one (1, 4, 32, 32)
    clip."""
    jm = JResNet3D(num_classes=NUM_CLASSES, loss=XH, depth=50)
    x = np.random.RandomState(4).rand(1, 4, 32, 32, 3).astype(np.float32)
    variables = init_variables(jm, x, seed=5)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables,
                                                                        jnp.asarray(x)))
    tm = ResNet3D(num_classes=NUM_CLASSES, loss=XH, depth=50)
    from_jax_variables(variables, tm)
    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 2048)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_heads(arch):
    """The train forward gives (logits, feature) under {xent, htri}, the
    logits alone under {xent}, as agrl_tpu's; its logits and feature
    equal agrl_tpu's on the same batch (train-mode BN)."""
    variables, _ = _bridged(arch)
    model = port_model(arch)
    from_jax_variables(variables, model)
    x = clip_inputs(seed=5)
    (jy, jf), _ = _jax_forwards(arch)[1](variables, jnp.asarray(x))
    with torch.no_grad():
        y, f = model.train()(torch.from_numpy(x))
    assert tuple(y.shape) == (B, NUM_CLASSES) and tuple(f.shape) == (B, WIDTH.get(arch, 2048))
    for got, want in ((y, jy), (f, jf)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    xent_only = port_model(arch)
    xent_only.loss = frozenset({"xent"})
    with torch.no_grad():
        assert tuple(xent_only.train()(torch.from_numpy(x)).shape) == (B, NUM_CLASSES)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_leaf_coverage(arch):
    """Every state-dict entry found its leaf and every leaf was used (the
    strict bridge above); agrl_tpu's own reverse export, with the port's
    state dict as its name template, fills every entry but
    `num_batches_tracked` with the values the bridge loaded (res50rnn's
    frozen bias_ih_l0 with 0, bias_hh_l0 with flax's h-side bias); the
    parameter count equals agrl_tpu's."""
    variables, tmodel = _bridged(arch)
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    state, filled, kept = export_torch_state_dict(variables, sd, CONVERTER.get(arch, arch))
    assert all(n.endswith("num_batches_tracked") for n in kept), kept
    assert len(filled) + len(kept) == len(sd)
    for name in filled:
        np.testing.assert_array_equal(state[name], sd[name], err_msg=name)
    if arch == "res50rnn":
        assert not sd["lstm.bias_ih_l0"].any() and sd["lstm.bias_hh_l0"].any()
    exclude = getattr(tmodel, "count_exclude_heads", ("classifier",))
    assert count_num_param(tmodel, exclude) == pytest.approx(
        jax_count_num_param(variables["params"]), abs=1e-9)


@pytest.mark.parametrize("arch", ["res50ta", "res50rnn", "resnet3d50"])
def test_all_runs_each_tracklet_whole_as_agrl_tpu(arch):
    """`--test-sample all` with an arch that takes no frame mask: each
    tracklet (3 and 6 frames) in one forward, unpadded, in agrl_tpu's
    Evaluator and the port's alike (the LSTM, the softmax over frames and
    the 3-D convolutions see the whole tracklet)."""
    variables, tmodel = _bridged(arch)
    rng = np.random.RandomState(7)
    loader = [((rng.rand(1, n, H, W, 3) * 255).astype(np.uint8), np.asarray([i]),
               np.asarray([0]), np.ones((1, n, n), np.float32)) for i, n in enumerate((3, 6))]
    ev = TorchEvaluator(tmodel, test_sample="all", clip_batch=2, device="cpu")
    calls, inner = [], ev._fwd

    def counting(imgs, adjs, frame_mask=None):
        calls.append((np.asarray(imgs).shape[:2], frame_mask))
        return inner(imgs, adjs, frame_mask)

    ev._fwd = counting
    got = ev.extract(loader, "query")[0].numpy()
    assert calls == [((1, 3), None), ((1, 6), None)]
    want = JaxEvaluator(jax_model(arch), test_sample="all").extract(variables, loader, "query")[0]
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["res50tp_legacy", "res50ta", "res50rnn", "resnet3d50",
                                  "resnet3dt"])
def test_registry_factories_take_and_drop_keywords_as_agrl_tpu(arch):
    """The training CLI's keywords: `dtype`, `last_stride` and the graph
    flags are dropped (the models follow their input); the names are in
    both registries."""
    assert arch in get_names() and arch in jax_get_names()
    model = build_model(arch, num_classes=NUM_CLASSES, loss={"xent", "htri"}, last_stride=1,
                        num_parts=3, num_scale=1, num_split=4, pyramid_part=True, num_gb=2,
                        use_pose=True, learn_graph=True, consistent_loss=True, bnneck=False,
                        height=256, width=128, dtype=torch.bfloat16)
    assert getattr(model, "dtype", None) is None and not getattr(model, "consistent_loss", False)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    if arch.startswith("resnet3d"):
        assert model.depth == 50 and model.layer4[0].conv2.stride == (2, 2, 2)
    else:
        assert model.base[7][0].conv2.stride == (2, 2)  # layer4 at stride 2 whatever is asked


@pytest.mark.parametrize("arch", ["res50tp_legacy", "res50ta", "res50rnn", "resnet3d50"])
def test_flops_line_within_ten_percent_of_agrl_tpu(arch):
    """The startup line: parameters equal agrl_tpu's and the FLOPs of the
    1-clip eval forward are within 10% of agrl_tpu's XLA count (Conv3d
    over its in-bounds taps, the LSTM's products)."""
    variables, tmodel = _bridged(arch)
    params, gflops = compute_model_complexity(tmodel, S, H, W, verbose=False)
    j_params, j_gflops = jax_complexity(jax_model(arch), variables, seq_len=S, height=H,
                                        width=W, verbose=False)
    exclude = ("fc",) if arch == "resnet3d50" else ("classifier",)
    assert params == pytest.approx(j_params, abs=1e-9) and params == count_num_param(tmodel,
                                                                                   exclude)
    assert abs(gflops / j_gflops - 1) < 0.10, (gflops, j_gflops)


def test_cpu_bf16_conv3d_fault_is_stepped_around():
    """oneDNN's CPU bf16 Conv3d has Conv2d's fault (models/backbone.py): a
    3x3x3 stride-2 convolution of resnet3d's layer4 at 64x32 frames (a
    1x4x2 map to 1x2x1) comes out wrong by more than its size, or not
    finite; the port's Conv3d computes it in float64 on the bf16 values,
    within a bf16 step of the exact result. Other shapes keep oneDNN."""
    from agrl_torch.models.backbone import Conv3d

    torch.manual_seed(0)
    conv = Conv3d(256, 512, 3, stride=2, padding=1, bias=False)
    x = torch.randn(2, 256, 1, 4, 2).bfloat16()
    w = conv.weight.detach().bfloat16()
    exact = torch.nn.functional.conv3d(x.double(), w.double(), None, 2, 1)
    onednn = torch.nn.functional.conv3d(x, w, None, 2, 1).double()
    assert conv.onednn_bf16_faults(x)
    assert not torch.isfinite(onednn).all() or (onednn - exact).abs().max() > 0.5 * exact.abs().max()
    with torch.no_grad():
        got = conv.bfloat16()(x).double()
    assert (got - exact).abs().max() <= 2 ** -8 * exact.abs().max()
    for shape, k, s in (((2, 256, 1, 4, 2), 1, 2), ((2, 128, 1, 8, 4), 3, 2),
                        ((2, 512, 1, 2, 1), 3, 1)):
        probe = Conv3d(shape[1], 8, k, stride=s, padding=k // 2, bias=False)
        assert not probe.onednn_bf16_faults(torch.zeros(shape)), (shape, k, s)


def test_lstm_matches_flax_rnn_in_fp32_and_bf16():
    """The port's LSTM (torch operations under nn.LSTM's names) against
    flax's nn.RNN(OptimizedLSTMCell) on the same weights (biases nonzero)
    and inputs: float32, and everything bf16 as the bf16 eval hands it
    (flax's carry starts float32 and the hidden product promotes to it; the
    input product stays bf16), within 1e-5 of max in both."""
    from flax import linen as flax_nn

    from agrl_torch.models.resnet_temporal import LSTM
    from agrl_torch.models.weight_convert import _gather

    class RNN(flax_nn.Module):
        @flax_nn.compact
        def __call__(self, x, train=False):
            return flax_nn.RNN(flax_nn.OptimizedLSTMCell(512, name="lstm"))(x)

    rng = np.random.RandomState(0)
    x = (np.abs(rng.randn(3, 4, 2048)) * 0.5).astype(np.float32)
    jm = RNN()
    variables = init_variables(jm, x, seed=2)
    leaves = {("params",) + tuple(k.split("/")): v for k, v in _flat(variables["params"])}
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        lstm = LSTM(2048, 512)
        with torch.no_grad():
            for name, kind in (("weight_ih_l0", "lstm_ih"), ("weight_hh_l0", "lstm_hh"),
                               ("bias_hh_l0", "lstm_bias")):
                arr, _ = _gather(leaves, ("params", "lstm"), kind,
                                 tuple(getattr(lstm, name).shape))
                getattr(lstm, name).data = torch.from_numpy(arr).to(tdt)
            lstm.bias_ih_l0.data = lstm.bias_ih_l0.data.to(tdt)
            got = lstm(torch.from_numpy(x).to(tdt)).float().numpy()
        cast = jax.tree.map(lambda a: jnp.asarray(a, jdt), {"params": variables["params"]})
        want = np.asarray(jax.jit(jm.apply)(cast, jnp.asarray(x, jdt)), np.float32)
        assert got.shape == (3, 4, 512)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), jdt
