"""The port's single-scale video archs held against agrl_tpu.

gsta, ganet, res50tp, resnet50_s1, sta and simple_sta at depth (1,1,1,1),
64x32 frames, S=4, B=2 (layer4's map is 4x2, so ganet's stripes of
h // n rows for n in 1, 2, 4 and the 4-part pooling divide it):
agrl_tpu's init_params weights (BN statistics, affine terms and biases
randomized; ganet's PAM gamma set to a seeded nonzero value, since it
starts at 0 and would hide the attention) go to numpy and into the port
through `from_jax_variables`, and both extract features from the same
clips. sta's arg-max frame pick is discontinuous, and on seeded noise
alone the four frames' scores lie ~5e-6 apart, close enough for fp32
differences to flip the pick; so each frame carries a bright band over a
different quarter of its rows, which puts each part's two best frames
more than 1e-3 apart (asserted below).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrl_torch.models import build_model, default_num_vertices, get_names
from agrl_torch.models.ganet import GANet
from agrl_torch.models.gsta import GSTA
from agrl_torch.models.res50tp import ResNet50S1, ResNet50TP
from agrl_torch.models.sta import STA
from agrl_torch.models.weight_convert import from_jax_variables
from agrl_torch.utils.model_complexity import count_num_param
from agrl_tpu.models import get_names as jax_get_names
from agrl_tpu.models import init_params
from agrl_tpu.models.ganet import GANet as JGANet
from agrl_tpu.models.gsta import GSTA as JGSTA
from agrl_tpu.models.res50tp import ResNet50S1 as JResNet50S1
from agrl_tpu.models.res50tp import ResNet50TP as JResNet50TP
from agrl_tpu.models.sta import STA as JSTA
from agrl_tpu.models.weight_convert import export_torch_state_dict
from agrl_tpu.utils.model_complexity import count_num_param as jax_count_num_param
from tests.test_torch_vmgn import _randomize

torch.set_num_threads(2)

S, H, W, B, NUM_CLASSES = 4, 64, 32, 2, 10
TINY = (1, 1, 1, 1)
ARCHS = ("gsta", "ganet", "res50tp", "resnet50_s1", "sta", "simple_sta")
# eval feature width per arch
WIDTH = {"gsta": 2048, "ganet": 6144, "res50tp": 2048, "resnet50_s1": 2048, "sta": 1024,
         "simple_sta": 1024}
PAM_GAMMA = 0.3


def jax_model(arch, consistent_loss=False):
    kw = dict(num_classes=NUM_CLASSES, layers=TINY)
    if arch in ("gsta", "ganet"):
        cls = JGSTA if arch == "gsta" else JGANet
        return cls(consistent_loss=consistent_loss, **kw)
    if arch == "res50tp":
        return JResNet50TP(**kw)
    if arch == "resnet50_s1":
        return JResNet50S1(**kw)
    return JSTA(reduced_dim=1024, simple=arch == "simple_sta", **kw)


def port_model(arch, consistent_loss=False):
    kw = dict(num_classes=NUM_CLASSES, layers=TINY)
    if arch in ("gsta", "ganet"):
        cls = GSTA if arch == "gsta" else GANet
        return cls(consistent_loss=consistent_loss, **kw)
    if arch == "res50tp":
        return ResNet50TP(**kw)
    if arch == "resnet50_s1":
        return ResNet50S1(**kw)
    return STA(simple=arch == "simple_sta", **kw)


def jax_variables(arch, seed=0):
    """agrl_tpu's init_params variables of the tiny arch, randomized."""
    variables = init_params(jax_model(arch, consistent_loss=arch in ("gsta", "ganet")),
                            jax.random.PRNGKey(seed), seq_len=S, height=H, width=W)
    variables = _randomize(jax.tree.map(np.asarray, dict(variables)), seed=seed + 1)
    if arch == "ganet":
        variables["params"]["pam_layer"]["gamma"] = np.full((1,), PAM_GAMMA, np.float32)
    return variables


def clip_inputs(arch, seed=3, batch=B, seq=S):
    """Seeded noise under a bright band over quarter s % 4 of frame s's rows."""
    rng = np.random.RandomState(seed)
    x = rng.rand(batch, seq, H, W, 3).astype(np.float32) * 0.2
    for s in range(seq):
        x[:, s, (s % 4) * H // 4:(s % 4 + 1) * H // 4] += 1.0
    V = seq * 7
    adj = (rng.rand(batch, V, V) > 0.5).astype(np.float32) + np.eye(V, dtype=np.float32)
    return x, adj


@functools.lru_cache(maxsize=None)
def _bridged(arch):
    variables = jax_variables(arch)
    tmodel = port_model(arch, consistent_loss=arch in ("gsta", "ganet"))
    from_jax_variables(variables, tmodel)
    return arch, variables, tmodel.eval()


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    return _bridged(request.param)


def test_eval_features_match_jax(bridged):
    arch, variables, tmodel = bridged
    x, adj = clip_inputs(arch)
    jmodel = jax_model(arch)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), jnp.asarray(adj), train=False))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(adj)).numpy()
    assert got.shape == want.shape == (B, WIDTH[arch])
    # the bar of tests/test_torch_vmgn.py (agrl_tpu's against the reference)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["sta", "simple_sta"])
def test_sta_inputs_are_far_from_a_frame_tie(arch):
    """The pick of f_1 is an arg-max over frames: the seeded inputs of
    test_eval_features_match_jax keep each part's two best frames apart."""
    _, _, tmodel = _bridged(arch)
    x, _ = clip_inputs(arch)
    with torch.inference_mode():
        xt = torch.from_numpy(x).reshape(B * S, H, W, 3).permute(0, 3, 1, 2)
        fmap = tmodel.layer4(tmodel.forward_trunk(xt))
        v_g = tmodel.part_pool(fmap, (4,)).reshape(B, S, 4, -1)
        scores = tmodel.frame_scores(fmap, v_g, None)[..., 0]  # (B, S, parts)
    top2 = scores.topk(2, dim=1).values
    assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-3


def test_padded_all_forward_equals_unpadded(bridged):
    """The bucketed `all` contract: a tracklet padded from S to 2S frames
    (zero frames, a zero block of the adjacency, frame_mask 0) gives its
    unpadded feature."""
    arch, _, tmodel = bridged
    x, adj = clip_inputs(arch, seed=4, batch=1)
    V, Vp = adj.shape[1], 2 * adj.shape[1]
    xp = np.concatenate([x, np.zeros_like(x)], axis=1)
    adjp = np.zeros((1, Vp, Vp), np.float32)
    adjp[:, :V, :V] = adj
    fm = np.concatenate([np.ones((1, S)), np.zeros((1, S))], axis=1).astype(np.float32)
    with torch.inference_mode():
        want = tmodel(torch.from_numpy(x), torch.from_numpy(adj))
        got = tmodel(torch.from_numpy(xp), torch.from_numpy(adjp), frame_mask=torch.from_numpy(fm))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_train_forward_heads(bridged):
    """Heads and widths of the train forward: gsta and ganet with the
    consistent loss give 2 heads (lists), the others one bare head; the
    triplet features are gsta 2048, ganet 6144, res50tp and resnet50_s1
    2048, sta and simple_sta 1024 wide; `frame_mask` stays eval-only."""
    arch, variables, _ = bridged
    model = port_model(arch, consistent_loss=arch in ("gsta", "ganet"))
    from_jax_variables(variables, model)
    x, adj = clip_inputs(arch)
    xt, at = torch.from_numpy(x), torch.from_numpy(adj)
    with torch.no_grad():
        if arch in ("gsta", "ganet"):
            outputs, features = model.train()(xt, at, subclip_indices=[0, 3])
            assert [tuple(o.shape) for o in outputs] == [(B, NUM_CLASSES)] * 2
            assert [tuple(f.shape) for f in features] == [(B, WIDTH[arch])] * 2
        else:
            y, f = model.train()(xt, at)
            assert tuple(y.shape) == (B, NUM_CLASSES) and tuple(f.shape) == (B, WIDTH[arch])
        with pytest.raises(ValueError, match="eval-only"):
            model(xt, at, frame_mask=torch.ones(B, S))


def test_bridge_leaf_coverage(bridged):
    """Every state-dict entry found its leaf and every leaf was used (the
    strict bridge above); agrl_tpu's own reverse export fills a port-named
    state dict with the values the bridge loaded, keeping only entries
    with no flax counterpart."""
    arch, variables, tmodel = bridged
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    state, filled, kept = export_torch_state_dict(variables, sd, arch)
    assert all(n.endswith(("num_batches_tracked", "bottleneck.bias")) for n in kept), kept
    assert len(filled) + len(kept) == len(sd)
    for name in filled:
        np.testing.assert_array_equal(state[name], sd[name], err_msg=name)
    # the parameter count of the startup line equals agrl_tpu's
    assert count_num_param(tmodel) == pytest.approx(jax_count_num_param(variables["params"]),
                                                    abs=1e-9)


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_factories_take_and_drop_keywords_as_agrl_tpu(arch):
    """The CLI's keywords: gsta and ganet keep `dtype`; the others drop it
    and follow their input; gsta drops `last_stride` (layer4 at stride 1);
    every name is in agrl_tpu's registry."""
    assert arch in get_names() and arch in jax_get_names()
    model = build_model(arch, num_classes=NUM_CLASSES, loss={"xent", "htri"}, last_stride=2,
                        num_parts=3, num_scale=1, num_split=4, pyramid_part=True, num_gb=2,
                        use_pose=True, learn_graph=True, consistent_loss=True, bnneck=False,
                        dtype=torch.bfloat16)
    assert getattr(model, "dtype", None) == (torch.bfloat16 if arch in ("gsta", "ganet")
                                             else None)
    stride = model.layer4[0].conv2.stride[0]
    assert stride == (2 if arch in ("res50tp", "resnet50_s1") else 1)
    assert getattr(model, "consistent_loss", False) == (arch in ("gsta", "ganet"))
    assert default_num_vertices(model, 8) == (56 if arch in ("gsta", "ganet") else 8)


@pytest.mark.parametrize("arch", ["vmgn_tiny", "gsta", "sta"])
def test_a_model_served_first_trains_after(arch):
    """The pooling matrix a model caches is made outside inference mode: an
    eval forward under torch.inference_mode (the Evaluator's, the
    FeatureExtractor's) and then a train forward and backward of the same
    model run (the cached inference tensor once broke autograd)."""
    model = (build_model("vmgn_tiny", num_classes=NUM_CLASSES) if arch == "vmgn_tiny"
             else port_model(arch))
    x, adj = clip_inputs(arch)
    xt, at = torch.from_numpy(x), torch.from_numpy(adj)
    with torch.inference_mode():
        model.eval()(xt, at)
    outputs, features = model.train()(xt, at)
    heads = outputs if isinstance(outputs, list) else [outputs]
    sum(o.sum() for o in heads).backward()
    assert model.conv1.weight.grad is not None


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_line_within_ten_percent_of_agrl_tpu(arch):
    """The startup line: parameters equal agrl_tpu's, and the port's
    FlopCounterMode count of the 1-clip eval forward is within 10% of
    agrl_tpu's XLA cost analysis (the bar of tests/test_torch_host_utils.py
    for VMGN: XLA also counts the elementwise work)."""
    from agrl_torch.utils.model_complexity import compute_model_complexity
    from agrl_tpu.utils.model_complexity import compute_model_complexity as jax_complexity

    _, variables, tmodel = _bridged(arch)
    params, gflops = compute_model_complexity(tmodel, S, H, W, verbose=False)
    j_params, j_gflops = jax_complexity(jax_model(arch), variables, seq_len=S, height=H,
                                        width=W, verbose=False)
    assert params == pytest.approx(j_params, abs=1e-9)
    assert abs(gflops / j_gflops - 1) < 0.10, (gflops, j_gflops)


def test_pam_and_cam_match_agrl_tpu():
    """ganet's attention modules alone at gamma 0.3: PAM (1x1 convs with
    bias, softmax over the stripe's pixels; the attended map too) and CAM,
    which no forward calls, as in agrl_tpu; NHWC there, NCHW here."""
    from agrl_torch.models.ganet import CAM, PAM
    from agrl_tpu.models.ganet import CAM as JCAM
    from agrl_tpu.models.ganet import PAM as JPAM

    rng = np.random.RandomState(11)
    x = rng.randn(3, 4, 2, 64).astype(np.float32)  # (N, H, W, C)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    jpam = JPAM(64)
    pvars = jax.tree.map(np.asarray, dict(jpam.init(jax.random.PRNGKey(0), jnp.asarray(x))))
    pvars["params"]["gamma"] = np.full((1,), 0.3, np.float32)
    for name in ("query_conv", "key_conv", "value_conv"):
        pvars["params"][name]["bias"] = rng.randn(*pvars["params"][name]["bias"].shape).astype(
            np.float32) * 0.1
    pam = PAM(64)
    with torch.no_grad():
        pam.gamma.fill_(0.3)
        for name in ("query_conv", "key_conv", "value_conv"):
            conv, leaf = getattr(pam, name), pvars["params"][name]
            conv.weight.copy_(torch.from_numpy(leaf["kernel"].transpose(3, 2, 0, 1).copy()))
            conv.bias.copy_(torch.from_numpy(leaf["bias"]))
        got, got_att = pam(xt)
    want, want_att = jpam.apply(pvars, jnp.asarray(x))
    for a, b in ((got, want), (got_att, want_att)):
        b = np.asarray(b)  # within 1e-5 of max: the softmax of the logits is sharp
        assert np.abs(a.numpy().transpose(0, 2, 3, 1) - b).max() <= 1e-5 * np.abs(b).max()
    jcam = JCAM()
    cvars = {"params": {"gamma": jnp.full((1,), 0.3)}}
    cam = CAM()
    with torch.no_grad():
        cam.gamma.fill_(0.3)
        got = cam(xt * 0.1)
    want = np.asarray(jcam.apply(cvars, jnp.asarray(x * 0.1)))
    assert np.abs(got.numpy().transpose(0, 2, 3, 1) - want).max() <= 1e-5 * np.abs(want).max()
