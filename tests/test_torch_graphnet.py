"""The port's msppn and msppgn held against agrl_tpu.

Depth (1,1,1,1), 64x32 frames, S=4, B=2, --num-split 4 (7 parts a level,
21 vertices a frame-averaged clip, V = 84 adjacency vertices): layer4's
map is 2x1 at stride 2, so the 4-row bins of the max pooling overlap
and repeat rows. agrl_tpu's init_params weights (BN statistics and affine
terms randomized) go to numpy and into the port through
`from_jax_variables`; both extract features from the same clips and a
non-uniform adjacency. msppgn runs in its four graph modes: pose and
learned (the paper's), learned only, pose only and neither (the
adjacency as given). agrl_tpu has no Pallas kernel on these archs' path.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from agrl_torch.models import build_model, default_num_vertices, get_names
from agrl_torch.models.backbone import adaptive_max_pool_rows
from agrl_torch.models.graphnet import MSPyraPartGraphNet, MSPyraPartNet
from agrl_torch.models.layers import GraphBlock
from agrl_torch.models.weight_convert import from_jax_variables
from agrl_torch.utils.model_complexity import count_num_param
from agrl_tpu.models import get_names as jax_get_names
from agrl_tpu.models import init_params
from agrl_tpu.models.backbone import adaptive_max_pool_rows as jax_max_pool_rows
from agrl_tpu.models.graphnet import MSPyraPartGraphNet as JMSPPGN
from agrl_tpu.models.graphnet import MSPyraPartNet as JMSPPN
from agrl_tpu.models.layers import GraphBlock as JGraphBlock
from agrl_tpu.models.weight_convert import export_torch_state_dict
from agrl_tpu.utils.model_complexity import count_num_param as jax_count_num_param
from tests.test_torch_vmgn import _randomize

torch.set_num_threads(2)

S, H, W, B, NUM_CLASSES, NUM_SPLIT, NUM_GB = 4, 64, 32, 2, 10, 4, 2
TINY = (1, 1, 1, 1)
NUM_V = 3 * 7  # vertices of a frame-averaged clip at --num-split 4
# arch variant -> (arch, use_pose, learn_graph)
VARIANTS = {
    "msppn": ("msppn", True, True),
    "msppgn": ("msppgn", True, True),
    "msppgn-learned": ("msppgn", False, True),
    "msppgn-pose": ("msppgn", True, False),
    "msppgn-neither": ("msppgn", False, False),
}


def jax_model(variant, num_split=NUM_SPLIT):
    arch, use_pose, learn_graph = VARIANTS[variant]
    if arch == "msppn":
        return JMSPPN(num_classes=NUM_CLASSES, num_split=num_split, layers=TINY)
    return JMSPPGN(num_classes=NUM_CLASSES, num_split=num_split, num_gb=NUM_GB,
                   use_pose=use_pose, learn_graph=learn_graph, layers=TINY)


def port_model(variant, num_split=NUM_SPLIT):
    arch, use_pose, learn_graph = VARIANTS[variant]
    if arch == "msppn":
        return MSPyraPartNet(num_classes=NUM_CLASSES, num_split=num_split, layers=TINY)
    return MSPyraPartGraphNet(num_classes=NUM_CLASSES, num_split=num_split, num_gb=NUM_GB,
                              use_pose=use_pose, learn_graph=learn_graph, layers=TINY)


def jax_variables(variant, seed=0, num_split=NUM_SPLIT):
    """agrl_tpu's init_params variables of the tiny arch, randomized."""
    variables = init_params(jax_model(variant, num_split), jax.random.PRNGKey(seed),
                            seq_len=S, height=H, width=W)
    return _randomize(jax.tree.map(np.asarray, dict(variables)), seed=seed + 1)


def clip_inputs(seed=3, batch=B, seq=S, num_split=NUM_SPLIT):
    """Seeded clips and a non-uniform 0/1 adjacency (plus its diagonal) of
    3 * total_split * seq vertices."""
    rng = np.random.RandomState(seed)
    x = rng.rand(batch, seq, H, W, 3).astype(np.float32)
    V = 3 * sum(2 ** i for i in range(num_split.bit_length())) * seq
    adj = (rng.rand(batch, V, V) > 0.5).astype(np.float32) + np.eye(V, dtype=np.float32)
    return x, adj


@functools.lru_cache(maxsize=None)
def _bridged(variant):
    variables = jax_variables(variant)
    tmodel = port_model(variant)
    from_jax_variables(variables, tmodel)
    return variant, variables, tmodel.eval()


@pytest.fixture(scope="module", params=list(VARIANTS))
def bridged(request):
    return _bridged(request.param)


def test_eval_features_match_jax(bridged):
    variant, variables, tmodel = bridged
    x, adj = clip_inputs()
    want = np.asarray(jax_model(variant).apply(variables, jnp.asarray(x), jnp.asarray(adj),
                                               train=False))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(adj)).numpy()
    width = 512 if variant == "msppn" else (NUM_GB + 1) * 512
    assert got.shape == want.shape == (B, width)
    # the bar of tests/test_torch_vmgn.py (agrl_tpu's against the reference)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-4)


def test_padded_all_forward_equals_unpadded(bridged):
    """The bucketed `all` contract on a non-uniform adjacency: a tracklet
    padded from S to 2S frames (zero frames, the adjacency scattered by
    `pad_eval_adjacency`, frame_mask 0) gives its unpadded feature. A
    trailing-block pad instead pairs the wrong vertices and moves it."""
    variant, _, tmodel = bridged
    x, adj = clip_inputs(seed=4, batch=1)
    Sp = 2 * S
    xp = np.concatenate([x, np.zeros_like(x)], axis=1)
    adjp = tmodel.pad_eval_adjacency(adj[0], S, Sp)[None]
    fm = np.concatenate([np.ones((1, S)), np.zeros((1, S))], axis=1).astype(np.float32)
    with torch.inference_mode():
        want = tmodel(torch.from_numpy(x), torch.from_numpy(adj))
        got = tmodel(torch.from_numpy(xp), torch.from_numpy(adjp),
                     frame_mask=torch.from_numpy(fm))
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        if tmodel.expected_adj_scales is not None:  # the blocks read adj
            trailing = np.zeros_like(adjp)
            trailing[:, :adj.shape[1], :adj.shape[2]] = adj
            wrong = tmodel(torch.from_numpy(xp), torch.from_numpy(trailing),
                           frame_mask=torch.from_numpy(fm))
            assert (wrong - want).abs().max() > 1e-3


@pytest.mark.parametrize("num,Sp", [(4, 8), (3, 8), (8, 8), (5, 16)])
@pytest.mark.parametrize("variant", ["msppn", "msppgn", "msppgn-learned", "msppgn-pose"])
def test_pad_eval_adjacency_bit_equal_to_jax(variant, num, Sp):
    """The hook agrl_tpu's Evaluator calls, even at Sp == num: the
    split-major scatter where the blocks read the adjacency, a zero
    graph of the padded size where they do not (msppn, learned only)."""
    rng = np.random.RandomState(num * 31 + Sp)
    V = 3 * 7 * num
    adj = rng.rand(V, V).astype(np.float32)
    got = port_model(variant).pad_eval_adjacency(adj, num, Sp)
    want = jax_model(variant).pad_eval_adjacency(adj, num, Sp)
    assert got.dtype == want.dtype and got.shape == want.shape == (3 * 7 * Sp,) * 2
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,n", [(8, 4), (4, 2), (2, 4), (3, 2), (5, 4), (7, 3)])
def test_adaptive_max_pool_rows_matches_jax_and_torch(h, n):
    """Bins that divide the height (8/4, 4/2) and bins that overlap and
    repeat rows (2/4, 3/2, 5/4, 7/3): agrl_tpu's NHWC function and torch's
    own adaptive max pooling to (n, 1)."""
    rng = np.random.RandomState(h * 10 + n)
    x = rng.randn(3, 6, h, 5).astype(np.float32)  # (N, C, H, W)
    got = adaptive_max_pool_rows(torch.from_numpy(x), n)
    want = np.asarray(jax_max_pool_rows(jnp.asarray(x.transpose(0, 2, 3, 1)), n))
    assert got.shape == (3, n, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    lib = F.adaptive_max_pool2d(torch.from_numpy(x), (n, 1))[..., 0].transpose(1, 2)
    np.testing.assert_array_equal(got.numpy(), lib.numpy())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["both", "learned", "pose", "neither"])
def test_graph_block_matches_jax(mode, masked):
    """GraphBlock alone in eval mode, with BN statistics and biases
    randomized, with and without a vertex mask (padding vertices: logits
    -1e9, a zeroed pose graph; all-padding rows stay finite)."""
    use_pose, learn_graph = mode in ("both", "pose"), mode in ("both", "learned")
    rng = np.random.RandomState(7)
    Bb, V, C = 2, 12, 16
    x = rng.randn(Bb, V, C).astype(np.float32)
    adj = (rng.rand(Bb, V, V) > 0.5).astype(np.float32) + np.eye(V, dtype=np.float32)
    vmask = None
    if masked:
        vmask = np.ones((Bb, V), np.float32)
        vmask[0, 8:] = 0.0
        vmask[1, ::3] = 0.0
    jb = JGraphBlock(in_features=C, out_features=C, use_pose=use_pose, learn_graph=learn_graph)
    variables = jb.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(adj), train=False)
    variables = _randomize(jax.tree.map(np.asarray, dict(variables)), seed=2)
    for name in ("linear", "emb_q", "emb_k"):  # init's N(0, 0.001) would flatten the graph
        if name in variables["params"]:
            leaf = variables["params"][name]
            leaf["kernel"] = rng.randn(*leaf["kernel"].shape).astype(np.float32) * 0.3
    want = np.asarray(jb.apply(variables, jnp.asarray(x), jnp.asarray(adj), train=False,
                               vertex_mask=None if vmask is None else jnp.asarray(vmask)))
    tb = GraphBlock(C, C, use_pose=use_pose, learn_graph=learn_graph).eval()
    with torch.no_grad():
        p, st = variables["params"], variables["batch_stats"]
        tb.linear.weight.copy_(torch.from_numpy(p["linear"]["kernel"].T.copy()))
        if learn_graph:
            for name in ("emb_q", "emb_k"):
                getattr(tb, name).weight.copy_(torch.from_numpy(p[name]["kernel"].T.copy()))
                getattr(tb, name).bias.copy_(torch.from_numpy(p[name]["bias"]))
        tb.bn.weight.copy_(torch.from_numpy(p["bn"]["scale"]))
        tb.bn.bias.copy_(torch.from_numpy(p["bn"]["bias"]))
        tb.bn.running_mean.copy_(torch.from_numpy(st["bn"]["mean"]))
        tb.bn.running_var.copy_(torch.from_numpy(st["bn"]["var"]))
        got = tb(torch.from_numpy(x), torch.from_numpy(adj),
                 vertex_mask=None if vmask is None else torch.from_numpy(vmask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_train_forward_heads(bridged):
    """22 heads at --num-split 4 (21 vertices, the fused one last): logits
    of (B, classes) and features 512 (msppn) or (num_gb + 1) * 512 wide;
    `frame_mask` stays eval-only."""
    variant, variables, _ = bridged
    model = port_model(variant)
    from_jax_variables(variables, model)
    x, adj = clip_inputs()
    xt, at = torch.from_numpy(x), torch.from_numpy(adj)
    with torch.no_grad():
        outputs, features = model.train()(xt, at)
        width = 512 if variant == "msppn" else (NUM_GB + 1) * 512
        assert [tuple(o.shape) for o in outputs] == [(B, NUM_CLASSES)] * (NUM_V + 1)
        assert [tuple(f.shape) for f in features] == [(B, width)] * (NUM_V + 1)
        with pytest.raises(ValueError, match="eval-only"):
            model(xt, at, frame_mask=torch.ones(B, S))


def test_bridge_leaf_coverage_and_params(bridged):
    """Every state-dict entry found its leaf and every leaf was used (the
    strict bridge above); agrl_tpu's reverse export of these archs fills a
    port-named state dict with the values the bridge loaded, keeping only
    num_batches_tracked; the parameter count of the startup line equals
    agrl_tpu's (msppn leaves out every head, msppgn nothing)."""
    variant, variables, tmodel = bridged
    arch = VARIANTS[variant][0]
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    state, filled, kept = export_torch_state_dict(variables, sd, arch)
    assert all(n.endswith("num_batches_tracked") for n in kept), kept
    assert len(filled) + len(kept) == len(sd)
    for name in filled:
        np.testing.assert_array_equal(state[name], sd[name], err_msg=name)
    excl = tmodel.count_exclude_heads
    assert count_num_param(tmodel, excl) == pytest.approx(
        jax_count_num_param(variables["params"], jax_model(variant).count_exclude_heads),
        abs=1e-9)
    # the CLI's "Model size" line: agrl_tpu counts its tree with the default
    # exclusion, which leaves msppn's classifier_{i} heads in
    size = count_num_param(tmodel, getattr(tmodel, "size_line_exclude", ("classifier",)))
    assert size == pytest.approx(jax_count_num_param(variables["params"]), abs=1e-9)
    # the reference's names, which the two archs spell differently
    if arch == "msppn":
        assert {"conv1.weight", "bn_f1.running_var", "classifier.21.bias",
                "fusion_conv.weight"} <= sd.keys()
    else:
        assert {"base.0.weight", "base.7.0.conv2.weight", "bn1.running_var",
                "gbs.1.linear.weight", "classifiers.21.bias"} <= sd.keys()
        assert ("gbs.1.emb_q.bias" in sd) == VARIANTS[variant][2]
        assert sd["bn1.running_var"].shape == (512,)  # a head BN, not the stem's


@pytest.mark.parametrize("arch", ["msppn", "msppgn"])
def test_registry_factories_take_and_drop_keywords_as_agrl_tpu(arch):
    """The CLI's keywords: both drop `dtype` (float32 under --bf16-train),
    `consistent_loss` and `last_stride`; msppn ignores `num_gb`;
    default_num_vertices counts the three scales."""
    assert arch in get_names() and arch in jax_get_names()
    model = build_model(arch, num_classes=NUM_CLASSES, loss={"xent", "htri"}, last_stride=1,
                        num_parts=3, num_scale=3, num_split=4, pyramid_part=True, num_gb=2,
                        use_pose=True, learn_graph=True, consistent_loss=True, bnneck=False,
                        dtype=torch.bfloat16)
    assert not hasattr(model, "dtype") and not getattr(model, "consistent_loss", False)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    trunk = model if arch == "msppn" else model.base
    assert trunk.layer4[0].conv2.stride[0] == 2 if arch == "msppn" else trunk[7][0].conv2.stride[0] == 2
    assert default_num_vertices(model, 8) == 168
    assert len(model.head_layers) == model.num_heads == 22
    assert getattr(model, "gbs", []) == [] if arch == "msppn" else len(model.gbs) == 2
    assert model.expected_adj_scales == (None if arch == "msppn" else 3)


@pytest.mark.parametrize("variant", ["msppn", "msppgn"])
def test_init_weights_follow_agrl_tpu(variant):
    """init_weights draws agrl_tpu's distributions: the reduce Linears and
    the fusion xavier-normal with zero biases, the classifiers torch's
    default Linear init (uniform, +-1/sqrt(fan_in), biases too),
    GraphBlock N(0, 0.001); two seeds give different weights."""
    model = build_model(variant, num_classes=NUM_CLASSES, num_split=4, num_gb=2)
    model.init_weights(torch.Generator().manual_seed(0))
    red = model.reduce_f3 if variant == "msppn" else model.reduce3
    assert red.weight.std().item() == pytest.approx((2 / (2048 + 512)) ** 0.5, rel=0.02)
    assert not red.bias.any()
    bound = 1 / 512 ** 0.5 if variant == "msppn" else 1 / 1536 ** 0.5
    for head in model.head_layers:
        assert head.weight.abs().max() <= bound and head.bias.abs().max() <= bound
        assert head.weight.abs().max() > 0.9 * bound
    if variant == "msppgn":
        assert model.gbs[0].emb_q.weight.std().item() == pytest.approx(0.001, rel=0.05)
        assert model.bn1.weight.eq(1).all()
    again = build_model(variant, num_classes=NUM_CLASSES, num_split=4, num_gb=2)
    again.init_weights(torch.Generator().manual_seed(1))
    assert not torch.equal(again.fusion_conv.weight, model.fusion_conv.weight)


@pytest.mark.parametrize("variant", ["msppn", "msppgn"])
def test_a_model_served_first_trains_after(variant):
    """The pooling matrix is cached outside inference mode: an eval forward
    under torch.inference_mode, then a train forward and backward."""
    model = port_model(variant)
    x, adj = clip_inputs()
    xt, at = torch.from_numpy(x), torch.from_numpy(adj)
    with torch.inference_mode():
        model.eval()(xt, at)
    outputs, _ = model.train()(xt, at)
    sum(o.sum() for o in outputs).backward()
    conv1 = model.conv1 if variant == "msppn" else model.base[0]
    assert conv1.weight.grad is not None and model.fusion_conv.weight.grad is not None


@pytest.mark.parametrize("variant", ["msppn", "msppgn"])
def test_flops_line_within_ten_percent_of_agrl_tpu(variant):
    """The startup line: parameters equal agrl_tpu's, and the FLOPs of the
    1-clip eval forward within 10% of agrl_tpu's XLA count (the bar of
    tests/test_torch_archs.py); the probe sizes its adjacency through
    default_num_vertices, 3 * 7 * S here."""
    from agrl_torch.utils.model_complexity import compute_model_complexity
    from agrl_tpu.utils.model_complexity import compute_model_complexity as jax_complexity

    _, variables, tmodel = _bridged(variant)
    params, gflops = compute_model_complexity(tmodel, S, H, W, verbose=False)
    j_params, j_gflops = jax_complexity(jax_model(variant), variables, seq_len=S, height=H,
                                        width=W, verbose=False)
    assert params == pytest.approx(j_params, abs=1e-9)
    assert abs(gflops / j_gflops - 1) < 0.10, (gflops, j_gflops)


def test_imagenet_init_fills_msppgn_base():
    """--pretrained-weights: a torchvision-named ResNet fills msppn's
    conv1/bn1/layer1..4 and msppgn's base.{0,1,4..7}; the heads keep
    their init."""
    from agrl_torch.models.weight_convert import init_pretrained_weights
    from tests.test_imagenet_init import synth_resnet50_state_dict

    full = synth_resnet50_state_dict(np.random.RandomState(0))
    src = {k: torch.as_tensor(v) for k, v in full.items()
           if not k.startswith("layer") or k.split(".")[1] == "0"}  # depth (1,1,1,1)
    counts = {}
    for variant in ("msppn", "msppgn"):
        model = port_model(variant)
        matched, skipped = init_pretrained_weights(model, src)
        counts[variant] = len(matched)
        stem = model.conv1 if variant == "msppn" else model.base[0]
        torch.testing.assert_close(stem.weight, src["conv1.weight"].float())
        l4 = model.layer4 if variant == "msppn" else model.base[7]
        torch.testing.assert_close(l4[0].bn3.running_var, src["layer4.0.bn3.running_var"].float())
        assert all(k.startswith("fc.") for k in skipped), skipped
    assert counts["msppn"] == counts["msppgn"] > 0


def _conv_512(stride=2, kernel=3, seed=0):
    from agrl_torch.models.backbone import Conv2d

    gen = torch.Generator().manual_seed(seed)
    conv = Conv2d(512, 512, kernel, stride=stride, padding=kernel // 2, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * 0.02)
    conv.compute_dtype = torch.bfloat16
    return conv, gen


def test_onednn_bf16_convolution_fails_where_the_port_steps_around_it():
    """torch's own CPU bf16 convolution at msppn's layer4 shape (64x32
    frames: layer3's 4x2 map, 3x3 at stride 2, to 2x1) misses the float32
    result by more than the output's size or is not finite: the fault the
    port's Conv2d steps around. If this fails, torch has repaired its
    kernel and `Conv2d.onednn_bf16_faults` can go. Shapes outside the
    faulting class (an output two columns wide, a 1x1 or a 3x1 kernel)
    still take oneDNN's kernel, and it is right there."""
    conv, gen = _conv_512()
    x = torch.randn(4, 512, 4, 2, generator=gen).bfloat16()
    assert conv.onednn_bf16_faults(x)
    w = conv.weight.bfloat16()
    want = F.conv2d(x.float(), w.float(), stride=2, padding=1)
    raw = F.conv2d(x, w, stride=2, padding=1).float()
    err = (raw - want).abs().max()
    assert not torch.isfinite(err) or float(err) > float(want.abs().max())
    for shape, (k, s) in (((4, 4), (3, 2)), ((4, 2), (1, 2)), ((8, 4), (3, 1))):
        conv, gen = _conv_512(stride=s, kernel=k)
        x = torch.randn(4, 512, *shape, generator=gen).bfloat16()
        assert not conv.onednn_bf16_faults(x), (shape, k, s)
        with torch.no_grad():
            got = conv(x).float()
            want = F.conv2d(x.float(), conv.weight.bfloat16().float(), stride=s, padding=k // 2)
        assert float((got - want).abs().max()) <= 8e-3 * float(want.abs().max()), (shape, k, s)


def test_cpu_bf16_convolution_is_right_where_onednn_is_not():
    """At msppn's layer4 shape the port's Conv2d computes the bf16
    convolution in float64 on the bf16 values and rounds the output: within
    bf16's rounding of the float32 result, and the same at 1 and 4
    threads. (The card's bf16 convolutions are cuDNN's.)"""
    conv, gen = _conv_512()
    with torch.no_grad():
        for batch in (4, 8):
            x = torch.randn(batch, 512, 4, 2, generator=gen).bfloat16()
            got = conv(x)
            # float32 on the bf16-rounded input and weight
            want = F.conv2d(x.float(), conv.weight.bfloat16().float(), stride=2, padding=1)
            assert got.dtype == torch.bfloat16 and got.shape == (batch, 512, 2, 1)
            assert float((got.float() - want).abs().max()) <= 8e-3 * float(want.abs().max())
            threads = torch.get_num_threads()
            try:
                for n in (1, 4):
                    torch.set_num_threads(n)
                    assert torch.equal(conv(x), got)
            finally:
                torch.set_num_threads(threads)
