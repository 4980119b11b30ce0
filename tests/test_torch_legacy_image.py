"""The port's image registry, its top-k accuracy and its legacy host
transforms held against agrl_tpu.

resnet50, resnet101, resnet50m and resnet50b at a tiny depth ((1,1,1,1);
resnet101's (1,1,2,1), two layer3 blocks), 64x32 images, B=4: agrl_tpu's
init weights (randomized) bridged into the port, the eval feature and the
train forward (logits, feature and the BN statistics) on the same images.
ResNet50B's Dropout(0.5) mask cannot be drawn in torch from a JAX key:
it is read off flax's `Dropout_0` output (capture_intermediates; its
input has no exact zero) and given to the port's module. Then
`init_pretrained_weights` for the temporal, image, resnet50m and 3-D
layouts against agrl_tpu's, `metrics.accuracy`, and each class of
`data.transforms_legacy` under the same RandomState seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn
from PIL import Image

from agrl_torch.data import transforms_legacy as tl
from agrl_torch.metrics.accuracy import accuracy
from agrl_torch.models import get_image_names, init_image_model
from agrl_torch.models.resnet3d import ResNet3D
from agrl_torch.models.resnet_image import Dropout, ResNet50B, ResNet50M, ResNetImage
from agrl_torch.models.resnet_temporal import ResNet50TPLegacy
from agrl_torch.models.weight_convert import (
    _gather,
    from_jax_variables,
    init_pretrained_weights,
    torch_name_map,
)
from agrl_tpu.data import transforms_legacy as jtl
from agrl_tpu.metrics.accuracy import accuracy as jax_accuracy
from agrl_tpu.models import backbone as jax_backbone
from agrl_tpu.models import get_image_names as jax_get_image_names
from agrl_tpu.models import resnet_image as jimg
from agrl_tpu.models import resnet_temporal as jtmp
from agrl_tpu.models.resnet3d import ResNet3D as JResNet3D
from agrl_tpu.models.weight_convert import export_torch_state_dict
from agrl_tpu.models.weight_convert import init_pretrained_weights as jax_init_pretrained
from tests.test_torch_train import _flat
from tests.test_torch_legacy import init_variables

torch.set_num_threads(2)

H, W, B, NUM_CLASSES = 64, 32, 4, 10
XH = frozenset({"xent", "htri"})
LAYERS = {"resnet50": (1, 1, 1, 1), "resnet101": (1, 1, 2, 1), "resnet50m": (1, 1, 1, 1),
          "resnet50b": (1, 1, 1, 1)}
WIDTH = {"resnet50m": 3072}


def jax_model(arch):
    if arch == "resnet50m":
        return jimg.ResNet50M(num_classes=NUM_CLASSES, loss=XH, layers=LAYERS[arch])
    if arch == "resnet50b":
        return jimg.ResNet50B(num_classes=NUM_CLASSES, loss=XH, layers=LAYERS[arch])
    return jimg.ResNetImage(num_classes=NUM_CLASSES, loss=XH, layers=LAYERS[arch])


def port_model(arch):
    cls = {"resnet50m": ResNet50M, "resnet50b": ResNet50B}.get(arch, ResNetImage)
    return cls(num_classes=NUM_CLASSES, loss=XH, layers=LAYERS[arch])


def images(seed=3):
    return np.random.RandomState(seed).rand(B, H, W, 3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _bridged(arch):
    jm = jax_model(arch)
    variables = init_variables(jm, images())
    tmodel = port_model(arch)
    from_jax_variables(variables, tmodel)
    return jm, variables, tmodel.eval()


def test_image_registry_is_agrl_tpu_s():
    """The names, in order, and each factory's model: seeded, on the CPU
    when asked, in eval mode; resnet101 is (3, 4, 23, 3); resnet50b's
    dropout draws from its own seeded generator."""
    assert get_image_names() == jax_get_image_names() == ["resnet50", "resnet101", "resnet50m",
                                                          "resnet50b"]
    with pytest.raises(KeyError, match="Unknown image model"):
        init_image_model("vmgn", NUM_CLASSES, device="cpu")
    m101 = init_image_model("resnet101", NUM_CLASSES, device="cpu")
    assert [len(m101.base[i]) for i in (4, 5, 6, 7)] == [3, 4, 23, 3] and not m101.training
    b1, b2 = (init_image_model("resnet50b", NUM_CLASSES, device="cpu", loss=XH, seed=4)
              for _ in range(2))
    torch.testing.assert_close(b1.classifier.weight, b2.classifier.weight, atol=0, rtol=0)
    assert b1.base[7][0].conv2.stride == (1, 1)  # last_stride 1
    x = torch.rand(2, 64, 32, 3)
    with torch.no_grad():
        y1, f1 = b1.train()(x)
        y2, _ = b2.train()(x)
    torch.testing.assert_close(y1, y2, atol=0, rtol=0)  # the same dropout draw
    assert tuple(f1.shape) == (2, 2048)


@pytest.mark.parametrize("arch", list(LAYERS))
def test_image_eval_matches_jax(arch):
    jm, variables, tmodel = _bridged(arch)
    x = images()
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables,
                                                                        jnp.asarray(x)))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, WIDTH.get(arch, 2048))
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", list(LAYERS))
def test_image_train_forward_matches_jax(arch):
    """(logits, feature) and the BN running statistics after one train
    forward, within 1e-4 and 1e-5 of max; ResNet50B with flax's dropout
    mask. agrl_tpu runs its BatchNorm's two-pass variance here, as
    tests/test_torch_train.py takes its gradients: its default one-pass
    E[x^2] - E[x]^2 misses resnet50m's layers5b statistics (8 values a
    channel at 2x1 maps) by 1.2e-5 of max."""
    _, variables, _ = _bridged(arch)
    x = images(seed=4)
    two_pass = functools.partial(flax_nn.BatchNorm, momentum=0.9, epsilon=1e-5,
                                 use_fast_variance=False)
    real = jax_backbone.BatchNorm, jimg.BatchNorm
    jax_backbone.BatchNorm = jimg.BatchNorm = two_pass
    try:
        jm = jax_model(arch)
        fwd = jax.jit(lambda v, x, k: jm.apply(v, x, train=True, rngs={"dropout": k},
                                               mutable=["batch_stats", "intermediates"],
                                               capture_intermediates=True))
        (jy, jf), state = fwd(variables, jnp.asarray(x), jax.random.PRNGKey(7))
    finally:
        jax_backbone.BatchNorm, jimg.BatchNorm = real
    model = port_model(arch)
    from_jax_variables(variables, model)
    if arch == "resnet50b":
        inter = state["intermediates"]
        before = np.asarray(inter["bottleneck_bn"]["__call__"][0])
        dropped = np.asarray(inter["Dropout_0"]["__call__"][0])
        assert (before != 0).all()  # so the zeros after the dropout are its mask
        keep = torch.from_numpy(dropped != 0)
        assert 0 < int(keep.sum()) < keep.numel()

        class FlaxMask(torch.nn.Module):
            def forward(self, x):
                return torch.where(keep, x / 0.5, torch.zeros_like(x))

        model.bottleneck[3] = FlaxMask()
    with torch.no_grad():
        y, f = model.train()(torch.from_numpy(x))
    for got, want in ((y, jy), (f, jf)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    stats = {k: v for k, v in model.state_dict().items() if "running" in k}
    got_stats = {}
    for name, t in stats.items():
        path, collection, _ = torch_name_map(name, model)
        got_stats["/".join(path)] = t.numpy()
    want_stats = dict(_flat(state["batch_stats"]))
    assert got_stats.keys() == want_stats.keys()
    for name, want in want_stats.items():
        assert np.abs(got_stats[name] - want).max() <= 1e-5 * np.abs(want).max(), name


@pytest.mark.parametrize("arch", list(LAYERS))
def test_image_bridge_leaf_coverage(arch):
    """agrl_tpu's reverse export, with the port's state dict as template,
    fills every entry but `num_batches_tracked` with the bridged values
    (for resnet50b also but `bottleneck.0/.1`: agrl_tpu's temporal
    converter has no name for its bottleneck, which the port's bridge
    maps onto flax's bottleneck_fc and bottleneck_bn)."""
    _, variables, tmodel = _bridged(arch)
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    state, filled, kept = export_torch_state_dict(variables, sd, arch)
    for name in kept:
        assert name.endswith("num_batches_tracked") or (
            arch == "resnet50b" and name.startswith("bottleneck.")), name
    for name in filled:
        np.testing.assert_array_equal(state[name], sd[name], err_msg=name)
    leaves = dict(_flat(variables["params"]))
    if arch == "resnet50b":
        np.testing.assert_array_equal(sd["bottleneck.0.weight"],
                                      leaves["bottleneck_fc/kernel"].T)


def test_dropout_is_flax_s_and_seeded():
    """The port's own dropout: each entry kept (times 2 at p = 0.5) or 0,
    about half kept; the same generator seed, the same mask; eval is the
    identity."""
    x = torch.rand(64, 512) + 0.5
    a, b = Dropout(0.5, torch.Generator().manual_seed(3)), Dropout(0.5,
                                                                  torch.Generator().manual_seed(3))
    ya, yb = a(x), b(x)
    torch.testing.assert_close(ya, yb, atol=0, rtol=0)
    kept = ya != 0
    torch.testing.assert_close(ya[kept], 2 * x[kept], atol=0, rtol=0)
    assert 0.45 < float(kept.float().mean()) < 0.55
    assert a.eval()(x) is x


def _imagenet_cases():
    """(name, port model, agrl_tpu model, its input): the temporal, image,
    resnet50m and 3-D layouts at full ResNet-50 depth (the torchvision
    source's)."""
    clip = np.zeros((1, 2, 64, 32, 3), np.float32)
    img = np.zeros((1, 64, 32, 3), np.float32)
    yield "res50tp_legacy", ResNet50TPLegacy, jtmp.ResNet50TPLegacy, clip
    yield "resnet50", ResNetImage, jimg.ResNetImage, img
    yield "resnet50m", ResNet50M, jimg.ResNet50M, img
    yield "resnet3d50", ResNet3D, JResNet3D, clip


@pytest.mark.parametrize("case", list(_imagenet_cases()), ids=lambda c: c[0])
def test_imagenet_init_matches_agrl_tpu(case):
    """--pretrained-weights (tests/test_imagenet_init.py:155-235's contract):
    a torchvision ResNet-50 state dict (random values) fills the backbone
    as agrl_tpu's init_pretrained_weights fills its tree: the same number
    of leaves, each with agrl_tpu's value (resnet50m's layer4 blocks on
    layers5a/b/c); nothing of the source is skipped but the head; the 3-D
    ResNet takes nothing of it, in both packages."""
    from tests.test_imagenet_init import synth_resnet50_state_dict

    _, port_cls, jax_cls, x = case
    sd = synth_resnet50_state_dict(np.random.RandomState(0))
    jm = jax_cls(num_classes=NUM_CLASSES)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                                            train=True))
    variables = {c: jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes[c])
                 for c in ("params", "batch_stats")}
    new_vars, j_matched, _ = jax_init_pretrained(variables, sd)
    model = port_cls(NUM_CLASSES)
    matched, skipped = init_pretrained_weights(model, {k: torch.as_tensor(v)
                                                       for k, v in sd.items()})
    assert len(matched) == len(j_matched)
    if port_cls is ResNet3D:
        assert not matched and not j_matched
        return
    assert not skipped, skipped[:5]
    leaves = {(c,) + tuple(p.split("/")): v for c in ("params", "batch_stats")
              for p, v in _flat(new_vars[c])}
    state = model.state_dict()
    for name in matched:
        path, collection, kind = torch_name_map(name, model)
        want, _ = _gather(leaves, (collection,) + path, kind, tuple(state[name].shape))
        np.testing.assert_array_equal(state[name].numpy(), want, err_msg=name)
    if port_cls is ResNet50M:
        np.testing.assert_array_equal(model.layers5c.conv3.weight.detach().numpy(),
                                      sd["layer4.2.conv3.weight"])


@pytest.mark.parametrize("heads", [1, 3])
def test_accuracy_matches_agrl_tpu(heads):
    rng = np.random.RandomState(heads)
    target = rng.randint(0, 20, 32)
    logits = [rng.randn(32, 20).astype(np.float32) for _ in range(heads)]
    for k, v in enumerate(logits):  # some rows right at top-1
        v[np.arange(0, 32, k + 2), target[::k + 2]] += 10
    output = logits if heads > 1 else logits[0]
    got = accuracy(output, torch.from_numpy(target), topk=(1, 5))
    assert got == jax_accuracy(output, target, topk=(1, 5))
    assert len(got) == heads and all(0 < r[0] <= r[1] <= 1 for r in got)


def _pil(seed, h=48, w=24):
    return Image.fromarray(np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8))


def _pose_case():
    pose = {f"f{i}.jpg": np.random.RandomState(i).rand(18, 3) * [24, 48, 1] for i in range(4)}
    frames = np.random.RandomState(9).randint(0, 256, (4, 48, 24, 3), np.uint8)
    return pose, frames, [f"dir/f{i}.jpg" for i in range(4)], [(24, 48)] * 4


# class -> (constructor keywords, a function (instance, trial) -> its input)
TRANSFORMS = {
    "ToSpaceBGR": ({}, lambda t, i: np.random.RandomState(i).rand(3, 8, 4)),
    "ToRange255": ({}, lambda t, i: np.random.RandomState(i).rand(3, 8, 4)),
    "Random2DTranslation": (dict(height=32, width=16, p=0.5), lambda t, i: _pil(i)),
    "RectScale": (dict(height=32, width=16), lambda t, i: _pil(i, 48 - 16 * (i % 2), 24)),
    "ElasticTransform": (dict(alpha=50, sigma=4), lambda t, i: _pil(i, 24, 12)),
    "RandomErasing": (dict(probability=0.7), lambda t, i: np.random.RandomState(i).rand(3, 32,
                                                                                        16)),
    "MisAlignAugment": (dict(ratio=0.1), lambda t, i: np.random.RandomState(i).randint(
        0, 256, (40, 20, 3), np.uint8)),
    "RandomPoseAugmentation": (dict(radius=4, threshold=0.3, p=0.8), None),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_legacy_match_agrl_tpu(name):
    """Each class, built with the same keywords and a RandomState of the
    same seed in both packages, gives agrl_tpu's output on ten inputs in a
    row (the draws of each call follow agrl_tpu's)."""
    kw, make = TRANSFORMS[name]
    random = name not in ("ToSpaceBGR", "ToRange255", "RectScale")
    if random:
        kw = dict(kw, rng=np.random.RandomState(5))
    if name == "RandomPoseAugmentation":
        pose, frames, paths, sizes = _pose_case()
        kw.update(pose_info=pose, key_fn=lambda p: p.rsplit("/", 1)[-1])
        make = None
    ours = getattr(tl, name)(**kw)
    if random:
        kw = dict(kw, rng=np.random.RandomState(5))
    theirs = getattr(jtl, name)(**kw)
    changed = 0
    for i in range(10):
        args = (frames, paths, sizes) if make is None else (make(ours, i),)
        got, want = ours(*args), theirs(*args)
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape and np.array_equal(got, want), (name, i)
        changed += got.shape != np.asarray(args[0]).shape or not np.array_equal(
            got, np.asarray(args[0]))
    assert changed > 0, name  # the transform did something on these inputs
