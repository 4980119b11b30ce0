"""One train step of each legacy video arch held against agrl_tpu's, and
the CLI over two of them.

res50tp_legacy, res50ta, res50rnn and resnet3d50 / resnet3dt (one module)
at depth (1,1,1,1) (the 3-D one at depth 10), 64x32 clips, S=4, a 2x2
P x K batch, with the bars of tests/test_torch_archs_train.py: agrl_tpu's
loss as its make_train_step computes it (cross-entropy without label
smoothing plus the soft-margin batch-hard triplet over the one head), its
gradients and its BN statistics after the step (agrl_tpu's BatchNorm in
its two-pass variance mode throughout, as tests/test_torch_train.py takes
its gradients: one jitted program an arch), against the port's make_train_step
on the same uint8 clips and flips. The port's gradients go through
agrl_tpu's own converters (convert_temporal_state_dict,
convert_resnet3d_state_dict); res50rnn's bias_ih_l0 is frozen and has no
gradient, so the converter, which sums the two torch biases, receives
bias_hh_l0's alone, and that is flax's h-side bias gradient.

Then one CPU epoch of `-a res50ta` and of `-a resnet3dt` through the CLI
on the synthetic layout, resnet3dt's evaluated again under `--test-sample
all`.
"""

import importlib
import io
import os.path as osp
import re
import shutil
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

import agrl_torch.cli.train_vidreid_xent_htri as tcli
from agrl_torch.engine.trainer import make_train_step
from agrl_torch.models.weight_convert import from_jax_variables
from agrl_torch.optim import init_optim
from agrl_tpu import losses as jl
from agrl_tpu.data.transforms import preprocess_clips as jax_preprocess
from agrl_tpu.models import backbone as jax_backbone
from agrl_tpu.models.weight_convert import (
    convert_resnet3d_state_dict,
    convert_temporal_state_dict,
)
from tests.test_torch_archs_train import _flip_decisions
from tests.test_torch_legacy import H, S, W, init_variables, jax_model, port_model
from tests.test_torch_train import _flat

torch.set_num_threads(2)

B = 4
ARCHS = ("res50tp_legacy", "res50ta", "res50rnn", "resnet3d50", "resnet3dt")
jax_3d = importlib.import_module("agrl_tpu.models.resnet3d")


def _convert(arch, tree):
    return (convert_resnet3d_state_dict if arch.startswith("resnet3d")
            else convert_temporal_state_dict)(tree)[0]


_STEPS = {}


@pytest.fixture(scope="module", params=ARCHS)
def step(request):
    """agrl_tpu's loss, gradients and mutated batch_stats, and the port's
    make_train_step on the same batch (resnet3dt's are resnet3d50's: the
    same module in both packages)."""
    arch = "resnet3d50" if request.param == "resnet3dt" else request.param
    if arch in _STEPS:
        return _STEPS[arch]
    rng = np.random.RandomState(5)
    base = rng.randint(0, 256, (B, 1, 1, 1, 3))
    imgs = np.clip(base + rng.randint(-40, 41, (B, S, H, W, 3)), 0, 255).astype(np.uint8)
    pids = np.array([0, 0, 1, 1], np.int32)
    variables = init_variables(jax_model(arch), imgs[:2].astype(np.float32))
    key = next(k for k in map(jax.random.PRNGKey, range(100))
               if 0 < _flip_decisions(k).sum() < B)
    x = jax_preprocess(jnp.asarray(imgs), key, train=True, flip_aug=True)
    xent_fn = partial(jl.cross_entropy_label_smooth, epsilon=0.0)
    htri_fn = partial(jl.batch_hard_triplet, margin=0.3, soft=True)

    def loss_fn(params, batch_stats, jmodel):
        (y, f), mutated = jmodel.apply({"params": params, "batch_stats": batch_stats}, x,
                                       train=True, mutable=["batch_stats"])
        xent = jl.deep_supervision(xent_fn, [y], jnp.asarray(pids))
        htri = jl.deep_supervision(htri_fn, [f], jnp.asarray(pids))
        return xent + htri, (mutated["batch_stats"], xent, htri)

    real = jax_backbone.BatchNorm, jax_3d.BatchNorm
    jax_backbone.BatchNorm = jax_3d.BatchNorm = partial(
        flax_nn.BatchNorm, momentum=0.9, epsilon=1e-5, use_fast_variance=False)
    try:
        (loss, (stats, xent, htri)), grads = jax.jit(jax.value_and_grad(
            partial(loss_fn, jmodel=jax_model(arch)), has_aux=True))(
                variables["params"], variables["batch_stats"])
    finally:
        jax_backbone.BatchNorm, jax_3d.BatchNorm = real

    model = port_model(arch)
    from_jax_variables(variables, model)
    opt = init_optim("adam", model.parameters(), 1e-4, weight_decay=5e-4)
    train_step = make_train_step(model, opt, lambda s: 1e-4, label_smooth=False,
                                 aug={"flip_aug": True})
    metrics = train_step(imgs, pids, np.ones((B, S, S), np.float32), flip=_flip_decisions(key))
    _STEPS[arch] = dict(arch=arch, loss=float(loss), xent=float(xent), htri=float(htri),
                        grads=dict(_flat(grads)), stats=dict(_flat(stats)), model=model,
                        metrics=metrics)
    return _STEPS[arch]


def test_step_losses_match_jax(step):
    m = step["metrics"]
    for name, got in (("loss", m["loss"]), ("xent", m["xent_loss"]), ("htri", m["htri_loss"])):
        np.testing.assert_allclose(float(got), step[name], rtol=1e-5, err_msg=name)


def test_step_gradients_match_jax(step):
    """Every gradient leaf, with tests/test_torch_train.py's bars:
    Frobenius within 1e-2 and the largest entry within 5e-2 of the leaf's
    largest. res50rnn's gate kernels and h-side biases among them;
    bias_ih_l0 takes none. res50ta's attention_tconv bias shifts every
    frame's score alike, which the softmax over frames ignores while no
    score is clipped by the ReLU before it (so here): its gradient is 0 up
    to rounding (~5e-7 against the kernel's 3) in both frameworks."""
    model = step["model"]
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    if step["arch"] == "res50rnn":
        assert "lstm.bias_ih_l0" not in grads and model.lstm.bias_ih_l0.grad is None
    mapped = dict(_flat(_convert(step["arch"], grads)["params"]))
    assert mapped.keys() == step["grads"].keys()
    for name, want in step["grads"].items():
        got = mapped[name]
        assert got.shape == want.shape, name
        if name == "attention_tconv/bias":
            ref = np.abs(step["grads"]["attention_tconv/kernel"]).max()
            assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-5 * ref, name
            continue
        fro = np.linalg.norm(got - want) / np.linalg.norm(want)
        worst = np.abs(got - want).max() / np.abs(want).max()
        assert fro <= 1e-2 and worst <= 5e-2, (name, fro, worst)


def test_step_batch_stats_match_jax(step):
    """The running statistics after the step, flax's rule (BatchNorm3d's
    too), within 1e-5 of max per leaf."""
    model = step["model"]
    state = {k: v for k, v in model.state_dict().items() if "running" in k}
    got = dict(_flat(_convert(step["arch"], state)["batch_stats"]))
    assert got.keys() == step["stats"].keys()
    for name, want in step["stats"].items():
        assert np.abs(got[name] - want).max() <= 1e-5 * np.abs(want).max(), name


METER = re.compile(r"^CurTime: .*\tXent (\S+) \(\S+\)\tHtri (\S+) \(\S+\)\t")


def _run_cli(argv):
    buf, stdout = io.StringIO(), sys.stdout
    sys.stdout = buf
    try:
        result = tcli.main(argv)
    finally:
        sys.stdout = stdout
    return result, buf.getvalue()


@pytest.mark.parametrize("arch", ["res50ta", "resnet3dt"])
def test_cli_trains_and_evaluates(arch, tmp_path):
    """Full ResNet-50 depth (resnet3dt: the 3-D ResNet-50) on the CPU,
    64x32, seq_len 4: the pre-flight passes the arch (also for the card),
    an epoch of 4 steps with finite meter lines, an evenly evaluation and a
    checkpoint, the FLOPs line; then, for resnet3dt, --evaluate --resume
    best_model under --test-sample all (whole tracklets, unpadded; res50ta's
    is held in tests/test_torch_legacy.py)."""
    save_dir = str(tmp_path / "log")
    base = ["--use-cpu", "--root", str(tmp_path / "data"), "-d", "synthetic", "-a", arch,
            "--height", "64", "--width", "32", "--seq-len", "4", "--train-batch", "4",
            "--num-instances", "2", "--train-sampler", "RandomIdentitySamplerV1",
            "--test-batch", "8", "--flip-aug", "--soft-margin", "--save-dir", save_dir,
            "-j", "2", "--seed", "1"]
    tcli.preflight(tcli.build_parser().parse_args(base[1:] + ["--test-sample", "evenly"]))
    try:
        result, out = _run_cli(base + ["--test-sample", "evenly", "--max-epoch", "1",
                                       "--eval-step", "1", "--print-freq", "1"])
        assert result is None
        meters = [METER.match(line) for line in out.splitlines() if line.startswith("CurTime")]
        assert len(meters) == 4 and all(m is not None for m in meters)
        assert all(np.isfinite(float(v)) for m in meters for v in m.groups())
        assert "Model complexity: params" in out and "obtained 24-by-2048 matrix" in out
        if arch == "res50ta":
            return
        rank1, mAP = _run_cli(base + ["--test-sample", "all", "--evaluate", "--resume",
                                      osp.join(save_dir, "best_model.pth.tar")])[0]
        assert 0.0 <= mAP <= 1.0 and 0.0 <= rank1 <= 1.0
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)  # checkpoints with Adam's state
