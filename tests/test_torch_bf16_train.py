"""The port's mixed-precision train step (--bf16-train) held against
agrl_tpu's, with VMGN built directly at dtype bfloat16 in both packages
(agrl_tpu's `vmgn_tiny` drops its dtype, so its own bf16 test compares
float32 with float32).

VMGN (1,1,1,1), one graph layer, the consistent loss (5 heads), 64x32
clips, S=6, a 2x2 P x K batch, Adam lr 1e-4 wd 5e-4: four steps from
agrl_tpu's initial weights with the same flips and consistent-loss
subclips in both packages (the flips read off agrl_tpu's keys, the
subclips injected by replacing `jax.random.permutation` while its step
is traced). Bar: agrl_tpu's own bf16-vs-fp32 bar, rtol = atol = 0.05
(tests/test_train_step.py:267).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrl_torch.engine.trainer import make_train_step
from agrl_torch.models.backbone import BatchNorm1d
from agrl_torch.models.vmgn import VMGN
from agrl_torch.models.weight_convert import from_jax_variables
from agrl_torch.optim import init_optim
from agrl_tpu.engine import create_train_state
from agrl_tpu.engine import make_train_step as jax_make_train_step
from agrl_tpu.models.vmgn import VMGN as JaxVMGN
from agrl_tpu.optim import init_optim as jax_init_optim
from tests.test_torch_train import PERMS, SUBCLIPS, _flip_decisions

torch.set_num_threads(2)

B, S, H, W, STEPS = 4, 6, 64, 32, 4
ARCH = dict(num_classes=2, layers=(1, 1, 1, 1), num_split=4, pyramid_part=True, num_gb=1,
            consistent_loss=True)


def _batch():
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (B, S, H, W, 3)).astype(np.uint8)
    V = S * 7
    adj = (np.random.RandomState(1).rand(B, V, V) > 0.5).astype(np.float32)
    return imgs, np.array([0, 0, 1, 1], np.int32), adj


@pytest.fixture(scope="module")
def jax_run():
    """agrl_tpu's bf16 model: its initial variables and four steps' losses
    with their flip decisions."""
    model = JaxVMGN(dtype=jnp.bfloat16, **ARCH)
    tx = jax_init_optim("adam", 1e-4, weight_decay=5e-4)
    state = create_train_state(model, tx, jax.random.PRNGKey(0), seq_len=S, height=H,
                               width=W, batch_size=2)
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    imgs, pids, adj = _batch()
    step = jax_make_train_step(model, tx, aug=dict(flip_aug=True), donate=False)
    perms, real = itertools.cycle(PERMS), jax.random.permutation
    jax.random.permutation = lambda key, n: jnp.asarray(next(perms))
    losses, flips = [], []
    try:
        for i in range(STEPS):  # traced on the first call: SUBCLIPS every step
            key = jax.random.PRNGKey(i)
            flips.append(_flip_decisions(jax.random.split(key)[1]))
            state, m = step(state, jnp.asarray(imgs), jnp.asarray(pids), jnp.asarray(adj), key)
            losses.append(float(m["loss"]))
    finally:
        jax.random.permutation = real
    return dict(variables=variables, losses=losses, flips=flips)


def _port_run(jax_run, dtype):
    model = VMGN(dtype=dtype, **ARCH)
    from_jax_variables(jax_run["variables"], model)
    opt = init_optim("adam", model.parameters(), 1e-4, weight_decay=5e-4)
    step = make_train_step(model, opt, lambda s: 1e-4, aug={"flip_aug": True})
    seen = {}

    def record(name):
        def hook(module, inputs, out):
            seen[name] = out.dtype
        return hook

    hooks = [getattr(model, name).register_forward_hook(record(name))
             for name in ("layer3", "layer4_1", "layer4_2", "att_bottleneck")]
    imgs, pids, adj = _batch()
    losses = [float(step(imgs, pids, adj, flip=jax_run["flips"][i],
                         subclip_indices=SUBCLIPS)["loss"]) for i in range(STEPS)]
    for h in hooks:
        h.remove()
    return dict(model=model, opt=opt, losses=losses, dtypes=seen)


@pytest.fixture(scope="module")
def port_runs(jax_run):
    return {dt: _port_run(jax_run, dt) for dt in (torch.float32, torch.bfloat16)}


def test_bf16_losses_are_finite_and_track_fp32_and_agrl_tpu(jax_run, port_runs):
    bf16, fp32 = port_runs[torch.bfloat16]["losses"], port_runs[torch.float32]["losses"]
    assert all(np.isfinite(v) for v in bf16 + fp32 + jax_run["losses"])
    np.testing.assert_allclose(bf16, fp32, rtol=0.05, atol=0.05)
    np.testing.assert_allclose(bf16, jax_run["losses"], rtol=0.05, atol=0.05)
    assert bf16 != fp32  # the trunk really ran in another precision


def test_bf16_trunk_with_float32_parameters_state_and_heads(port_runs):
    run = port_runs[torch.bfloat16]
    # the trunk and both layer4 branches compute in bf16, the heads in fp32
    assert run["dtypes"] == {"layer3": torch.bfloat16, "layer4_1": torch.bfloat16,
                             "layer4_2": torch.bfloat16, "att_bottleneck": torch.float32}
    assert port_runs[torch.float32]["dtypes"]["layer3"] == torch.float32
    model, opt = run["model"], run["opt"]
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32), name
    for name, b in model.named_buffers():
        if b.is_floating_point():
            assert b.dtype == torch.float32 and torch.isfinite(b).all(), name
    states = list(opt.state.values())
    assert states and all(s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32
                          for s in states)


def test_train_step_refuses_low_precision_parameters():
    model = VMGN(dtype=torch.bfloat16, **ARCH).to(torch.bfloat16)
    opt = init_optim("adam", model.parameters(), 1e-4)
    with pytest.raises(ValueError, match="float32 parameters"):
        make_train_step(model, opt, lambda s: 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_survives_constant_channels(dtype):
    """agrl_tpu's constant-channel guard (tests/test_models.py:176-200) for
    the port's BN, in fp32 and bf16 compute: a constant channel whose raw
    one-pass variance E[x^2] - E[x]^2 would come out below -eps gives
    finite outputs from batch statistics, a nonnegative running variance,
    and finite outputs from the running statistics."""
    x = torch.full((640, 4), 123.456)
    fast = (x * x).mean(0) - x.mean(0) ** 2
    assert float(fast.min()) < -1e-5  # the hazard is real on this input
    bn = BatchNorm1d(4)
    bn.compute_dtype = dtype
    y = bn.train()(x.to(dtype))
    assert y.dtype == dtype and torch.isfinite(y.float()).all()
    assert (bn.running_var >= 0).all() and bn.running_var.dtype == torch.float32
    y = bn.eval()(x.to(dtype))
    assert y.dtype == dtype and torch.isfinite(y.float()).all()
