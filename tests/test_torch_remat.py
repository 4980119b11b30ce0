"""`--remat dots|full` against `none` at vmgn_tiny with the consistent
loss (5 heads) and every augmentation on, on the CPU: agrl_tpu's own bar
(tests/test_train_step.py:272), updated parameters, Adam state, BN
running statistics and metrics bit-equal to the unremat step, and the
running statistics updated once per step (the recompute leaves them)."""

import copy

import numpy as np
import pytest
import torch

from agrl_torch.engine.trainer import REMAT_POLICIES, make_train_step
from agrl_torch.models import build_model, init_model
from agrl_torch.optim import init_optim

torch.set_num_threads(2)

S, H, W, B, NUM_CLASSES = 6, 64, 32, 4, 6
AUG = dict(flip_aug=True, rand_erase=True, misalign_aug=True, rand_translate=True)


@pytest.fixture(scope="module")
def steps():
    """Two steps of each policy from one model, on one batch, with the
    draws of one seeded generator."""
    rng = np.random.RandomState(0)
    base = rng.randint(0, 256, (B, 1, 1, 1, 3))
    imgs = np.clip(base + rng.randint(-40, 41, (B, S, H, W, 3)), 0, 255).astype(np.uint8)
    pids = np.array([0, 0, 1, 1])
    V = S * 7
    adj = ((rng.rand(B, V, V) > 0.5) + np.eye(V)).astype(np.float32)
    model0 = init_model("vmgn_tiny", num_classes=NUM_CLASSES, consistent_loss=True, seed=3,
                        device="cpu")
    out = {}
    for remat in REMAT_POLICIES:
        model = copy.deepcopy(model0)
        opt = init_optim("adam", model.parameters(), 1e-3, weight_decay=5e-4)
        step = make_train_step(model, opt, lambda s: 1e-3, aug=AUG, remat=remat)
        gen = torch.Generator().manual_seed(7)
        calls = []
        hook = model.conv1.register_forward_hook(lambda *a: calls.append(1))
        metrics = [step(imgs, pids, adj, generator=gen) for _ in range(2)]
        hook.remove()
        out[remat] = (model, opt, metrics, len(calls))
    return model0, out


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_step_is_bit_equal_to_none(steps, remat):
    _, out = steps
    model, opt, metrics, stem_calls = out[remat]
    ref_model, ref_opt, ref_metrics, ref_calls = out["none"]
    # the stem convolution ran again in each backward: the step recomputed
    assert (ref_calls, stem_calls) == (2, 4)
    for (name, got), want in zip(model.state_dict().items(), ref_model.state_dict().values()):
        assert torch.equal(got, want), name
    for got, want in zip(metrics, ref_metrics):
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for p, q in zip(opt.state.values(), ref_opt.state.values()):
        for k in q:
            assert torch.equal(p[k], q[k]), k


@pytest.mark.parametrize("remat", REMAT_POLICIES)
def test_running_stats_update_once_per_step(steps, remat):
    model0, out = steps
    model = out[remat][0]
    bns = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    # the attention BNNeck takes 4 calls a step (its head and 3 subclips)
    counts = {int(m.num_batches_tracked) for m in bns if m is not model.att_bottleneck}
    assert counts == {2}
    assert int(model.att_bottleneck.num_batches_tracked) == 8
    moved = [not torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                    model0.state_dict().values())]
    assert all(moved[i] for i, k in enumerate(model.state_dict()) if k.endswith("running_mean"))


def test_unknown_remat_policy_raises():
    model = build_model("vmgn_tiny", num_classes=NUM_CLASSES)
    opt = init_optim("adam", model.parameters(), 1e-3)
    with pytest.raises(ValueError):
        make_train_step(model, opt, lambda s: 1e-3, remat="offload")
