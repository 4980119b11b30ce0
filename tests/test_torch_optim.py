"""The port's optimizers held against agrl_tpu's `init_optim` (optax):
10-step trajectories on shared gradients under schedules that change the
lr (a multistep drop at step 5; a linear warmup), coupled L2 on every name
but radam, radam's decoupled decay across its N_sma 4 / 5 branches (steps
1-10), and adabound's bounds with base_lr under the schedule.

The bar is rtol 1e-6 with atol 1e-7 (one to two ulps of a parameter under
1 in magnitude). The atol is for entries the trajectory carries near zero:
there a one-ulp difference of an earlier, larger value is any relative
error. adam and amsgrad (torch.optim.Adam) differ from optax by that much
and no more: optax takes 1 - b2^t in float32 (1.3e-5 relative error at
step 1), torch in float64. torch.optim.RMSprop, which applies the lr
after its momentum trace, misses the bar by ~1e6 across the lr drop.
Where float32 scalars decide it (radam's rectifier, adabound's bounds),
the updates themselves are held at rtol 1e-6 step by step
(`test_scalar_rules_match_agrl_tpu_update_by_update`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrl_torch.optim import init_optim, multistep_lr, per_step, warmup_multistep_lr
from agrl_torch.optim.optimizers import OPTIMIZER_NAMES, AdaBound, RAdam
from agrl_tpu import optim as jopt
from agrl_tpu.optim.optimizers import adabound as jax_adabound

LR, WD, STEPS = 1e-3, 5e-4, 10
RTOL, ATOL = 1e-6, 1e-7
SHAPES = {"conv": (8, 4, 3, 3), "bn": (8,), "fc": (10, 8)}


def _schedules(kind):
    """(port step -> lr, agrl_tpu step -> lr): a drop at step 5 (epochs of 5
    steps, milestone 1), or a linear warmup over 2 epochs of 3 steps."""
    if kind == "drop":
        return (per_step(multistep_lr(LR, [1]), 5),
                jopt.per_step(jopt.multistep_lr(LR, [1]), 5))
    return (per_step(warmup_multistep_lr(LR, [3], warmup_factor=0.01, warmup_iters=2), 3),
            jopt.per_step(jopt.warmup_multistep_lr(LR, [3], warmup_factor=0.01,
                                                   warmup_iters=2), 3))


def _problem(seed=0):
    rng = np.random.RandomState(seed)
    params = {k: np.clip(rng.randn(*s) * 0.3, -0.99, 0.99).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * 10.0 ** rng.randint(-6, -1, s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


def _trajectories(make_port, tx, lr_fn, params, grads):
    """Both trajectories: the port's optimizer with its groups' lr set to
    lr_fn(step) before each step (as the trainer does), optax's update."""
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_port(list(tparams.values()))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    got, want = [], []
    for step, g in enumerate(grads):
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        for group in opt.param_groups:
            group["lr"] = lr_fn(step)
        opt.step()
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        got.append({k: p.detach().numpy().copy() for k, p in tparams.items()})
        want.append({k: np.asarray(v) for k, v in jparams.items()})
    return opt, got, want


@pytest.mark.parametrize("schedule", ["drop", "warmup"])
@pytest.mark.parametrize("name", OPTIMIZER_NAMES)
def test_trajectory_matches_agrl_tpu(name, schedule):
    lr_fn, j_lr_fn = _schedules(schedule)
    params, grads = _problem()
    tx = jopt.init_optim(name, j_lr_fn, weight_decay=WD, base_lr=LR)
    _, got, want = _trajectories(
        lambda ps: init_optim(name, ps, LR, weight_decay=WD), tx, lr_fn, params, grads)
    for step, (g, w) in enumerate(zip(got, want), start=1):
        for k in SHAPES:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} {k} after step {step}")
    # the trajectory moved: a wrong rule would not hide under the bar
    assert max(np.abs(got[-1][k] - params[k]).max() for k in SHAPES) > 1e-4


def test_amsbound_matches_agrl_tpu():
    """AMSBound: agrl_tpu's adabound(amsbound=True) after its L2 chain."""
    lr_fn, j_lr_fn = _schedules("drop")
    params, grads = _problem(seed=1)
    import optax

    tx = optax.chain(jopt.optimizers._l2_weight_decay_schedule(lambda s: WD),
                     jax_adabound(j_lr_fn, base_lr=LR, final_lr=100 * LR, amsbound=True))
    opt, got, want = _trajectories(
        lambda ps: AdaBound(ps, lr=LR, base_lr=LR, final_lr=100 * LR, weight_decay=WD,
                            amsbound=True), tx, lr_fn, params, grads)
    for g, w in zip(got, want):
        for k in SHAPES:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL)
    assert all("max_exp_avg_sq" in s for s in opt.state.values())


@pytest.mark.parametrize("name", ["radam", "adabound"])
def test_scalar_rules_match_agrl_tpu_update_by_update(name):
    """Each step's update from parameters reset to zero (so the update is
    the parameter after the step, with no rounding of a larger value) and
    gradients of one sign (no moment near zero), without weight decay:
    the moments evolve alike, and the updates of steps 1-10 agree at rtol
    1e-6, across the lr drop at step 5. radam's rectifier in float64
    (1.8e-3 relative at step 6) or adabound's bounds in float64 miss it."""
    lr_fn, j_lr_fn = _schedules("drop")
    rng = np.random.RandomState(3)
    grads = [{k: (np.abs(rng.randn(*s)) + 0.5).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    tparams = {k: torch.nn.Parameter(torch.zeros(s)) for k, s in SHAPES.items()}
    opt = init_optim(name, list(tparams.values()), LR)
    tx = jopt.init_optim(name, j_lr_fn, base_lr=LR)
    zeros = {k: jnp.zeros(s) for k, s in SHAPES.items()}
    state = tx.init(zeros)
    for step, g in enumerate(grads, start=1):
        with torch.no_grad():
            for k, p in tparams.items():
                p.zero_()
                p.grad = torch.from_numpy(g[k])
        for group in opt.param_groups:
            group["lr"] = lr_fn(step - 1)
        opt.step()
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, zeros)
        for k in SHAPES:
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(updates[k]),
                                       rtol=RTOL, atol=0, err_msg=f"{name} {k} step {step}")


def test_radam_branches_and_float32_scalars():
    """Steps 1-4: SGD form (N_sma <= 4); step 5: N_sma = 4.986, the Adam
    form at the unrectified size (torch.optim.RAdam takes SGD there);
    from step 6 the rectified size, whose float32 value is agrl_tpu's."""
    forms = [RAdam.step_sizes(s, LR, 0.9, 0.999) for s in range(1, 11)]
    assert [f[0] for f in forms] == [False] * 4 + [True] * 6
    assert forms[4][1] == forms[4][2]  # step 5: unrectified
    assert all(f[1] < f[2] for f in forms[5:])
    # the rectifier in float32 (agrl_tpu) vs float64 differs at step 6
    b2, t = 0.999, 6
    n_max = 2 / (1 - b2) - 1
    n = n_max - 2 * t * b2**t / (1 - b2**t)
    rect64 = np.sqrt((1 - b2**t) * (n - 4) / (n_max - 4) * (n - 2) / n * n_max / (n_max - 2))
    rect32 = forms[5][1] / forms[5][2]
    assert abs(rect32 - rect64) / rect64 > 1e-4


def test_adabound_takes_base_lr_not_the_scheduled_lr():
    """Under a warmup the first scheduled lr is 1% of --lr; the bounds
    follow final_lr * lr / base_lr with base_lr = --lr, as agrl_tpu's CLI
    passes base_lr=args.lr."""
    opt = init_optim("adabound", [torch.nn.Parameter(torch.zeros(2))], LR)
    assert opt.param_groups[0]["base_lr"] == LR
    assert opt.param_groups[0]["final_lr"] == pytest.approx(100 * LR)


def test_frozen_parameters_stay_out_and_unknown_names_raise():
    frozen = torch.nn.Parameter(torch.zeros(3), requires_grad=False)
    live = torch.nn.Parameter(torch.zeros(3))
    for name in OPTIMIZER_NAMES:
        opt = init_optim(name, [frozen, live], LR)
        assert [p for g in opt.param_groups for p in g["params"]] == [live]
    with pytest.raises(KeyError):
        init_optim("lamb", [live], LR)
