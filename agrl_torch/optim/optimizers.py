"""Optimizers (counterpart of agrl_tpu/optim/optimizers.py).

The reference's table (torchreid/optimizers.py:7-23) names adam, amsgrad,
sgd, nesterov, rmsprop, adabound and radam; `init_optim` builds each as
agrl_tpu builds it from optax:

  * every name but radam takes agrl_tpu's coupled L2 first
    (`_l2_weight_decay_schedule`: grad += wd * param), which is what
    torch's `weight_decay` argument does in Adam and SGD, and what the
    port's own classes below do;
  * adam — optax.adam (b1 0.9, b2 0.999, eps 1e-8 outside the square
    root): torch.optim.Adam;
  * amsgrad — agrl_tpu's `amsgrad_torch` (the running max over the raw
    second moment): torch.optim.Adam(amsgrad=True);
  * sgd / nesterov — optax.sgd: trace(0.9) then lr, which is
    torch.optim.SGD with momentum 0.9 and dampening 0;
  * rmsprop — optax.rmsprop(decay 0.99, eps 1e-8 outside the square root,
    momentum 0.9) multiplies by lr BEFORE its momentum trace, so the trace
    carries each step's own lr; torch.optim.RMSprop multiplies the buffer
    by the current lr after it. They part at any lr change (warmup, a
    milestone), hence `RMSprop` below;
  * adabound — agrl_tpu's `adabound` (final_lr = 100 * base_lr): `AdaBound`
    below, whose `amsbound=True` is the AMSBound variant;
  * radam — agrl_tpu's `radam`, with its own decoupled decay
    (p -= wd * lr * p) and no L2: `RAdam` below, not torch.optim.RAdam
    (agrl_tpu switches the update form at N_sma > 4 and the step size at
    N_sma > 5, so step 5 takes an Adam-form step at the unrectified size;
    torch takes an SGD step there).

agrl_tpu computes the scalars of a step (t, b**t, N_sma, the rectifier,
AdaBound's bounds, the lr itself) in float32; the port's classes compute
them in NumPy float32 in the same order (in float64, RAdam's rectifier
of step 6 differs by 1.8e-3 relative). optax reads lr(count) before it
counts the step; the trainer sets each group's "lr" to lr_fn(step)
before `step()` to match, and the CLI sets "weight_decay" per epoch.
The state names are the ones `agrl_torch.core.optax_state` fills when a
run resumes from an agrl_tpu checkpoint.
"""

from __future__ import annotations

import numpy as np
import torch

OPTIMIZER_NAMES = ("adam", "amsgrad", "sgd", "nesterov", "rmsprop", "adabound", "radam")

f32 = np.float32


def init_optim(optim: str, params, lr: float, weight_decay: float = 0.0):
    """Build an optimizer by name over the parameters that require a
    gradient (the BNNecks' frozen biases stay out, as flax's BNNeck has
    none). `lr` is the pre-schedule lr (`--lr`): the trainer sets each
    group's "lr" per step, and adabound's bounds scale by lr / `lr`."""
    if optim not in OPTIMIZER_NAMES:
        raise KeyError(f"Unsupported optimizer: {optim}. Choices: {OPTIMIZER_NAMES}")
    trainable = [p for p in params if p.requires_grad]
    if optim in ("adam", "amsgrad"):
        return torch.optim.Adam(trainable, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay, amsgrad=optim == "amsgrad")
    if optim in ("sgd", "nesterov"):
        return torch.optim.SGD(trainable, lr=lr, momentum=0.9, dampening=0.0,
                               weight_decay=weight_decay, nesterov=optim == "nesterov")
    if optim == "rmsprop":
        return RMSprop(trainable, lr=lr, alpha=0.99, eps=1e-8, momentum=0.9,
                       weight_decay=weight_decay)
    if optim == "adabound":
        # the reference wires final_lr = 100 * lr (optimizers.py:19)
        return AdaBound(trainable, lr=lr, base_lr=lr, final_lr=100.0 * lr,
                        weight_decay=weight_decay)
    return RAdam(trainable, lr=lr, weight_decay=weight_decay)


def _l2(params, grads, wd: float):
    """grad + wd * param per tensor, two roundings as agrl_tpu's chain
    computes it."""
    return grads if wd == 0 else torch._foreach_add(grads, torch._foreach_mul(params, wd))


def _ema(bufs, decay: float, xs) -> None:
    """buf = decay * buf + (1 - decay) * x in place, per tensor."""
    torch._foreach_mul_(bufs, decay)
    torch._foreach_add_(bufs, torch._foreach_mul(xs, 1.0 - decay))


def _squares(xs):
    return torch._foreach_mul(xs, xs)


def _rsqrt_eps(vs, eps: float):
    """1 / (sqrt(v) + eps) per tensor (what `1.0 / t` computes in torch:
    the reciprocal)."""
    d = torch._foreach_sqrt(vs)
    torch._foreach_add_(d, eps)
    torch._foreach_reciprocal_(d)
    return d


class _Foreach(torch.optim.Optimizer):
    """The three classes below step a group's tensors together with
    torch._foreach_* (a few launches per group, not per tensor), each
    elementwise op in agrl_tpu's order. Tensors are batched by their step
    count, which a resume sets to optax's count for all of them."""

    def _batches(self, group, names):
        """{step: (params, grads, {name: state tensors})} over the group's
        tensors with a gradient, their state made on first use and their
        step counted."""
        out = {}
        for p in group["params"]:
            if p.grad is None:
                continue
            state = self.state[p]
            if not state:
                state["step"] = 0
                for name in names:
                    state[name] = torch.zeros_like(p)
            state["step"] += 1
            ps, gs, st = out.setdefault(state["step"], ([], [], {n: [] for n in names}))
            ps.append(p)
            gs.append(p.grad)
            for name in names:
                st[name].append(state[name])
        return out


class RMSprop(_Foreach):
    """optax.rmsprop after the coupled L2, in optax's order:

        g  = grad + wd * p
        nu = alpha * nu + (1 - alpha) * g^2          (`square_avg`)
        u  = -lr * g / (sqrt(nu) + eps)
        t  = u + momentum * t                         (`momentum_buffer`)
        p += t
    """

    def __init__(self, params, lr: float, alpha: float = 0.99, eps: float = 1e-8,
                 momentum: float = 0.9, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps, momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            lr, alpha, eps = group["lr"], group["alpha"], group["eps"]
            for ps, grads, st in self._batches(group, ("square_avg", "momentum_buffer")).values():
                g = _l2(ps, grads, group["weight_decay"])
                nu, buf = st["square_avg"], st["momentum_buffer"]
                _ema(nu, alpha, _squares(g))
                u = _rsqrt_eps(nu, eps)
                torch._foreach_mul_(u, g)
                torch._foreach_mul_(u, float(-f32(lr)))
                torch._foreach_mul_(buf, group["momentum"])
                torch._foreach_add_(buf, u)
                torch._foreach_add_(ps, buf)
        return loss


class AdaBound(_Foreach):
    """agrl_tpu's adabound after the coupled L2 (reference
    torchreid/optimizers.py:26-138): Adam's moments, the per-element rate
    step_size / (sqrt(v) + eps) clipped into bounds that close on
    final_lr * lr / base_lr. `amsbound` takes the running max of v."""

    def __init__(self, params, lr: float, base_lr: float, final_lr: float = 0.1,
                 betas=(0.9, 0.999), gamma: float = 1e-3, eps: float = 1e-8,
                 weight_decay: float = 0.0, amsbound: bool = False):
        super().__init__(params, dict(lr=lr, base_lr=base_lr, final_lr=final_lr, betas=betas,
                                      gamma=gamma, eps=eps, weight_decay=weight_decay,
                                      amsbound=amsbound))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr = f32(group["lr"])
            names = ("exp_avg", "exp_avg_sq") + (("max_exp_avg_sq",) if group["amsbound"] else ())
            for step, (ps, grads, st) in self._batches(group, names).items():
                g = _l2(ps, grads, group["weight_decay"])
                m, v = st["exp_avg"], st["exp_avg_sq"]
                _ema(m, b1, g)
                _ema(v, b2, _squares(g))
                if group["amsbound"]:
                    torch._foreach_maximum_(st["max_exp_avg_sq"], v)
                    v = st["max_exp_avg_sq"]
                t = f32(step)
                bias1 = f32(1) - f32(b1) ** t
                bias2 = f32(1) - f32(b2) ** t
                step_size = lr * np.sqrt(bias2) / bias1
                flr = f32(group["final_lr"]) * lr / f32(group["base_lr"])
                gt = f32(group["gamma"]) * t
                lower = flr * (f32(1) - f32(1) / (gt + f32(1)))
                upper = flr * (f32(1) + f32(1) / gt)
                rate = _rsqrt_eps(v, group["eps"])
                torch._foreach_mul_(rate, float(step_size))
                torch._foreach_clamp_min_(rate, float(lower))
                torch._foreach_clamp_max_(rate, float(upper))
                torch._foreach_mul_(rate, m)
                torch._foreach_sub_(ps, rate)
        return loss


class RAdam(_Foreach):
    """agrl_tpu's radam (reference torchreid/optimizers.py:141-211):
    rectified Adam with decoupled weight decay p -= wd * lr * p, an
    Adam-form step where N_sma > 4 (else SGD with momentum, unrectified),
    the rectified step size where N_sma > 5. Scalars in float32."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @staticmethod
    def step_sizes(step: int, lr: float, b1: float, b2: float):
        """(adam form?, Adam-form step size, SGD-form step size) of step
        `step` (1-based), float32 in agrl_tpu's order."""
        t = f32(step)
        lr = f32(lr)
        beta2_t = f32(b2) ** t
        n_max = 2.0 / (1 - b2) - 1.0  # a Python float in agrl_tpu too
        n_sma = f32(n_max) - f32(2) * t * beta2_t / (f32(1) - beta2_t)
        step_plain = lr / (f32(1) - f32(b1) ** t)
        if n_sma > f32(5):
            rect = np.sqrt(
                (f32(1) - beta2_t) * (n_sma - f32(4)) / f32(n_max - 4) * (n_sma - f32(2))
                / n_sma * f32(n_max) / f32(n_max - 2)
            )
            step_size = lr * rect / (f32(1) - f32(b1) ** t)
        else:
            step_size = step_plain
        return bool(n_sma > f32(4)), float(step_size), float(step_plain)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            decay = float(f32(group["weight_decay"]) * f32(group["lr"]))
            for step, (ps, g, st) in self._batches(group, ("exp_avg", "exp_avg_sq")).items():
                m, v = st["exp_avg"], st["exp_avg_sq"]
                _ema(m, b1, g)
                _ema(v, b2, _squares(g))
                adam, step_size, step_plain = self.step_sizes(step, group["lr"], b1, b2)
                if adam:
                    u = torch._foreach_mul(m, -step_size)
                    d = torch._foreach_sqrt(v)
                    torch._foreach_add_(d, group["eps"])
                    torch._foreach_div_(u, d)
                else:
                    u = torch._foreach_mul(m, -step_plain)
                if decay:
                    torch._foreach_sub_(u, torch._foreach_mul(ps, decay))
                torch._foreach_add_(ps, u)
        return loss
