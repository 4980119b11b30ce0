"""Resume an agrl_tpu run: fill a port optimizer from agrl_tpu's optax
state (its checkpoint's `opt_state`, read by core/flax_msgpack.py).

agrl_tpu's `init_optim` chains its coupled L2 (state {count}) before the
core transform, except for radam; `flax.serialization.to_state_dict`
names a chain's members '0', '1', ... and a state's fields by name:

  | optim        | opt_state                                         | port state                                     |
  |--------------|---------------------------------------------------|------------------------------------------------|
  | adam         | {0: {count}, 1: {0: {count, mu, nu}, 1: {count}}} | step, exp_avg, exp_avg_sq                      |
  | amsgrad      | {0: {count}, 1: {count, m, v, vmax}}              | step, exp_avg, exp_avg_sq, max_exp_avg_sq      |
  | sgd/nesterov | {0: {count}, 1: {0: {trace}, 1: {count}}}         | momentum_buffer                                |
  | rmsprop      | {0: {count}, 1: {0: {nu}, 1: {count}, 2: {trace}}}| step, square_avg, momentum_buffer              |
  | adabound     | {0: {count}, 1: {count, exp_avg, exp_avg_sq}}     | step, exp_avg, exp_avg_sq                      |
  | radam        | {count, exp_avg, exp_avg_sq}                      | step, exp_avg, exp_avg_sq                      |

Each moment tree has the params' flax paths and takes the weights' name
map and layout change (models/weight_convert.py: HWIO -> OIHW, Dense
kernels transposed). optax's `count` is the number of updates taken: it
is the port's step (each state's `step`, and the schedule position the
trainer starts from), since optax reads lr(count).
"""

from __future__ import annotations

import numpy as np
import torch

# optim -> (path to the node holding the moments, {port state name: field},
# path to the count optax's schedule reads)
_LAYOUT = {
    "adam": (("1", "0"), {"exp_avg": "mu", "exp_avg_sq": "nu"}, ("1", "0", "count")),
    "amsgrad": (("1",), {"exp_avg": "m", "exp_avg_sq": "v", "max_exp_avg_sq": "vmax"},
                ("1", "count")),
    "sgd": (("1", "0"), {"momentum_buffer": "trace"}, ("1", "1", "count")),
    "nesterov": (("1", "0"), {"momentum_buffer": "trace"}, ("1", "1", "count")),
    "rmsprop": (("1",), {"square_avg": ("0", "nu"), "momentum_buffer": ("2", "trace")},
                ("1", "1", "count")),
    "adabound": (("1",), {"exp_avg": "exp_avg", "exp_avg_sq": "exp_avg_sq"}, ("1", "count")),
    "radam": ((), {"exp_avg": "exp_avg", "exp_avg_sq": "exp_avg_sq"}, ("count",)),
}
# torch.optim.SGD keeps no step count of its own
_NO_STEP = ("sgd", "nesterov")


def _at(tree, path, what: str):
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            raise ValueError(f"opt_state has no {'/'.join(path)} ({what}): not the layout "
                             "agrl_tpu's init_optim gives this optimizer")
        tree = tree[key]
    return tree


def load_optax_state(optimizer: torch.optim.Optimizer, model: torch.nn.Module, opt_state,
                     optim: str) -> int:
    """Fill `optimizer` (init_optim(optim, model.parameters(), ...)) from
    agrl_tpu's `opt_state` tree (nested dicts of numpy arrays) for the
    same optimizer and model. Every trainable parameter must find its
    moments and every moment leaf must be used. Returns optax's count."""
    from agrl_torch.models.weight_convert import _flatten, _gather, torch_name_map

    if optim not in _LAYOUT:
        raise KeyError(f"Unsupported optimizer: {optim}. Choices: {tuple(_LAYOUT)}")
    node_path, fields, count_path = _LAYOUT[optim]
    node = _at(opt_state, node_path, "the moments")
    count = int(np.asarray(_at(opt_state, count_path, "the update count")))
    trees = {name: _at(node, field if isinstance(field, tuple) else (field,), name)
             for name, field in fields.items()}
    leaves = {name: dict(_flatten(tree)) for name, tree in trees.items()}
    held = {id(p) for group in optimizer.param_groups for p in group["params"]}
    used = set()
    for pname, p in model.named_parameters():
        if id(p) not in held:
            continue
        mapped = torch_name_map(pname, model)
        if mapped is None or mapped[1] != "params":
            raise KeyError(f"{pname} has no agrl_tpu parameter to take its moments from")
        path, _, kind = mapped
        state = {}
        for name, flat in leaves.items():
            try:
                arr, keys = _gather(flat, path, kind, tuple(p.shape))
            except KeyError as e:
                raise KeyError(f"{pname}: opt_state lacks {name} at {'/'.join(e.args[0])}") \
                    from None
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{pname}: {name} shape {tuple(arr.shape)} != {tuple(p.shape)}")
            state[name] = torch.from_numpy(arr.copy()).to(p.device, p.dtype)
            used.update(keys)
        if optim not in _NO_STEP:
            # torch.optim.Adam keeps a float32 0-d tensor; the port's classes an int
            state["step"] = (torch.tensor(float(count), dtype=torch.float32)
                             if isinstance(optimizer, torch.optim.Adam) else count)
        optimizer.state[p] = state
    unused = sorted("/".join(k) for flat in leaves.values() for k in set(flat) - used)
    if unused:
        raise KeyError(f"opt_state holds moments the model has no parameter for: {unused[:5]}")
    return count
