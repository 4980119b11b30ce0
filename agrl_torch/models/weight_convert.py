"""Carry agrl_tpu weights into the port's modules.

`from_jax_variables(variables, model)` takes agrl_tpu's
{"params", "batch_stats"} tree (numpy arrays, as produced by
`jax.tree.map(np.asarray, variables)`) and loads it into a port model
whose submodules carry the reference GSTA names:

  * conv kernels: flax HWIO -> torch OIHW;
  * linear kernels: flax (in, out) -> torch (out, in);
  * BatchNorm: scale/bias (params) -> weight/bias, mean/var
    (batch_stats) -> running_mean/running_var.

The name map is a copy of the VMGN-family part of
agrl_tpu/models/weight_convert.py:_split_torch_name. Every state-dict
entry must find its leaf and every leaf must be used, except the
entries with no flax counterpart: `num_batches_tracked` and the BNNeck
biases, which are frozen at zero.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_BN_LEAF = {
    "weight": ("scale", "params"),
    "bias": ("bias", "params"),
    "running_mean": ("mean", "batch_stats"),
    "running_var": ("var", "batch_stats"),
}

# state-dict entries with no flax leaf
NO_COUNTERPART = ("num_batches_tracked", "bottleneck.bias")


def _bn(prefix: tuple, leaf: str):
    hit = _BN_LEAF.get(leaf)
    return None if hit is None else (prefix + (hit[0],), hit[1], None)


def torch_name_map(name: str):
    """Reference-style module path -> (flax path, collection, layout kind),
    or None for entries without a flax counterpart."""
    parts = re.sub(r"^module\.", "", name).split(".")
    if parts[0] == "conv1" and parts[1] == "weight":
        return ("trunk", "stem", "conv1", "kernel"), "params", "conv"
    if parts[0] == "bn1":
        return _bn(("trunk", "stem", "bn1"), parts[1])

    if re.match(r"^layer(\d)(_\d)?$", parts[0]):
        stage = parts[0]
        prefix = ("trunk", stage) if stage in ("layer1", "layer2", "layer3") else (stage,)
        prefix += (f"block{parts[1]}",)
        rest = parts[2:]
        if rest[0] in ("conv1", "conv2", "conv3") and rest[1] == "weight":
            return prefix + (rest[0], "kernel"), "params", "conv"
        if rest[0] in ("bn1", "bn2", "bn3"):
            return _bn(prefix + (rest[0],), rest[1])
        if rest[0] == "downsample":
            if rest[1] == "0" and rest[2] == "weight":
                return prefix + ("downsample_conv", "kernel"), "params", "conv"
            if rest[1] == "1":
                return _bn(prefix + ("downsample_bn",), rest[2])
        return None

    if parts[0] in ("global_bottleneck", "att_bottleneck"):
        if parts[1] == "bias":
            return None  # frozen at zero; flax BNNeck has no bias
        return _bn((parts[0], "bn"), parts[1])

    if parts[0] in ("global_classifier", "att_classifier"):
        if parts[1] == "weight":
            return (parts[0], "kernel"), "params", "linear"
        return None

    if parts[0] == "graph_layers":
        prefix = (f"graph_layer_{parts[1]}",)
        if parts[2] == "linear" and parts[3] == "weight":
            return prefix + ("linear", "kernel"), "params", "linear"
        if parts[2] == "bn":
            return _bn(prefix + ("bn",), parts[3])
    return None


def _to_torch_layout(arr: np.ndarray, kind) -> np.ndarray:
    if kind == "conv":
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if kind == "linear":
        return arr.T  # (in, out) -> (out, in)
    return arr


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax_variables(variables, model: torch.nn.Module) -> None:
    """Load agrl_tpu variables into `model` in place. Raises KeyError on a
    missing or unused leaf and ValueError on a shape mismatch."""
    extra_collections = set(variables) - {"params", "batch_stats"}
    if extra_collections:
        raise KeyError(f"unexpected variable collections: {sorted(extra_collections)}")
    leaves = {
        (collection,) + path: leaf
        for collection in ("params", "batch_stats")
        for path, leaf in _flatten(variables.get(collection, {}))
    }
    used = set()
    with torch.no_grad():
        for name, tensor in model.state_dict().items():
            mapped = torch_name_map(name)
            if mapped is None:
                if name.endswith(NO_COUNTERPART):
                    continue
                raise KeyError(f"{name} has no agrl_tpu counterpart")
            path, collection, kind = mapped
            key = (collection,) + path
            if key not in leaves:
                raise KeyError(f"{name}: variables lack {'/'.join(key)}")
            arr = _to_torch_layout(np.asarray(leaves[key], np.float32), kind).copy()
            if tuple(arr.shape) != tuple(tensor.shape):
                raise ValueError(f"{name}: shape {tuple(arr.shape)} != {tuple(tensor.shape)}")
            tensor.copy_(torch.from_numpy(arr))
            used.add(key)
    unused = sorted("/".join(k) for k in set(leaves) - used)
    if unused:
        raise KeyError(f"variables hold leaves the model has no entry for: {unused[:5]}")
