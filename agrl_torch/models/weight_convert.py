"""Carry agrl_tpu weights into the port's modules.

`from_jax_variables(variables, model)` takes agrl_tpu's
{"params", "batch_stats"} tree (numpy arrays, as produced by
`jax.tree.map(np.asarray, variables)`) and loads it into a port model
whose submodules carry the reference GSTA names:

  * conv kernels: flax HWIO -> torch OIHW;
  * linear kernels: flax (in, out) -> torch (out, in);
  * BatchNorm: scale/bias (params) -> weight/bias, mean/var
    (batch_stats) -> running_mean/running_var.

The name map is a copy of the part of
agrl_tpu/models/weight_convert.py:_split_torch_name the ported archs use
(vmgn, gsta, ganet, sta, simple_sta, res50tp, resnet50_s1): the trunk,
`layer4` or `layer4_1`/`layer4_2`, the BNNecks, the classifiers (sta's
with a bias), the graph layers, ganet's `pam_layer` and sta's `fc1`;
and of its `_graphnet_name_map` for msppn and msppgn, whose names depend
on the arch (the model's `name_scheme`): their fusion Conv1d is torch's
(1, V, 1) and flax's (V, 1).
Every state-dict entry must find its leaf and every leaf must be used,
except the entries with no flax counterpart: `num_batches_tracked` and
the BNNeck biases, which are frozen at zero. `partial=True` gives `--load-weights`
semantics instead (agrl_tpu core/checkpoint.py:shape_filtered_merge).

`init_pretrained_weights` loads a torchvision-style ImageNet ResNet
state dict into the backbone (`--pretrained-weights`).
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


def torch_name_map(name: str, model=None):
    """Reference-style module path -> (flax path, collection, layout kind),
    or None for entries without a flax counterpart. msppn and msppgn name
    their modules their own way (their `name_scheme`), so their entries
    map through `model`."""
    scheme = getattr(model, "name_scheme", None)
    if scheme is not None:
        return _graphnet_name_map(re.sub(r"^module\.", "", name), scheme, model.num_vertices)
    parts = re.sub(r"^module\.", "", name).split(".")
    if parts[0] == "conv1" and parts[1] == "weight":
        return ("trunk", "stem", "conv1", "kernel"), "params", "conv"
    if parts[0] == "bn1":
        return _bn(("trunk", "stem", "bn1"), parts[1])

    if re.match(r"^layer(\d)(_\d)?$", parts[0]):
        stage = parts[0]
        prefix = ("trunk", stage) if stage in ("layer1", "layer2", "layer3") else (stage,)
        return _res_block(prefix, parts[1:])

    if parts[0] in ("global_bottleneck", "att_bottleneck", "bottleneck"):
        if parts[1] == "bias":
            return None  # frozen at zero; flax BNNeck has no bias
        return _bn((parts[0], "bn"), parts[1])

    if parts[0] in ("global_classifier", "att_classifier", "classifier"):
        if parts[1] == "weight":
            return (parts[0], "kernel"), "params", "linear"
        if parts[1] == "bias":
            return (parts[0], "bias"), "params", None
        return None

    # ganet's PAM: 1x1 convs with bias and the gamma scalar
    if parts[0] == "pam_layer":
        if parts[1] == "gamma":
            return ("pam_layer", "gamma"), "params", None
        if parts[1] in ("query_conv", "key_conv", "value_conv"):
            if parts[2] == "weight":
                return ("pam_layer", parts[1], "kernel"), "params", "conv"
            return ("pam_layer", parts[1], "bias"), "params", None

    # sta's fc1 = Sequential(Linear(bias=False), BatchNorm1d, ReLU) -> fc1 + fc1_bn
    if parts[0] == "fc1":
        if parts[1] == "0" and parts[2] == "weight":
            return ("fc1", "kernel"), "params", "linear"
        if parts[1] == "1":
            return _bn(("fc1_bn",), parts[2])

    if parts[0] == "graph_layers":
        prefix = (f"graph_layer_{parts[1]}",)
        if parts[2] == "linear" and parts[3] == "weight":
            return prefix + ("linear", "kernel"), "params", "linear"
        if parts[2] == "bn":
            return _bn(prefix + ("bn",), parts[3])
    return None


def _res_block(prefix: tuple, rest: list):
    """layerX.N.{convK,bnK,downsample...} under `prefix` -> flax paths."""
    prefix += (f"block{rest[0]}",)
    if rest[1] in ("conv1", "conv2", "conv3") and rest[2] == "weight":
        return prefix + (rest[1], "kernel"), "params", "conv"
    if rest[1] in ("bn1", "bn2", "bn3"):
        return _bn(prefix + (rest[1],), rest[2])
    if rest[1] == "downsample":
        if rest[2] == "0" and rest[3] == "weight":
            return prefix + ("downsample_conv", "kernel"), "params", "conv"
        if rest[2] == "1":
            return _bn(prefix + ("downsample_bn",), rest[3])
    return None


def _graphnet_name_map(name: str, scheme: str, n_cls: int):
    """msppn/msppgn entry -> (flax path, collection, layout kind), or None;
    a copy of agrl_tpu/models/weight_convert.py:_graphnet_name_map. `n_cls`
    is the fused classifier's index, the highest; the whole trunk, layer4
    too, lives under flax's `trunk`."""
    parts = name.split(".")
    if scheme == "msppn":
        if parts[0] == "conv1" and parts[1] == "weight":
            return ("trunk", "stem", "conv1", "kernel"), "params", "conv"
        if parts[0] == "bn1":
            return _bn(("trunk", "stem", "bn1"), parts[1])
        if re.match(r"^layer\d$", parts[0]):
            return _res_block(("trunk", parts[0]), parts[1:])
    elif parts[0] == "base":  # msppgn: Sequential(conv1, bn1, relu, maxpool, layer1..4)
        if parts[1] == "0" and parts[2] == "weight":
            return ("trunk", "stem", "conv1", "kernel"), "params", "conv"
        if parts[1] == "1":
            return _bn(("trunk", "stem", "bn1"), parts[2])
        if parts[1] in ("4", "5", "6", "7"):
            return _res_block(("trunk", f"layer{int(parts[1]) - 3}"), parts[2:])
        return None
    reduce_re, bn_re = (r"^reduce_f(\d)$", r"^bn_f(\d)$") if scheme == "msppn" else (
        r"^reduce(\d)$", r"^bn(\d)$")
    m = re.match(reduce_re, parts[0])
    if m:
        leaf = ("kernel", "linear") if parts[1] == "weight" else ("bias", None)
        return (f"reduce_f{m.group(1)}", "reduce", leaf[0]), "params", leaf[1]
    m = re.match(bn_re, parts[0])
    if m:
        return _bn((f"reduce_f{m.group(1)}", "bn"), parts[1])
    if parts[0] == "gbs":
        prefix, sub = (f"gb_{parts[1]}",), parts[2]
        if sub == "linear" and parts[3] == "weight":
            return prefix + ("linear", "kernel"), "params", "linear"
        if sub in ("emb_q", "emb_k"):
            leaf = ("kernel", "linear") if parts[3] == "weight" else ("bias", None)
            return prefix + (sub, leaf[0]), "params", leaf[1]
        if sub == "bn":
            return _bn(prefix + ("bn",), parts[3])
        return None
    if parts[0] == "fusion_conv" and parts[1] == "weight":
        return ("fusion_conv",), "params", "fusion"
    if parts[0] in ("classifier", "classifiers"):
        head = "classifier_fused" if int(parts[1]) == n_cls else f"classifier_{parts[1]}"
        leaf = ("kernel", "linear") if parts[2] == "weight" else ("bias", None)
        return (head, leaf[0]), "params", leaf[1]
    return None


def _to_torch_layout(arr: np.ndarray, kind) -> np.ndarray:
    if kind == "conv":
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if kind == "linear":
        return arr.T  # (in, out) -> (out, in)
    if kind == "fusion":
        return arr.T[:, :, None]  # flax's (V, 1) -> Conv1d's (1, V, 1)
    return arr


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax_variables(variables, model: torch.nn.Module, partial: bool = False):
    """Load agrl_tpu variables into `model` in place.

    Strict (default): raises KeyError on a missing or unused leaf and
    ValueError on a shape mismatch. `partial=True`: every leaf of
    `params` and `batch_stats` whose entry exists in the model with the
    same shape is copied, the rest (a head for another class count, a
    leaf of another arch) is skipped; other collections (`opt_state`) are
    ignored. Returns (matched, skipped) leaf paths such as
    "params/global_classifier/kernel", as agrl_tpu's load_weights_partial
    reports them."""
    extra_collections = set(variables) - {"params", "batch_stats"}
    if extra_collections and not partial:
        raise KeyError(f"unexpected variable collections: {sorted(extra_collections)}")
    leaves = {
        (collection,) + path: leaf
        for collection in ("params", "batch_stats")
        for path, leaf in _flatten(variables.get(collection, {}))
    }
    used = set()
    with torch.no_grad():
        for name, tensor in model.state_dict().items():
            mapped = torch_name_map(name, model)
            if mapped is None:
                if name.endswith(NO_COUNTERPART):
                    continue
                raise KeyError(f"{name} has no agrl_tpu counterpart")
            path, collection, kind = mapped
            key = (collection,) + path
            if key not in leaves:
                if partial:
                    continue
                raise KeyError(f"{name}: variables lack {'/'.join(key)}")
            arr = _to_torch_layout(np.asarray(leaves[key], np.float32), kind).copy()
            if tuple(arr.shape) != tuple(tensor.shape):
                if partial:
                    continue
                raise ValueError(f"{name}: shape {tuple(arr.shape)} != {tuple(tensor.shape)}")
            tensor.copy_(torch.from_numpy(arr))
            used.add(key)
    unused = sorted("/".join(k) for k in set(leaves) - used)
    if partial:
        return sorted("/".join(k) for k in used), unused
    if unused:
        raise KeyError(f"variables hold leaves the model has no entry for: {unused[:5]}")


def init_pretrained_weights(model: torch.nn.Module, source):
    """ImageNet-pretrained backbone init (`--pretrained-weights`; the
    reference's init_pretrained_weights, vmgn.py:360-370, as agrl_tpu's
    weight_convert.init_pretrained_weights applies it).

    `source` is a torchvision-style ResNet state dict or a path to one
    (.pth/.pth.tar through torch, .npz/.npy through numpy). The `fc.*`
    head is dropped; the reference loads the backbone before it deep-copies
    layer4 (vmgn.py:224-234), so each `layer4.*` entry goes to every
    `layer4*` branch of the model (VMGN: layer4_1 and layer4_2; the
    single-branch archs and msppn: layer4). A model with
    `imagenet_stages` (msppgn: base.{0,1,4..7}) gets each stage under its
    own name. Then a
    shape-filtered partial load: returns (matched, skipped) names; what is
    not matched keeps its initialization."""
    from agrl_torch.core.checkpoint import load_weights_partial, read_state_dict

    if isinstance(source, str):
        source = read_state_dict(source)
    stages = getattr(model, "imagenet_stages", None)
    if stages:  # the model names its trunk's stages its own way
        renamed = {}
        for k, v in source.items():
            stage, _, rest = re.sub(r"^module\.", "", k).partition(".")
            renamed[f"{stages.get(stage, stage)}.{rest}" if rest else stage] = v
        source = renamed
    branches = sorted({name.split(".", 1)[0] for name in model.state_dict()
                       if re.match(r"^layer4(_\d+)?\.", name)})
    fanned = {}
    for name, value in source.items():
        name = re.sub(r"^module\.", "", name)
        if name.startswith("fc."):
            continue
        if name.startswith("layer4."):
            for branch in branches:
                fanned[branch + name[len("layer4"):]] = value
        else:
            fanned[name] = value
    return load_weights_partial(model, fanned)
