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
agrl_tpu/models/weight_convert.py:_split_torch_name the GSTA family uses
(vmgn, gsta, ganet, sta, simple_sta, res50tp, resnet50_s1): the trunk,
`layer4` or `layer4_1`/`layer4_2`, the BNNecks, the classifiers (sta's
with a bias), the graph layers, ganet's `pam_layer` and sta's `fc1`.
Other archs name their modules their own way (the model's
`name_scheme`), each a copy of one of agrl_tpu's converters:
  * msppn, msppgn (`_graphnet_name_map`): their fusion Conv1d is torch's
    (1, V, 1) and flax's (V, 1);
  * `temporal` (convert_temporal_state_dict, :338): res50tp_legacy,
    res50ta, res50rnn and the image archs resnet50, resnet101 and
    resnet50b, with the reference's `base.{0,1,4..7}`; res50ta's
    `attention_conv` and `attention_tconv` (Conv1d: flax (k, in, out),
    torch (out, in, k)); res50rnn's `lstm`, whose packed torch weights
    are four flax kernels each (`lstm/i{i,f,g,o}`, `lstm/h{i,f,g,o}`,
    transposed and stacked in gate order), whose `bias_hh_l0` is flax's
    four h-side biases and whose `bias_ih_l0` has no leaf (written as
    zeros); resnet50b's `bottleneck.0/.1` (flax `bottleneck_fc`,
    `bottleneck_bn`), which agrl_tpu's converter leaves out;
  * `resnet50m` (convert_resnet50m_state_dict, :429): `layers1..4`,
    `layers5a/b/c` and `fc_fuse`;
  * `resnet3d` (convert_resnet3d_state_dict, :521): Conv3d kernels, flax
    DHWIO and torch OIDHW, and the head `fc`, flax's `classifier`.
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
LSTM_GATES = ("i", "f", "g", "o")  # torch's packing order, flax's i{g}/h{g} names


def _bn(prefix: tuple, leaf: str):
    hit = _BN_LEAF.get(leaf)
    return None if hit is None else (prefix + (hit[0],), hit[1], None)


def torch_name_map(name: str, model=None):
    """Reference-style module path -> (flax path, collection, layout kind),
    or None for entries without a flax counterpart. The archs with a
    `name_scheme` (msppn, msppgn, the legacy video and image families)
    name their modules their own way, so their entries map through
    `model`."""
    scheme = getattr(model, "name_scheme", None)
    name = re.sub(r"^module\.", "", name)
    if scheme in ("msppn", "msppgn"):
        return _graphnet_name_map(name, scheme, model.num_vertices)
    if scheme is not None:
        return _SCHEME_MAPS[scheme](name.split("."))
    parts = name.split(".")
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
        return _linear_or_bias((parts[0],), parts[1])

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
    return _block_leaf(prefix + (f"block{rest[0]}",), rest[1:])


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


def _linear_or_bias(prefix: tuple, leaf: str):
    """A Linear's (or a conv bias's) weight/bias under `prefix`."""
    if leaf == "weight":
        return prefix + ("kernel",), "params", "linear"
    if leaf == "bias":
        return prefix + ("bias",), "params", None
    return None


def _temporal_name_map(parts: list):
    """agrl_tpu's convert_temporal_state_dict, entry by entry: `base.*`
    under flax's `backbone` (layer4 beside the trunk), the classifier,
    res50ta's attention convs, res50rnn's LSTM, resnet50b's bottleneck."""
    if parts[0] == "base":
        idx, rest = parts[1], parts[2:]
        if idx == "0" and rest[0] == "weight":
            return ("backbone", "trunk", "stem", "conv1", "kernel"), "params", "conv"
        if idx == "1":
            return _bn(("backbone", "trunk", "stem", "bn1"), rest[0])
        if idx in ("4", "5", "6"):
            return _res_block(("backbone", "trunk", f"layer{int(idx) - 3}"), rest)
        if idx == "7":
            return _res_block(("backbone", "layer4"), rest)
        return None
    if parts[0] == "classifier":
        return _linear_or_bias(("classifier",), parts[1])
    if parts[0] in ("attention_conv", "attention_tconv"):  # res50ta's, with biases
        if parts[1] == "weight":
            kind = "conv" if parts[0] == "attention_conv" else "conv1d"
            return (parts[0], "kernel"), "params", kind
        return (parts[0], "bias"), "params", None
    if parts[0] == "lstm":
        kind = {"weight_ih_l0": "lstm_ih", "weight_hh_l0": "lstm_hh", "bias_hh_l0": "lstm_bias",
                "bias_ih_l0": "zeros"}.get(parts[1])
        return None if kind is None else (("lstm",), "params", kind)
    if parts[0] == "bottleneck":  # resnet50b's Linear + BatchNorm1d
        if parts[1] == "0":
            return _linear_or_bias(("bottleneck_fc",), parts[2])
        if parts[1] == "1":
            return _bn(("bottleneck_bn",), parts[2])
    return None


def _resnet50m_name_map(parts: list):
    """agrl_tpu's convert_resnet50m_state_dict: the regrouped torchvision
    children layers1 (conv1, bn1, relu), layers2 (maxpool, layer1),
    layers3/4 (layer2/3) under flax's `trunk`, layer4's blocks as
    layers5a/b/c, and fc_fuse (Linear, BN)."""
    if parts[0] == "layers1":
        if parts[1] == "0" and parts[2] == "weight":
            return ("trunk", "stem", "conv1", "kernel"), "params", "conv"
        if parts[1] == "1":
            return _bn(("trunk", "stem", "bn1"), parts[2])
        return None
    if parts[0] == "layers2":
        return _res_block(("trunk", "layer1"), parts[2:]) if parts[1] == "1" else None
    if parts[0] in ("layers3", "layers4"):
        return _res_block(("trunk", f"layer{int(parts[0][-1]) - 1}"), parts[1:])
    if parts[0] in ("layers5a", "layers5b", "layers5c"):
        return _block_leaf((parts[0],), parts[1:])
    if parts[0] == "fc_fuse":
        if parts[1] == "0":
            return _linear_or_bias(("fc_fuse",), parts[2])
        if parts[1] == "1":
            return _bn(("fc_fuse_bn",), parts[2])
        return None
    if parts[0] == "classifier":
        return _linear_or_bias(("classifier",), parts[1])
    return None


def _resnet3d_name_map(parts: list):
    """agrl_tpu's convert_resnet3d_state_dict: conv1, bn1 and
    layer{i}.{j}.* onto flax's flat `layer{i}_block{j}`, Conv3d kernels,
    and the head `fc` onto `classifier`."""
    if parts[0] == "conv1" and parts[1] == "weight":
        return ("conv1", "kernel"), "params", "conv3d"
    if parts[0] == "bn1":
        return _bn(("bn1",), parts[1])
    if re.match(r"^layer\d$", parts[0]):
        hit = _block_leaf((f"{parts[0]}_block{parts[1]}",), parts[2:])
        if hit is not None and hit[2] == "conv":
            return hit[0], hit[1], "conv3d"
        return hit
    if parts[0] == "fc":
        return _linear_or_bias(("classifier",), parts[1])
    return None


def _block_leaf(prefix: tuple, rest: list):
    """A residual block's own {convK, bnK, downsample.0/.1} leaves under
    `prefix` (no block level)."""
    if re.match(r"^conv\d$", rest[0]) and rest[1] == "weight":
        return prefix + (rest[0], "kernel"), "params", "conv"
    if re.match(r"^bn\d$", rest[0]):
        return _bn(prefix + (rest[0],), rest[1])
    if rest[0] == "downsample":
        if rest[1] == "0" and rest[2] == "weight":
            return prefix + ("downsample_conv", "kernel"), "params", "conv"
        if rest[1] == "1":
            return _bn(prefix + ("downsample_bn",), rest[2])
    return None


_SCHEME_MAPS = {"temporal": _temporal_name_map, "resnet50m": _resnet50m_name_map,
                "resnet3d": _resnet3d_name_map}


def _to_torch_layout(arr: np.ndarray, kind) -> np.ndarray:
    if kind == "conv":
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if kind == "conv3d":
        return arr.transpose(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
    if kind == "conv1d":
        return arr.transpose(2, 1, 0)  # (k, in, out) -> Conv1d's (out, in, k)
    if kind == "linear":
        return arr.T  # (in, out) -> (out, in)
    if kind == "fusion":
        return arr.T[:, :, None]  # flax's (V, 1) -> Conv1d's (1, V, 1)
    return arr


def _gather(leaves: dict, key: tuple, kind, shape):
    """The torch-layout array of one state-dict entry from flax leaves keyed
    by path tuples, and the keys it used. Most entries are one leaf at
    `key`; the LSTM's pack four (`key` + (i{g} or h{g}, kernel or bias)),
    and its `bias_ih_l0` ("zeros") takes none. Raises KeyError naming
    the first missing key."""
    if kind == "zeros":
        return np.zeros(shape, np.float32), []
    if kind in ("lstm_ih", "lstm_hh", "lstm_bias"):
        side, leaf = {"lstm_ih": ("i", "kernel"), "lstm_hh": ("h", "kernel"),
                      "lstm_bias": ("h", "bias")}[kind]
        keys = [key + (side + g, leaf) for g in LSTM_GATES]
        for k in keys:
            if k not in leaves:
                raise KeyError(k)
        return np.concatenate([np.asarray(leaves[k], np.float32).T for k in keys]), keys
    if key not in leaves:
        raise KeyError(key)
    return _to_torch_layout(np.asarray(leaves[key], np.float32), kind), [key]


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
            try:
                arr, keys = _gather(leaves, (collection,) + path, kind, tuple(tensor.shape))
            except KeyError as e:
                if partial:
                    continue
                raise KeyError(f"{name}: variables lack {'/'.join(e.args[0])}") from None
            if tuple(arr.shape) != tuple(tensor.shape):
                if partial:
                    continue
                raise ValueError(f"{name}: shape {tuple(arr.shape)} != {tuple(tensor.shape)}")
            tensor.copy_(torch.from_numpy(arr.copy()))
            used.update(keys)
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
    `imagenet_stages` gets each stage (or block, "layer4.0") under its own
    name (msppgn, the legacy video and image archs: base.{0,1,4..7};
    resnet50m: layers1..4 and layer4's blocks as layers5a/b/c, agrl_tpu
    weight_convert.py:617-631), and the entries of stages it does not
    list are skipped (resnet3d lists none: no 2-D stage fits it). Then a
    shape-filtered partial load: returns (matched, skipped) names; what is
    not matched keeps its initialization."""
    from agrl_torch.core.checkpoint import load_weights_partial, read_state_dict

    if isinstance(source, str):
        source = read_state_dict(source)
    stages = getattr(model, "imagenet_stages", None)
    dropped = []
    if stages is not None:  # the model names its trunk's stages its own way
        renamed = {}
        for k, v in source.items():
            k = re.sub(r"^module\.", "", k)
            parts = k.split(".")
            for n in (2, 1):  # a block ("layer4.0") before its stage
                head = ".".join(parts[:n])
                if len(parts) > n and head in stages:
                    renamed[f"{stages[head]}.{'.'.join(parts[n:])}"] = v
                    break
            else:
                if not k.startswith("fc."):
                    dropped.append(k)
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
    matched, skipped = load_weights_partial(model, fanned)
    return matched, skipped + dropped
