"""Model registry (counterpart of agrl_tpu/models/__init__.py).

`init_model(name, num_classes, device=..., seed=...)` returns a model with
random weights drawn from a seeded torch.Generator, on the device (CUDA
unless the caller passes device="cpu"), in eval mode; a trainer calls
`.train()`. `loss` and `consistent_loss` shape the train forward. The
whole of agrl_tpu's video registry, each factory taking and dropping
keywords as agrl_tpu's does: the VMGN family, the single-scale archs of
the reference's factory (gsta, ganet, sta, simple_sta, res50tp,
resnet50_s1), the multi-scale pair msppn and msppgn (models/graphnet.py)
and the legacy video families (res50tp_legacy, res50ta, res50rnn:
models/resnet_temporal.py; resnet3d50, resnet3dt: models/resnet3d.py).
The image registry (`get_image_names`, `init_image_model`) builds
agrl_tpu's four image archs (models/resnet_image.py), which take
(B, H, W, 3) images.
"""

from __future__ import annotations

import torch

from agrl_torch import resolve_device
from agrl_torch.models.ganet import ganet
from agrl_torch.models.graphnet import msppgn, msppn
from agrl_torch.models.gsta import gsta
from agrl_torch.models.res50tp import res50tp, resnet50_s1
from agrl_torch.models.resnet3d import resnet3d, resnet3dt
from agrl_torch.models.resnet_image import (
    resnet50_image,
    resnet50b,
    resnet50m,
    resnet101_image,
)
from agrl_torch.models.resnet_temporal import res50rnn, res50ta, res50tp_legacy
from agrl_torch.models.sta import simple_sta, sta
from agrl_torch.models.vmgn import VMGN, check_factory_kwargs, vmgn


def vmgn_tiny(num_classes, loss=frozenset({"xent", "htri"}), last_stride=1, num_split=4,
              pyramid_part=True, num_gb=2, use_pose=True, learn_graph=True,
              consistent_loss=False, **kwargs):
    """Depth-(1,1,1,1) VMGN for tests/smoke runs (not in the reference).
    A `dtype` is checked and dropped, as agrl_tpu's vmgn_tiny drops it:
    the model follows its input (dtype None)."""
    check_factory_kwargs(**kwargs)
    return VMGN(
        num_classes=num_classes,
        loss=loss,
        consistent_loss=consistent_loss,
        layers=(1, 1, 1, 1),
        last_stride=last_stride,
        num_split=num_split,
        pyramid_part=pyramid_part,
        num_gb=num_gb,
        use_pose=use_pose,
        learn_graph=learn_graph,
    )


__model_factory = {
    "vmgn": vmgn,  # reference models/vmgn.py:373 (the paper model)
    "gsta": gsta,  # models/gsta.py:340
    "ganet": ganet,  # models/ganet.py:458
    "msppn": msppn,  # models/graphnet.py:120
    "msppgn": msppgn,  # models/graphnet.py:217
    "sta": sta,  # models/sta.py:268
    "simple_sta": simple_sta,  # models/simple_sta.py:243
    "res50tp": res50tp,  # models/res50tp.py:224
    "resnet50_s1": resnet50_s1,  # models/resnet50_s1.py:217
    "vmgn_tiny": vmgn_tiny,  # debug/smoke-test arch (not in the reference)
    # legacy video families (unregistered in the reference: its
    # models/resnet_temporal.py, resnet3d.py, resnet3dt.py)
    "res50tp_legacy": res50tp_legacy,
    "res50ta": res50ta,
    "res50rnn": res50rnn,
    "resnet3d50": resnet3d,
    "resnet3dt": resnet3dt,
}

# image re-id archs (reference models/resnet.py, also unregistered there):
# (B, H, W, 3) images and no adjacency, so a registry of their own
__image_model_factory = {
    "resnet50": resnet50_image,
    "resnet101": resnet101_image,
    "resnet50m": resnet50m,
    "resnet50b": resnet50b,
}


def get_image_names():
    return list(__image_model_factory.keys())


def init_image_model(name: str, *args, device="cuda", seed: int = 0, **kwargs):
    """Image registry model with weights from torch.Generator(seed) (and
    resnet50b's dropout masks from torch.Generator(seed + 1)), moved to
    `device` (CUDA unless device="cpu"; raises without a card), eval mode."""
    if name not in __image_model_factory:
        raise KeyError(f"Unknown image model: {name}. Choices: {get_image_names()}")
    dev = resolve_device(device)
    model = __image_model_factory[name](*args, **kwargs)
    model.init_weights(torch.Generator().manual_seed(seed))
    if hasattr(model, "dropout"):
        model.dropout.generator = torch.Generator().manual_seed(seed + 1)
    return model.to(dev).eval()


def get_names():
    return list(__model_factory.keys())


def build_model(name: str, *args, **kwargs):
    """The registry's module, with PyTorch's default init, on the CPU."""
    if name not in __model_factory:
        raise KeyError(f"Unknown model: {name}. Choices: {get_names()}")
    return __model_factory[name](*args, **kwargs)


def init_model(name: str, *args, device="cuda", seed: int = 0, **kwargs):
    """Registry model with weights from torch.Generator(seed), moved to
    `device` (CUDA unless device="cpu"; raises without a card), eval mode."""
    dev = resolve_device(device)
    model = build_model(name, *args, **kwargs)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def default_num_vertices(model, seq_len: int) -> int:
    """Adjacency vertex count for a clip: frames x parts per frame x vertex
    scales (3 for msppn and msppgn, whose vertices span layer2/3/4). The
    FeatureExtractor, the exported artifact and the FLOPs probe size
    their all-ones adjacency through it."""
    return (seq_len * getattr(model, "total_split", 1)
            * getattr(model, "num_vertex_scales", 1))
