"""Model registry (counterpart of agrl_tpu/models/__init__.py).

`init_model(name, num_classes, device=..., seed=...)` returns a model with
random weights drawn from a seeded torch.Generator, on the device (CUDA
unless the caller passes device="cpu"), in eval mode; a trainer calls
`.train()`. `loss` and `consistent_loss` shape the train forward. Only the VMGN
family is ported; the other archs of agrl_tpu's registry follow later.
"""

from __future__ import annotations

import torch

from agrl_torch import resolve_device
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
    "vmgn_tiny": vmgn_tiny,  # debug/smoke-test arch (not in the reference)
}


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
    """Adjacency vertex count for a clip: frames x parts per frame."""
    return seq_len * getattr(model, "total_split", 1)
