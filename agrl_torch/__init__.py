"""agrl_torch — the PyTorch/CUDA port of agrl_tpu for NVIDIA Hopper GPUs.

Module paths mirror agrl_tpu so each piece has an obvious counterpart.
The package imports torch and numpy only; kernels are CUDA C++ sources
under `csrc/`, compiled with nvcc at first use (`kernels/build.py`),
which also builds the repo's host libraries of `native/` (the batched
JPEG decoder, the C++ ranking scorers) with g++ at first use. Importing
the package builds nothing.

Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`; with no card and no explicit CPU they raise. Training:
`models.init_model`, `optim.init_optim`, `make_train_step` (below, from
`engine.trainer`); serving: `engine.export.FeatureExtractor` and the
`torch.export` artifact (`engine.export.export_eval_forward`,
`python -m agrl_torch.cli.export_model`); the CLI over both:
`python -m agrl_torch.cli.train_vidreid_xent_htri`. Data parallelism,
one process per card: `agrl_torch.parallel` (the train step's, the
Evaluator's and FeatureExtractor's `mesh=`; the CLI's `--dist-*` flags).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for (or implied by None) and there
    is no card — the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


from agrl_torch.engine.trainer import make_train_step  # noqa: E402  (needs resolve_device first)

__all__ = ["make_train_step", "resolve_device"]
