"""Checkpoint IO (counterpart of agrl_tpu/core): the port's own torch
checkpoints and the reader for agrl_tpu's msgpack ones."""

from agrl_torch.core.checkpoint import (
    load_any_checkpoint,
    load_checkpoint,
    load_variables,
    load_weights_partial,
    save_checkpoint,
)

__all__ = ["load_any_checkpoint", "load_checkpoint", "load_variables", "load_weights_partial",
           "save_checkpoint"]
