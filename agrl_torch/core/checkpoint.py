"""Checkpoint IO — resume vs. transfer semantics (counterpart of
agrl_tpu/core/checkpoint.py).

  * save_checkpoint — reference utils/iotools.py:41-55 and
    train_vidreid_xent_htri.py:364-370:
    one `torch.save` dict {"state_dict", "optimizer", "epoch", "rank1",
    "mAP"}; `is_best` also writes a `best_model.pth.tar` copy. The state
    dict carries the reference's module names, so agrl_tpu's
    `--load-weights` (models.load_any_checkpoint) reads it unchanged.
  * load_checkpoint — --resume (train_vidreid_xent_htri.py:289-315):
    model, optimizer and the metadata.
  * load_weights_partial — --load-weights (:279-287): a
    SHAPE-FILTERED partial load of a torch-named state dict, `module.`
    stripped; entries without a match are skipped and reported.

Files are read with `torch.load(..., weights_only=True)`: a checkpoint
that needs arbitrary unpickling is refused with the file's name, never
read with weights_only=False.
"""

from __future__ import annotations

import os.path as osp
import pickle
import shutil

import numpy as np
import torch

from agrl_torch.core.flax_msgpack import read_checkpoint
from agrl_torch.models.weight_convert import NO_COUNTERPART, from_jax_variables
from agrl_torch.utils.iotools import mkdir_if_missing

# file extensions of a torch-named state dict (this package's checkpoints,
# the reference's released weights, or a numpy archive with torch names)
TORCH_CKPT_EXTS = (".pth", ".pth.tar", ".npz", ".npy")


def save_checkpoint(model, optimizer, fpath: str, epoch: int, rank1: float = 0.0,
                    mAP: float = 0.0, is_best: bool = False) -> None:
    mkdir_if_missing(osp.dirname(fpath))
    torch.save({
        "state_dict": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "epoch": int(epoch),
        "rank1": float(rank1),
        "mAP": float(mAP),
    }, fpath)
    if is_best:
        shutil.copy(fpath, osp.join(osp.dirname(fpath), "best_model.pth.tar"))


def _torch_load(fpath: str):
    """torch.load(weights_only=True) to the CPU; a file that cannot be read
    that way raises with its name."""
    try:
        return torch.load(fpath, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError, EOFError) as e:
        raise RuntimeError(
            f"'{fpath}' cannot be read with torch.load(weights_only=True): {e}"
        ) from e


def load_checkpoint(fpath: str, model=None, optimizer=None) -> dict:
    """Restores `model` and `optimizer` (where given) from a checkpoint of
    save_checkpoint; returns its {"epoch", "rank1", "mAP"}."""
    ckpt = _torch_load(fpath)
    if not isinstance(ckpt, dict) or "state_dict" not in ckpt:
        raise ValueError(f"'{fpath}' is not a checkpoint of save_checkpoint (no state_dict)")
    if model is not None:
        model.load_state_dict(ckpt["state_dict"])
    if optimizer is not None:
        if "optimizer" not in ckpt:
            raise ValueError(f"'{fpath}' holds no optimizer state to resume from")
        optimizer.load_state_dict(ckpt["optimizer"])
    return {"epoch": int(ckpt.get("epoch", -1)), "rank1": float(ckpt.get("rank1", 0.0)),
            "mAP": float(ckpt.get("mAP", 0.0))}


def read_state_dict(fpath: str, key: str = "state_dict") -> dict:
    """A torch-named state dict from .pth/.pth.tar (torch) or .npz/.npy
    (numpy), as agrl_tpu's weight_convert._load_state_dict_file reads it;
    a checkpoint dict yields its `key` entry."""
    if fpath.endswith(".npz"):
        with np.load(fpath) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    if fpath.endswith(".npy"):
        raw = np.load(fpath, allow_pickle=True).item()
        return {k: torch.as_tensor(np.asarray(v)) for k, v in raw.items()}
    ckpt = _torch_load(fpath)
    if isinstance(ckpt, dict) and key in ckpt:
        ckpt = ckpt[key]
    if not isinstance(ckpt, dict):
        raise ValueError(f"'{fpath}' holds no state dict")
    return ckpt


def load_weights_partial(model, source) -> tuple[list, list]:
    """Shape-filtered load of a torch-named state dict (or a path to one)
    into `model`: every entry whose name (less `module.`) is in the model
    with the same shape is copied. Returns (matched, skipped) names.

    Entries with no agrl_tpu counterpart (`num_batches_tracked`, the
    BNNecks' frozen zero biases) are left out of both lists and not
    loaded, so the counts equal agrl_tpu's for the same file."""
    if isinstance(source, str):
        source = read_state_dict(source)
    target = model.state_dict()
    matched, skipped = [], []
    with torch.no_grad():
        for name, value in source.items():
            name = name[len("module."):] if name.startswith("module.") else name
            if name.endswith(NO_COUNTERPART):
                continue
            value = torch.as_tensor(value)
            if name in target and tuple(value.shape) == tuple(target[name].shape):
                target[name].copy_(value)
                matched.append(name)
            else:
                skipped.append(name)
    return matched, skipped


def load_any_checkpoint(model, fpath: str) -> tuple[list, list]:
    """--load-weights for either format, as agrl_tpu's
    models.load_any_checkpoint routes it: TORCH_CKPT_EXTS through the
    torch-name load above, anything else as an agrl_tpu msgpack checkpoint
    through weight_convert.from_jax_variables(partial=True). Returns
    (matched, skipped); only the model's weights load, never an optimizer
    state."""
    if fpath.endswith(TORCH_CKPT_EXTS):
        return load_weights_partial(model, fpath)
    tree, _ = read_checkpoint(fpath)
    if not isinstance(tree, dict) or "params" not in tree:
        tree = {"params": tree}  # a bare params checkpoint
    return from_jax_variables(tree, model, partial=True)
