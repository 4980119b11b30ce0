"""Checkpoint IO — resume vs. transfer semantics (counterpart of
agrl_tpu/core/checkpoint.py).

  * save_checkpoint — reference utils/iotools.py:41-55 and
    train_vidreid_xent_htri.py:364-370:
    one `torch.save` dict {"state_dict", "optimizer", "epoch", "rank1",
    "mAP"}; `is_best` also writes a `best_model.pth.tar` copy. The state
    dict carries the reference's module names, so agrl_tpu's
    `--load-weights` (models.load_any_checkpoint) reads it unchanged.
  * AsyncCheckpointer — `--async-ckpt` (agrl_tpu/core/checkpoint.py:85-140):
    the same file, written by a background thread from a device snapshot.
  * fetch_global_state — `--mesh-mp` (agrl_tpu/core/checkpoint.py:54-88
    `fetch_global_tree`): the model's and the optimizer's state with every
    mp shard gathered whole, as a host copy, which both writers take
    (`state=`), so a tensor-parallel run writes the file a run without mp
    writes. A collective: every rank calls it before the rank-0 gate.
  * load_checkpoint — --resume (train_vidreid_xent_htri.py:289-315):
    model, optimizer and the metadata.
  * load_weights_partial — --load-weights (:279-287): a
    SHAPE-FILTERED partial load of a torch-named state dict, `module.`
    stripped; entries without a match are skipped and reported.
  * load_variables — the template-free weight load of a serving host
    (agrl_tpu/core/checkpoint.py:155-169): a checkpoint's state dict, with
    no model code imported (engine/export.py `from_exported`).

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

from agrl_torch.utils.iotools import mkdir_if_missing

# NOTE: the model-side imports (weight_convert, the msgpack reader) are
# lazy: load_variables runs on serving hosts that load no model code.

# file extensions of a torch-named state dict (this package's checkpoints,
# the reference's released weights, or a numpy archive with torch names)
TORCH_CKPT_EXTS = (".pth", ".pth.tar", ".npz", ".npy")


def save_checkpoint(model, optimizer, fpath: str, epoch: int, rank1: float = 0.0,
                    mAP: float = 0.0, is_best: bool = False, state: dict | None = None) -> None:
    """Writes `model`'s and `optimizer`'s state, or `state` (the
    {"state_dict", "optimizer"} of fetch_global_state) in their place."""
    if state is None:
        state = {"state_dict": model.state_dict(), "optimizer": optimizer.state_dict()}
    _write_checkpoint(_payload(state["state_dict"], state["optimizer"], epoch, rank1, mAP),
                      fpath, is_best)


def fetch_global_state(model, optimizer, fetch_local: bool = True) -> dict | None:
    """{"state_dict", "optimizer"} of a model whose wide weights may be mp
    shards (parallel.place_state), each shard and its optimizer state
    gathered whole (parallel.gather_state): reference names and full
    shapes, the dicts a run without mp saves. A COLLECTIVE whenever the
    model holds shards: every rank calls it, in the same order, BEFORE any
    rank-0 gate, or the job deadlocks (agrl_tpu/core/checkpoint.py:54-88).
    Returns a host (CPU) copy that the next step cannot touch, for
    save_checkpoint or AsyncCheckpointer.save (`state=`), so the gather
    never runs on the writer's thread; with `fetch_local=False` (a rank
    that writes nothing) the gathers are joined and None returned."""
    from agrl_torch.parallel import gather_state

    state_dict, optim = gather_state(model, optimizer)
    if not fetch_local:
        return None
    return _map_tensors({"state_dict": state_dict, "optimizer": optim},
                        lambda t: t.detach().to("cpu", copy=True))


def _payload(state_dict, optim_state, epoch, rank1, mAP) -> dict:
    return {
        "state_dict": state_dict,
        "optimizer": optim_state,
        "epoch": int(epoch),
        "rank1": float(rank1),
        "mAP": float(mAP),
    }


def _write_checkpoint(payload: dict, fpath: str, is_best: bool) -> None:
    mkdir_if_missing(osp.dirname(fpath))
    torch.save(payload, fpath)
    if is_best:
        shutil.copy(fpath, osp.join(osp.dirname(fpath), "best_model.pth.tar"))


def _map_tensors(tree, fn):
    """`tree` with every tensor replaced by fn(tensor), its containers
    rebuilt; dicts keep their type and a state dict its `_metadata`
    (load_state_dict reads it). Other leaves are shared: state_dict() and
    Optimizer.state_dict() hand out fresh containers of immutable values."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        out = type(tree)((k, _map_tensors(v, fn)) for k, v in tree.items())
        if hasattr(tree, "_metadata"):
            out._metadata = tree._metadata
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


class AsyncCheckpointer:
    """`save_checkpoint` with the device-to-host copy and the write on a
    background thread (agrl_tpu/core/checkpoint.py:85-140).

    `save` first snapshots the model's state dict and the optimizer's state
    where they live, in one batched copy (`torch._foreach_copy_` into
    buffers allocated at the first save, one block per dtype and device,
    and reused): both are views of
    live tensors that the next `optimizer.step()` overwrites in place. An
    event recorded after that copy orders the worker's device-to-host copy
    after it; the worker then writes the file save_checkpoint writes (the
    tensors on the CPU), and the `best_model.pth.tar` copy once the write
    has landed. One save is in flight at a time: a new `save` waits for
    the previous one, which bounds the extra device memory at one copy of
    the state and keeps the files in order. A failed write raises at the
    next `save` or `wait`. `save(..., state=)` takes fetch_global_state's
    host copy (a tensor-parallel run's, gathered by the caller): no
    snapshot, the write alone on the thread."""

    def __init__(self):
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        self._future = None
        self._buffers: list = []
        self._layout: list | None = None

    def _snapshot(self, tree):
        leaves = []
        _map_tensors(tree, leaves.append)
        live = [t.detach() for t in leaves]
        layout = [(t.shape, t.dtype, t.device) for t in live]
        if layout != self._layout:
            # one allocation per (dtype, device), cut into the leaves' shapes:
            # hundreds of separate first-time device allocations would hold
            # the loop for longer than the copy itself
            sizes: dict = {}
            for t in live:
                sizes[(t.dtype, t.device)] = sizes.get((t.dtype, t.device), 0) + t.numel()
            flat = {k: torch.empty(n, dtype=k[0], device=k[1]) for k, n in sizes.items()}
            offset = dict.fromkeys(sizes, 0)
            self._buffers = []
            for t in live:
                k, o = (t.dtype, t.device), offset[(t.dtype, t.device)]
                self._buffers.append(flat[k][o:o + t.numel()].view(t.shape))
                offset[k] = o + t.numel()
            self._layout = layout
        with torch.no_grad():
            torch._foreach_copy_(self._buffers, live)
        it = iter(self._buffers)
        return _map_tensors(tree, lambda _: next(it))

    def save(self, model, optimizer, fpath: str, epoch: int, rank1: float = 0.0,
             mAP: float = 0.0, is_best: bool = False, state: dict | None = None) -> None:
        self.wait()
        event = None
        if state is not None:  # already a host copy
            self._future = self._pool.submit(self._write, state, None, fpath,
                                             epoch, rank1, mAP, is_best)
            return
        snap = self._snapshot({"state_dict": model.state_dict(),
                               "optimizer": optimizer.state_dict()})
        devices = {b.device for b in self._buffers if b.device.type == "cuda"}
        if devices:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(next(iter(devices))))
        self._future = self._pool.submit(self._write, snap, event, fpath,
                                         epoch, rank1, mAP, is_best)

    @staticmethod
    def _write(snap, event, fpath, epoch, rank1, mAP, is_best):
        if event is not None:
            event.synchronize()  # the snapshot copy has run
        host = _map_tensors(snap, lambda t: t.to("cpu"))
        _write_checkpoint(_payload(host["state_dict"], host["optimizer"], epoch, rank1, mAP),
                          fpath, is_best)

    def wait(self) -> None:
        """Block until the in-flight save (if any) lands; re-raise its error."""
        if self._future is not None:
            future, self._future = self._future, None
            future.result()

    def close(self) -> None:
        """wait(), then stop the writer thread."""
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)


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


def load_variables(fpath: str) -> dict:
    """Template-free weight load for serving hosts: the model's state dict
    from a checkpoint of save_checkpoint (its optimizer, epoch and scores
    dropped) or a bare torch-named state dict (TORCH_CKPT_EXTS), `module.`
    stripped, on the CPU. An agrl_tpu .msgpack needs its arch to be
    converted: `python -m agrl_torch.cli.export_model` does that and
    writes the port's weights beside the artifact."""
    if not fpath.endswith(TORCH_CKPT_EXTS):
        raise ValueError(
            f"'{fpath}' is not a torch checkpoint ({', '.join(TORCH_CKPT_EXTS)}); an agrl_tpu "
            "msgpack converts by arch through python -m agrl_torch.cli.export_model"
        )
    return {
        (k[len("module."):] if k.startswith("module.") else k): torch.as_tensor(v)
        for k, v in read_state_dict(fpath).items()
    }


def load_weights_partial(model, source) -> tuple[list, list]:
    """Shape-filtered load of a torch-named state dict (or a path to one)
    into `model`: every entry whose name (less `module.`) is in the model
    with the same shape is copied. Returns (matched, skipped) names.

    Entries with no agrl_tpu counterpart (`num_batches_tracked`, the
    BNNecks' frozen zero biases) are left out of both lists and not
    loaded, so the counts equal agrl_tpu's for the same file."""
    from agrl_torch.models.weight_convert import NO_COUNTERPART

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
    from agrl_torch.core.flax_msgpack import read_checkpoint
    from agrl_torch.models.weight_convert import from_jax_variables

    if fpath.endswith(TORCH_CKPT_EXTS):
        return load_weights_partial(model, fpath)
    tree, _ = read_checkpoint(fpath)
    if not isinstance(tree, dict) or "params" not in tree:
        tree = {"params": tree}  # a bare params checkpoint
    return from_jax_variables(tree, model, partial=True)
