"""Data parallelism across processes (counterpart of agrl_tpu/parallel/mesh.py).

agrl_tpu puts every chip on one ('dp', 'mp') mesh and lets GSPMD insert the
collectives of one jit program. The port runs the mesh's 'dp' axis as one
process per card under torch.distributed (NCCL on cards, gloo on the CPU)
and writes the collectives itself, so that a job of W processes computes
what agrl_tpu's single-device program computes on the global batch:

  * the train step (engine/trainer.py) draws its augmentations and the
    consistent-loss subclips for the global batch, keeps its slice, and
    averages the gradients over the ranks;
  * a train-mode BatchNorm normalizes with the statistics of the global
    batch (models/backbone.py `global_batch_stats`), backward included;
  * the batch-hard mining gathers every rank's features and labels and
    mines the global batch (losses.batch_hard_triplet_heads);
  * the Evaluator splits each device batch over the ranks and gathers the
    features back, so every rank ranks the whole query and gallery.

The mesh has two forms. The process-group form (`make_mesh()` after
`initialize_distributed`) is this process's rank in a group of W, each
process on its own card: the trainer, the Evaluator and the CLI take it.
The local-devices form (`make_mesh(devices=...)`, or `make_mesh()` with no
group: the visible cards) is one process driving several devices:
in-process serving (engine/export.py `FeatureExtractor(mesh=)`) takes it.

agrl_tpu names with no counterpart here: `put_global` (each rank already
holds its slice: the loader's `process_shard` loads only that), and
`param_shardings` / `place_state` / `put_sharded_tree` (the tensor-parallel
placement of `--mesh-mp`, ROADMAP A8b). `batch_sharding` is `shard_batch`'s
slice rule.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

# the gradient all-reduce's bucket: one collective per this many bytes
BUCKET_BYTES = 25 * 2**20
_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


@dataclass(frozen=True)
class Mesh:
    """A data-parallel mesh of `dp` devices. `group` is the process group
    (process-group form: this process is `rank` of `dp` and `devices` holds
    its one device), or None (local-devices form: one process, `devices`
    the dp devices it drives, rank 0)."""

    dp: int
    rank: int
    devices: tuple
    group: object = None

    @property
    def device(self) -> torch.device:
        """This process's device (the first of the local ones)."""
        return self.devices[0]

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def holds(self, device) -> bool:
        """Whether `device` is this process's device (`cuda` with no index
        is the current card)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device == self.device


def torchrun_environment() -> bool:
    """Whether this process was started by torchrun (its env:// variables)."""
    return all(v in os.environ for v in _TORCHRUN_VARS)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
) -> None:
    """Joins this process to a group of `num_processes`, as `process_id`,
    with rank 0 at `coordinator_address` ("host:port" or "tcp://host:port").
    With no arguments it takes torchrun's env:// variables (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK), in the role of agrl_tpu's TPU
    auto-detection. On the card (`device` cuda, the default) the group is
    NCCL and this process takes card LOCAL_RANK (torchrun) or process_id
    modulo the visible cards, and the group connects at once, so a failed
    NCCL start raises here; with device="cpu" it is gloo. Without a card and
    without device="cpu" it raises, and it never falls back to gloo or the
    CPU."""
    from agrl_torch import resolve_device

    dev = resolve_device(device)
    given = (coordinator_address, num_processes, process_id)
    if all(v is None for v in given):
        if not torchrun_environment():
            raise ValueError("initialize_distributed() with no arguments takes torchrun's "
                             f"variables {', '.join(_TORCHRUN_VARS)}; none or not all are set")
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    elif any(v is None for v in given):
        raise ValueError("give coordinator_address, num_processes and process_id together, "
                         f"got {given}")
    else:
        world, rank = int(num_processes), int(process_id)
        if not 0 <= rank < world:
            raise ValueError(f"process_id {rank} is not in [0, {world})")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized in this process")
    if dev.type == "cuda":
        index = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        card = torch.device("cuda", index)
        torch.cuda.set_device(card)
        dist.init_process_group("nccl", init_method=init_method, world_size=world, rank=rank,
                                device_id=card)
    else:
        dist.init_process_group("gloo", init_method=init_method, world_size=world, rank=rank)


def make_mesh(dp: int | None = None, mp: int = 1, devices=None) -> Mesh:
    """The port's mesh. In a process group (and with no `devices`): the
    process-group form, dp = the world size; a `dp` that is not the world
    size is refused, since each process owns one card. Otherwise the
    local-devices form over `devices` (default: the visible cards), dp of
    them (default all). `mp > 1` raises: the tensor-parallel axis is
    ROADMAP A8b."""
    if mp != 1:
        raise NotImplementedError(f"mp={mp}: the mesh's model-parallel axis (--mesh-mp) is not "
                                  "ported to agrl_torch yet (ROADMAP A8b)")
    if devices is None and dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if dp is not None and dp != world:
            raise ValueError(f"dp={dp} is not the world size {world}: each process drives one "
                             "card, so the data-parallel axis is the process group")
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        return Mesh(dp=world, rank=rank, devices=(dev,), group=dist.group.WORLD)
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no visible card for the mesh; pass devices=[...] (e.g. CPU "
                               "devices) or initialize a process group first")
    devices = tuple(torch.device(d) for d in devices)
    dp = len(devices) if dp is None else dp
    if not 1 <= dp <= len(devices):
        raise ValueError(f"dp={dp} needs that many devices, have {len(devices)}")
    return Mesh(dp=dp, rank=0, devices=devices[:dp])


def shard_batch(mesh: Mesh, *arrays):
    """This rank's contiguous slice of each array's leading axis (the
    process-group form); the leading axis must divide by dp."""
    out = []
    for a in arrays:
        n = a.shape[0]
        if n % mesh.dp:
            raise ValueError(f"a batch of {n} does not divide over dp={mesh.dp}")
        k = n // mesh.dp
        out.append(a[mesh.rank * k:(mesh.rank + 1) * k])
    return tuple(out) if len(out) > 1 else out[0]


def _buckets(tensors):
    """Runs of `tensors` of one dtype and device, up to BUCKET_BYTES each."""
    run, size = [], 0
    for t in tensors:
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or size + t.numel() * t.element_size() > BUCKET_BYTES):
            yield run
            run, size = [], 0
        run.append(t)
        size += t.numel() * t.element_size()
    if run:
        yield run


def _bucketed(tensors, collective) -> None:
    """`collective` (in place, on one flat tensor) over `tensors` in buckets,
    the results copied back."""
    for run in _buckets(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in run])
        collective(flat)
        offset = 0
        for t in run:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def replicated(mesh: Mesh, model: torch.nn.Module, optimizer=None) -> None:
    """Every rank holds the same values: rank 0's parameters, buffers and
    optimizer state are broadcast to the group (agrl_tpu replicates the
    train state over the mesh). Each rank must hold state of the same
    structure (a fresh optimizer, or the same checkpoint read)."""
    if not mesh.distributed:
        return
    tensors = [*model.parameters(), *model.buffers()]
    if optimizer is not None:
        for group in optimizer.param_groups:
            for p in group["params"]:
                state = optimizer.state.get(p, {})
                tensors.extend(state[k] for k in sorted(state) if torch.is_tensor(state[k]))
    with torch.no_grad():
        _bucketed(tensors, lambda flat: dist.broadcast(flat, src=0, group=mesh.group))


def average_gradients(parameters, mesh: Mesh) -> None:
    """Replaces each gradient by its mean over the ranks, in buckets of
    BUCKET_BYTES. Parameters with no gradient (frozen ones) are skipped;
    every rank has the same ones, since every rank runs the same graph."""
    grads = [p.grad for p in parameters if p.grad is not None]
    world = mesh.dp

    def mean(flat):
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(world)

    with torch.no_grad():
        _bucketed(grads, mean)


def all_reduce_mean(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean over the ranks of a tensor outside autograd (metrics)."""
    out = t.detach().clone()
    dist.all_reduce(out, group=mesh.group)
    return out / mesh.dp


class _GatherRows(torch.autograd.Function):
    """all_gather of equal-sized rank slices, concatenated along dim 0 in
    rank order. Backward: the gradients of the whole are summed over the
    ranks (each rank's loss reads every rank's rows), and each rank keeps
    its slice."""

    @staticmethod
    def forward(ctx, x, group, world, rank):
        ctx.group, ctx.rank = group, rank
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        k = grad.shape[0] // dist.get_world_size(ctx.group)
        return grad[ctx.rank * k:(ctx.rank + 1) * k], None, None, None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's (n, ...) slice -> the (dp * n, ...) whole, in rank
    order, on every rank; differentiable (see _GatherRows)."""
    return _GatherRows.apply(x, mesh.group, mesh.dp, mesh.rank)
