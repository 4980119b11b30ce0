"""Data and tensor parallelism across processes (counterpart of
agrl_tpu/parallel/mesh.py).

agrl_tpu puts every chip on one ('dp', 'mp') mesh and lets GSPMD insert the
collectives of one jit program. The port runs each device of that mesh as
one process under torch.distributed (NCCL on cards, gloo on the CPU) and
writes the collectives itself, so that a job of W = dp x mp processes
computes what agrl_tpu's single-device program computes on the global
batch. Rank r is dp index r // mp and mp index r % mp, as agrl_tpu's
`devices.reshape(dp, mp)` orders devices; the ranks of one mp index form a
dp group, those of one dp index an mp group.

The dp axis (over each dp group):
  * the train step (engine/trainer.py) draws its augmentations and the
    consistent-loss subclips for the global batch, keeps its dp slice, and
    averages the gradients over the dp group (the replicated ones over
    every rank at mp > 1, which is the same mean: `average_gradients`);
  * a train-mode BatchNorm normalizes with the statistics of the global
    batch (models/backbone.py `global_batch_stats`), backward included;
  * the batch-hard mining gathers every dp slice's features and labels and
    mines the global batch (losses.batch_hard_triplet_heads);
  * the Evaluator splits each device batch over the dp group and gathers
    the features back, so every rank ranks the whole query and gallery.
The ranks of one mp group hold the same batch slice and draw the same
augmentations.

The mp axis: `place_state` shards each weight agrl_tpu's `param_shardings`
shards (a Linear whose output rows divide by mp, at least `min_size`
large) over the mp group, with its optimizer state; the sharded Linear
computes its column block and gathers the whole output (`MPShard`), so
everything after it runs replicated and alike on every rank of an mp
group. Evaluation and checkpoints take the weights whole
(`whole_weights`, `gather_state`), as agrl_tpu's Evaluator replicates the
variables and its CLI gathers the shards before a save.

The mesh has two forms. The process-group form (`make_mesh()` after
`initialize_distributed`) is this process's place in the dp x mp grid,
each process on its own card: the trainer, the Evaluator and the CLI take
it. The local-devices form (`make_mesh(devices=...)`, or `make_mesh()`
with no group: the visible cards) is one process driving several devices,
data-parallel only: in-process serving (engine/export.py
`FeatureExtractor(mesh=)`) takes it, and agrl_tpu's FeatureExtractor
replicates the weights over mp anyway.

agrl_tpu names with no counterpart here: `put_global` (each rank already
holds its slice: the loader's `process_shard` loads only that) and
`put_sharded_tree` (the port's train state lives in modules and an
optimizer, not in a pytree: `place_state` places both).
`batch_sharding` is `shard_batch`'s slice rule; `fetch_global_tree` is
core/checkpoint.py `fetch_global_state`.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

# the gradient all-reduce's bucket: one collective per this many bytes
BUCKET_BYTES = 25 * 2**20
# agrl_tpu's param_shardings default: a 2-D kernel of fewer entries replicates
MIN_SHARD_SIZE = 2048 * 256
_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


@dataclass(frozen=True)
class Mesh:
    """A ('dp', 'mp') mesh. Process-group form: this process is dp index
    `dp_index` and mp index `mp_index` of a dp x mp grid of processes,
    `devices` holds its one device, `dp_group` is the ranks of its mp index
    (the data-parallel collectives' group) and `mp_group` the ranks of its
    dp index (None at mp 1). Local-devices form (`dp_group` None): one
    process, `devices` the dp devices it drives, mp 1."""

    dp: int
    dp_index: int
    devices: tuple
    dp_group: object = None
    mp: int = 1
    mp_index: int = 0
    mp_group: object = None

    @property
    def rank(self) -> int:
        """This process's rank in the process group (0 in the local form)."""
        return self.dp_index * self.mp + self.mp_index

    @property
    def world(self) -> int:
        return self.dp * self.mp

    @property
    def device(self) -> torch.device:
        """This process's device (the first of the local ones)."""
        return self.devices[0]

    @property
    def distributed(self) -> bool:
        return self.dp_group is not None

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
    process-group form over the W ranks, dp = W / mp; a world that `mp`
    does not divide, or a `dp` other than W / mp, is refused, since each
    process owns one card. Every rank must call it (it makes the dp and mp
    groups at mp > 1). Otherwise the local-devices form over `devices`
    (default: the visible cards), dp of them (default all), which is
    data-parallel: mp > 1 raises there."""
    if mp < 1:
        raise ValueError(f"mp={mp} must be at least 1")
    if devices is None and dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if world % mp:
            raise ValueError(f"mp={mp} does not divide the world of {world} process(es): the "
                             "mesh is dp x mp processes, one card each")
        if dp is not None and dp != world // mp:
            raise ValueError(f"dp={dp} is not the world size {world} over mp={mp}: each "
                             "process drives one card, so the process group is dp x mp")
        dp = world // mp
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        if mp == 1:
            return Mesh(dp=world, dp_index=rank, devices=(dev,), dp_group=dist.group.WORLD)
        groups = {}
        # dist.new_group's contract: every rank makes every group, in one order
        for m in range(mp):
            groups["dp", m] = dist.new_group([d * mp + m for d in range(dp)])
        for d in range(dp):
            groups["mp", d] = dist.new_group([d * mp + m for m in range(mp)])
        d, m = divmod(rank, mp)
        return Mesh(dp=dp, dp_index=d, devices=(dev,), dp_group=groups["dp", m], mp=mp,
                    mp_index=m, mp_group=groups["mp", d])
    if mp != 1:
        raise ValueError(f"mp={mp}: the local-devices form is data-parallel serving (agrl_tpu's "
                         "FeatureExtractor replicates the weights over mp); a tensor-parallel "
                         "mesh is a process group of dp x mp processes (initialize_distributed)")
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no visible card for the mesh; pass devices=[...] (e.g. CPU "
                               "devices) or initialize a process group first")
    devices = tuple(torch.device(d) for d in devices)
    dp = len(devices) if dp is None else dp
    if not 1 <= dp <= len(devices):
        raise ValueError(f"dp={dp} needs that many devices, have {len(devices)}")
    return Mesh(dp=dp, dp_index=0, devices=devices[:dp])


def shard_batch(mesh: Mesh, *arrays):
    """This rank's contiguous dp slice of each array's leading axis (the
    process-group form); the leading axis must divide by dp."""
    out = []
    for a in arrays:
        n = a.shape[0]
        if n % mesh.dp:
            raise ValueError(f"a batch of {n} does not divide over dp={mesh.dp}")
        k = n // mesh.dp
        out.append(a[mesh.dp_index * k:(mesh.dp_index + 1) * k])
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


def _first_rank(group) -> int:
    """The process-group rank of `group`'s first member (a broadcast's
    `src` is a process-group rank)."""
    return 0 if group is dist.group.WORLD else dist.get_global_rank(group, 0)


def replicated(mesh: Mesh, model: torch.nn.Module, optimizer=None) -> None:
    """Every rank of a dp group holds the same values: its first rank's
    parameters, buffers and optimizer state are broadcast over it
    (agrl_tpu replicates the train state over the mesh). Each rank must
    hold state of the same structure (a fresh optimizer, or the same
    checkpoint read), and the mp ranks of one dp index the same values,
    as agrl_tpu's placement asks of every process (a shared seed, or the
    same checkpoint)."""
    if not mesh.distributed:
        return
    tensors = [*model.parameters(), *model.buffers()]
    if optimizer is not None:
        for group in optimizer.param_groups:
            for p in group["params"]:
                state = optimizer.state.get(p, {})
                tensors.extend(state[k] for k in sorted(state) if torch.is_tensor(state[k]))
    src = _first_rank(mesh.dp_group)
    with torch.no_grad():
        _bucketed(tensors, lambda flat: dist.broadcast(flat, src=src, group=mesh.dp_group))


def average_gradients(parameters, mesh: Mesh, shards=()) -> None:
    """Replaces each gradient by its mean, in buckets of BUCKET_BYTES: an mp
    block's (`shards`, parallel.sharded_parameters) over its dp group, the
    ranks holding the same block; a replicated parameter's over every rank
    of the mesh (the dp group at mp 1). In exact arithmetic a replicated
    parameter's gradient is the same on the mp ranks of one dp index, so
    its mean over all ranks is its mean over the dp group; the mean over
    the mp ranks too keeps the replicas bit-equal on a card, whose backward
    kernels (cuDNN's weight gradients) do not sum in a fixed order.
    Parameters with no gradient (frozen ones) are skipped; every rank has
    the same ones, since every rank runs the same graph."""
    blocks = {id(p) for p in shards}
    params = [p for p in parameters if p.grad is not None]
    runs = [([p.grad for p in params if id(p) not in blocks],
             mesh.dp_group if mesh.mp == 1 else dist.group.WORLD, mesh.world)]
    if blocks:
        runs.append(([p.grad for p in params if id(p) in blocks], mesh.dp_group, mesh.dp))
    with torch.no_grad():
        for grads, group, n in runs:
            def mean(flat, group=group, n=n):
                dist.all_reduce(flat, group=group)
                flat.div_(n)

            _bucketed(grads, mean)


def all_reduce_mean(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean over the dp group of a tensor outside autograd (metrics)."""
    out = t.detach().clone()
    dist.all_reduce(out, group=mesh.dp_group)
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
    """Every dp rank's (n, ...) slice -> the (dp * n, ...) whole, in dp
    order, on every rank of the dp group; differentiable (see
    _GatherRows)."""
    return _GatherRows.apply(x, mesh.dp_group, mesh.dp, mesh.dp_index)


# --- the mp axis: tensor-parallel Linears ------------------------------------

class _CopyToMP(torch.autograd.Function):
    """The input of a column-sharded Linear: unchanged forward; backward,
    its gradient summed over the mp group (the input's gradient is the sum
    over the column blocks of dy_block W_block, one a rank)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromMP(torch.autograd.Function):
    """Each mp rank's (..., gates * r) output block -> the (..., gates * mp
    * r) whole in the whole weight's row order: gate by gate, each gate's
    rows rank by rank. Backward: the rank's columns of the whole gradient
    (everything after the gather runs alike on every rank of the group, so
    each holds the same whole gradient)."""

    @staticmethod
    def forward(ctx, y, group, mp, index, gates):
        ctx.blocks = (mp, index, gates)
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(mp)]
        dist.all_gather(parts, y, group=group)
        lead = y.shape[:-1]
        whole = torch.stack([p.reshape(*lead, gates, -1) for p in parts], dim=-2)
        return whole.reshape(*lead, -1)

    @staticmethod
    def backward(ctx, grad):
        mp, index, gates = ctx.blocks
        lead = grad.shape[:-1]
        mine = grad.reshape(*lead, gates, mp, -1)[..., index, :]
        return mine.reshape(*lead, -1), None, None, None, None


@dataclass(frozen=True)
class MPShard:
    """A weight whose rows are split over an mp group of `mp` ranks:
    `gates` row blocks (an LSTM's four packed gates, else one), each cut
    into mp contiguous parts, this rank holding part `index` of each. For a
    Linear weight (out, in) that is agrl_tpu's P(None, 'mp') column block
    of the flax kernel (in, out); for an LSTM's packed (4H, in) it is the
    column blocks of flax's four gate kernels."""

    group: object
    mp: int
    index: int
    gates: int = 1

    def take(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole (rows, ...) tensor (a view)."""
        rest = whole.shape[1:]
        return whole.reshape(self.gates, self.mp, -1, *rest)[:, self.index].reshape(-1, *rest)

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block: one all_gather over the
        mp group, outside autograd; every rank of the group must call it."""
        block = block.detach().contiguous()
        parts = [torch.empty_like(block) for _ in range(self.mp)]
        dist.all_gather(parts, block, group=self.group)
        rest = block.shape[1:]
        whole = torch.stack([p.reshape(self.gates, -1, *rest) for p in parts], dim=1)
        return whole.reshape(-1, *rest)

    def linear(self, x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
        """F.linear(x, whole weight, bias) from this rank's block `weight`:
        x W_block^T on each rank, the blocks gathered along the last dim;
        the replicated bias is added to the whole output, as flax's Dense
        keeps it whole."""
        y = F.linear(_CopyToMP.apply(x, self.group), weight)
        y = _GatherFromMP.apply(y, self.group, self.mp, self.index, self.gates)
        return y if bias is None else y + bias


def _shard_blocks(module) -> dict:
    """{parameter name: row blocks} of the weights `module` may shard:
    its class's MP_BLOCKS (the port's Linear: the weight, one block; the
    LSTM: its two packed weights, four gates each)."""
    blocks = getattr(type(module), "MP_BLOCKS", None)
    if blocks is None and isinstance(module, nn.Linear):
        raise TypeError(f"{type(module).__name__} has no tensor-parallel forward: build the "
                        "model's Linears as agrl_torch.models.backbone.Linear")
    return blocks or {}


def param_shardings(mesh: Mesh, model: nn.Module, min_size: int = MIN_SHARD_SIZE) -> dict:
    """The weights of `model` that shard over 'mp', as {parameter name: row
    blocks}: agrl_tpu's rule (agrl_tpu/parallel/mesh.py:120-147) on flax's
    leaves, which shards a 2-D kernel whose last (output) dim divides by mp
    and whose size is at least `min_size`. In torch terms: a Linear weight
    (out, in) with out % mp == 0 and out * in >= min_size (one block), and
    an LSTM's packed weight_ih_l0 / weight_hh_l0 (4H, in), whose four gate
    kernels (in, H) are flax's ii/if/ig/io and hi/hf/hg/ho leaves: they
    shard when H % mp == 0 and H * in >= min_size (four blocks). Every
    other parameter replicates: flax's 1-D biases and BatchNorm vectors,
    its conv kernels (4-D, 5-D) and msppgn's (V, 1) fusion weight. With
    mp 1 nothing shards."""
    plan = {}
    if mesh.mp == 1:
        return plan
    for mname, module in model.named_modules():
        for pname, gates in _shard_blocks(module).items():
            w = getattr(module, pname)
            rows = w.shape[0] // gates
            if rows % mesh.mp == 0 and rows * w.shape[1] >= min_size:
                plan[f"{mname}.{pname}" if mname else pname] = gates
    return plan


def place_state(mesh: Mesh, model: nn.Module, optimizer=None,
                min_size: int = MIN_SHARD_SIZE) -> dict:
    """Places a whole train state on the mesh, THE placement of the CLI,
    chip_smoke and the tests (agrl_tpu/parallel/mesh.py:97-117
    `place_state`): each weight of param_shardings(mesh, model, min_size)
    becomes a Parameter holding this rank's block of its rows, its module
    forwards through MPShard.linear, and the optimizer takes the block in
    the weight's place with the block of each state tensor of the weight's
    shape (Adam's moments, a momentum buffer; a step count stays). Every
    optimizer of optim.OPTIMIZER_NAMES updates elementwise (adam and
    amsgrad: torch.optim.Adam; sgd and nesterov: torch.optim.SGD; the
    port's RMSprop, AdaBound and RAdam through torch._foreach_*
    elementwise ops, with per-step scalars from the step count alone), so a
    block's update is the block of the whole update. Every rank holds the
    whole state before (a shared seed, or the same checkpoint read, as
    agrl_tpu asks); BatchNorm statistics and the rest replicate. Returns
    the placement, {parameter name: row blocks}."""
    plan = param_shardings(mesh, model, min_size)
    swapped = {}
    for name, gates in plan.items():
        mname, _, pname = name.rpartition(".")
        module = model.get_submodule(mname)
        whole = getattr(module, pname)
        spec = MPShard(mesh.mp_group, mesh.mp, mesh.mp_index, gates)
        shard = nn.Parameter(spec.take(whole.detach()).clone(), requires_grad=whole.requires_grad)
        setattr(module, pname, shard)
        if not hasattr(module, "mp_shards"):
            module.mp_shards = {}
        module.mp_shards[pname] = spec
        swapped[id(whole)] = (whole, shard, spec)
    if optimizer is not None and swapped:
        for group in optimizer.param_groups:
            group["params"] = [swapped[id(p)][1] if id(p) in swapped else p
                               for p in group["params"]]
        for whole, shard, spec in swapped.values():
            if whole in optimizer.state:
                state = optimizer.state.pop(whole)
                optimizer.state[shard] = {
                    k: spec.take(v).clone() if torch.is_tensor(v) and v.shape == whole.shape
                    else v for k, v in state.items()}
    return plan


def sharded_weights(model: nn.Module) -> dict:
    """{parameter name: MPShard} of the weights `model` holds as mp blocks,
    in module order (the same on every rank)."""
    return {f"{mname}.{pname}" if mname else pname: spec
            for mname, module in model.named_modules()
            for pname, spec in getattr(module, "mp_shards", {}).items()}


def sharded_parameters(model: nn.Module) -> list:
    """The Parameters holding `model`'s mp blocks (average_gradients'
    `shards`)."""
    return [getattr(module, pname) for module in model.modules()
            for pname in getattr(module, "mp_shards", {})]


@contextmanager
def whole_weights(model: nn.Module):
    """Within: every mp-sharded weight of `model` whole on every rank (one
    all_gather each over its mp group, every rank in one order), as
    agrl_tpu's Evaluator replicates the variables over the mesh before any
    eval forward (agrl_tpu/engine/evaluator.py:96-109); the graph layers'
    eval forward is then K1 on the whole W. After: the blocks back, as they
    were. A model with no shard is left alone."""
    held = []
    try:
        for name, spec in sharded_weights(model).items():
            mname, _, pname = name.rpartition(".")
            module = model.get_submodule(mname)
            block = getattr(module, pname)
            setattr(module, pname, nn.Parameter(spec.gather(block), requires_grad=False))
            del module.mp_shards[pname]
            held.append((module, pname, block, spec))
        yield
    finally:
        for module, pname, block, spec in held:
            setattr(module, pname, block)
            module.mp_shards[pname] = spec


def gather_state(model: nn.Module, optimizer=None) -> tuple:
    """(model state dict, optimizer state dict) of a placed model with every
    mp block gathered whole: the dicts a run without mp holds, reference
    names and full shapes. A collective: every rank calls it, in the same
    order, before any rank-0 gate (agrl_tpu/core/checkpoint.py:54-88). The
    whole tensors are new; the rest are the live ones, as state_dict()
    hands them out."""
    specs = sharded_weights(model)
    state = model.state_dict()
    for name, spec in specs.items():
        state[name] = spec.gather(state[name])
    if optimizer is None:
        return state, None
    optim = optimizer.state_dict()
    # Optimizer.state_dict numbers the parameters in param_groups order
    index = {id(p): i for i, p in enumerate(
        p for group in optimizer.param_groups for p in group["params"])}
    params = dict(model.named_parameters())
    for name, spec in specs.items():
        p = params[name]
        entry = optim["state"].get(index.get(id(p)))
        if entry is None:
            continue
        entry = dict(entry)  # the live optimizer's own dict: not written
        for k in sorted(entry):
            if torch.is_tensor(entry[k]) and entry[k].shape == p.shape:
                entry[k] = spec.gather(entry[k])
        optim["state"][index[id(p)]] = entry
    return state, optim
