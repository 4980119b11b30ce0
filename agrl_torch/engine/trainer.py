"""The training step (counterpart of agrl_tpu/engine/trainer.py).

Behavioral parity with the reference train() iteration
(train_vidreid_xent_htri.py:393-413):
  loss = lambda_xent * DeepSupervision(xent, outputs, pids)
       + lambda_htri * DeepSupervision(htri, features, pids)
  backward + optimizer step; top-1 precision over all heads is averaged
  for the meter (train_vidreid_xent_htri.py:419); msppn and msppgn give
3 * total_split + 1 heads (22 at --num-split 4). Single-head archs
  (res50tp, resnet50_s1, sta, simple_sta, gsta/ganet without the
  consistent loss) return bare tensors, taken as one head, as agrl_tpu's
  trainer takes them (agrl_tpu/engine/trainer.py:90-91).

Everything runs on the model's device. Parameters, Adam's state and the
losses are fp32; a model built with dtype=torch.bfloat16 (`--bf16-train`,
agrl_tpu/models/vmgn.py:65-68) computes its trunk and layer4 in bf16 from
those fp32 parameters and hands fp32 features to the heads, so no loss
scaling is needed (bf16 keeps fp32's exponent range). The batch-hard
triplet term goes through losses.batch_hard_triplet_heads: on the card,
one forward and one backward launch of the mining kernels per step for
all heads (VMGN's consistent loss's 5, gsta's and ganet's 2, msppn's and
msppgn's 22, or one).

`remat` is agrl_tpu's gradient rematerialization
(agrl_tpu/engine/trainer.py:72-82): one checkpoint around the model
forward, the losses outside it (so the mining kernels still launch once
each way). `full` saves nothing (torch.utils.checkpoint, non-reentrant);
`dots` saves the outputs of the products with no batch dimension
(`aten.mm`/`aten.addmm`, as jax's dots_with_no_batch_dims_saveable) and
recomputes the rest, convolutions and batched products included. The
recompute leaves the BN running statistics alone (they are updated once,
by the first forward) and takes the consistent-loss draw made before the
forward (the model's `draw_subclips`: VMGN's subclips, gsta's and
ganet's dropped frames), so it computes the first forward's values.

`mesh` (the process-group form of parallel.make_mesh) makes the step
data-parallel over its dp axis: each dp index passes its slice of the
global batch, and the step computes agrl_tpu's single-device step on the
global batch (agrl_tpu/engine/trainer.py, GSPMD over the 'dp' axis):
  * every rank draws the augmentations and the consistent-loss draw for
    the GLOBAL batch from its identically seeded generator (injected
    `flip` and `subclip_indices` are the global batch's) and keeps its dp
    slice, so a run of dp ranks sees the flips, erasures, crops and
    subclips of a one-rank run of the same seed;
  * train-mode BatchNorms take the global batch's statistics over the dp
    group (models/backbone.py `global_batch_stats`, also in the recompute);
  * the batch-hard mining gathers the global batch over the dp group
    (losses.batch_hard_triplet_heads); cross-entropy is the rank's slice
    mean, whose average over the dp group is the global mean because the
    slices are equal;
  * the gradients are averaged over the dp group
    (parallel.average_gradients, in buckets) before the optimizer step, so
    the ranks of a dp group take the same update;
  * the metrics are averaged over the dp group: every rank returns the
    global batch's loss, xent_loss, htri_loss and top1.
With an mp axis (`--mesh-mp`: parallel.place_state has sharded the wide
Linears and their optimizer state), the mp ranks of one dp index pass the
same slice and draw the same augmentations. A sharded Linear computes its
column block, gathers the whole output over the mp group and sums its
input's gradient over it (parallel.MPShard), so everything after it (the
graph, BN and residual of a train-mode graph layer, the heads, the
losses, K3 on the dp-gathered features) runs alike on every rank of an
mp group: the replicated parameters' gradients agree there in exact
arithmetic. They are averaged over every rank of the mesh, which is
their dp mean and keeps them bit-equal across the mp group on a card,
whose backward kernels do not sum in a fixed order; the blocks' over the
dp group. Either mean divides the gathered mining's dp-fold sum once.
Without a mesh nothing of this runs: no collective, no global draw.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from functools import partial

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from agrl_torch.data.transforms import preprocess_clips
from agrl_torch.losses import (
    batch_hard_triplet_heads,
    cross_entropy_label_smooth,
    deep_supervision,
)


REMAT_POLICIES = ("none", "dots", "full")
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


@contextmanager
def _both(first, second):
    with first, second:
        yield


def _remat_contexts(remat: str, bn_context):
    """checkpoint's context_fn: (forward context, recompute context). The
    recompute runs in the backward, outside the step's `bn_context`, so it
    enters it again."""
    # imported here: a serving host imports this package and no model code
    from agrl_torch.models.backbone import frozen_running_stats

    def contexts():
        if remat == "dots":
            forward, recompute = create_selective_checkpoint_contexts(_save_products)
        else:
            forward, recompute = nullcontext(), nullcontext()
        return forward, _both(_both(recompute, bn_context()), frozen_running_stats())

    return contexts


def _global_draws(aug: dict, shape, generator, flip, world: int, rank: int) -> dict:
    """The augmentation draws of preprocess_clips, in its order (misalign,
    translate, flip, erase), for the global batch of `world` slices of
    shape (b, S, H, W, 3); this rank's slice of each, as its injected
    draws. An injected `flip` is the global batch's."""
    from agrl_torch.data import transforms as tt

    b, S, H, W = shape[:4]
    B = b * world
    needed = [aug.get("misalign_aug", False), aug.get("rand_translate", False),
              aug.get("flip_aug", True) and flip is None, aug.get("rand_erase", False)]
    if generator is None and any(needed):
        raise ValueError("train augmentations need a torch.Generator or their injected draws")
    draws = {}
    if aug.get("misalign_aug", False):
        draws["misalign_draws"] = tt.draw_misalign(B, generator)
    if aug.get("rand_translate", False):
        draws["translate_draws"] = tt.draw_translate(B, H, W, generator)
    if aug.get("flip_aug", True):
        draws["flip"] = (torch.as_tensor(np.asarray(flip), dtype=torch.bool) if flip is not None
                         else torch.rand(B, generator=generator) < 0.5)
        if draws["flip"].shape != (B,):
            raise ValueError(f"flip must be the global batch's ({B},) bool, "
                             f"got {tuple(draws['flip'].shape)}")
    if aug.get("rand_erase", False):
        draws["erase_draws"] = tt.draw_erase(B, S, H, W, generator)
    return {k: v[rank * b:(rank + 1) * b] for k, v in draws.items()}


def make_train_step(
    model,
    optimizer: torch.optim.Optimizer,
    lr_fn,
    lambda_xent: float = 1.0,
    lambda_htri: float = 1.0,
    label_smooth: bool = True,
    margin: float = 0.3,
    soft_margin: bool = True,
    aug: dict | None = None,
    start_step: int = 0,
    remat: str = "none",
    mesh=None,
):
    """Returns train_step(imgs, pids, adj, *, generator, flip=None,
    subclip_indices=None) -> metrics.

    With `aug` (e.g. {"flip_aug": True, "rand_erase": True}, the keywords
    of preprocess_clips), `imgs` is the raw uint8 (B, S, H, W, 3) batch
    and is preprocessed on the device; without it, `imgs` is already the
    normalized float batch. `generator` (a CPU torch.Generator) draws the
    augmentations and then the consistent-loss draw; `flip` and
    `subclip_indices` inject the flips and that draw instead (VMGN: the
    three sorted subclips; gsta, ganet: each clip's dropped frame). The
    adjacency goes to every arch, as agrl_tpu passes it; res50tp,
    resnet50_s1, sta, simple_sta and msppn do not read it. `remat` is
    none, dots or full (module docstring). Each call sets every
    param group's lr to `lr_fn(step)` (step = updates taken so far)
    before the optimizer step, as optax reads lr(count) before counting.
    `start_step` is the count already taken: a run resumed after epoch e
    passes (e + 1) * steps_per_epoch, as agrl_tpu's CLI sets its state's
    step, so the schedule goes on where it stopped. `mesh`: a process
    group's mesh, for a step on this rank's dp slice of the batch, data-
    and (after parallel.place_state) tensor-parallel (module docstring).

    The metrics `loss`, `xent_loss`, `htri_loss` and `top1` (argmax
    accuracy averaged over heads) are 0-d device tensors: nothing syncs
    with the host unless the caller reads them.

    TF32 is switched off for cuBLAS and cuDNN (process-wide): the
    l2-affinity and triplet Grams cancel near zero distance, and the
    port holds fp32 parity with agrl_tpu."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}; choices {REMAT_POLICIES}")
    low = sorted({str(p.dtype) for p in model.parameters() if p.dtype != torch.float32})
    if low:
        raise ValueError(f"the train step keeps float32 parameters (mixed precision is the "
                         f"model's dtype), got {low}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    xent_fn = partial(cross_entropy_label_smooth, epsilon=0.1 if label_smooth else 0.0)
    device = next(model.parameters()).device
    step = start_step
    if mesh is not None and not mesh.distributed:
        raise ValueError("the train step takes the process-group form of the mesh (one "
                         "process per card: parallel.initialize_distributed, make_mesh)")
    if mesh is not None and not mesh.holds(device):
        raise ValueError(f"the model is on {device}, this rank's device is {mesh.device}")
    if mesh is not None:
        from agrl_torch.models.backbone import global_batch_stats
        from agrl_torch.parallel import all_reduce_mean, average_gradients, sharded_parameters

        bn_context = partial(global_batch_stats, mesh)
    else:
        bn_context = nullcontext
    mesh_kw = {} if mesh is None else {"mesh": mesh}  # without one, today's calls

    def forward(x, adj, subclips):
        if subclips is None:
            return model(x, adj)
        return model(x, adj, subclip_indices=subclips)

    def train_step(imgs, pids, adj, *, generator=None, flip=None, subclip_indices=None):
        nonlocal step
        imgs = torch.as_tensor(imgs).to(device, non_blocking=True)
        pids = torch.as_tensor(pids).to(device, torch.int64, non_blocking=True)
        adj = torch.as_tensor(adj).to(device, torch.float32, non_blocking=True)
        if mesh is None:
            x = imgs if aug is None else preprocess_clips(
                imgs, train=True, generator=generator, flip=flip, **aug
            )
            # drawn before the forward, so a recompute takes the same frames
            subclips = (model.draw_subclips(x.shape[0], x.shape[1], generator, subclip_indices)
                        if getattr(model, "consistent_loss", False) else None)
        else:
            x, subclips = global_inputs(imgs, generator, flip, subclip_indices)

        model.train()
        with bn_context():
            if remat == "none":
                outputs, features = forward(x, adj, subclips)
            else:
                outputs, features = checkpoint(forward, x, adj, subclips, use_reentrant=False,
                                               context_fn=_remat_contexts(remat, bn_context))
        if not isinstance(outputs, (list, tuple)):  # a single-head arch
            outputs, features = [outputs], [features]
        xent = deep_supervision(xent_fn, outputs, pids)
        htri = batch_hard_triplet_heads(features, pids, margin=margin, soft=soft_margin,
                                        **mesh_kw)
        loss = lambda_xent * xent + lambda_htri * htri

        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            average_gradients(model.parameters(), mesh, shards=sharded_parameters(model))
        lr = lr_fn(step)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        step += 1

        with torch.no_grad():
            top1 = torch.stack(
                [(o.argmax(dim=1) == pids).float().mean() for o in outputs]
            ).mean()
        metrics = {
            "loss": loss.detach(),
            "xent_loss": xent.detach(),
            "htri_loss": htri.detach(),
            "top1": top1,
        }
        if mesh is not None:  # the global batch's: one all_reduce for the four
            values = all_reduce_mean(torch.stack([v.float() for v in metrics.values()]), mesh)
            metrics = dict(zip(metrics, values.unbind()))
        return metrics

    def global_inputs(imgs, generator, flip, subclip_indices):
        """The data-parallel step's input: this rank's dp slice of the
        global batch's augmentation and consistent-loss draws."""
        world, rank = mesh.dp, mesh.dp_index
        if aug is None:
            x = imgs
        else:
            x = preprocess_clips(imgs, train=True, **aug,
                                 **_global_draws(aug, imgs.shape, generator, flip, world, rank))
        if not getattr(model, "consistent_loss", False):
            return x, None
        b = x.shape[0]
        subclips = model.draw_subclips(b * world, x.shape[1], generator, subclip_indices)
        if torch.is_tensor(subclips):  # one draw per clip (gsta, ganet): the slice
            subclips = subclips[rank * b:(rank + 1) * b]
        return x, subclips

    return train_step
