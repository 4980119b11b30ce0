"""The training step (counterpart of agrl_tpu/engine/trainer.py).

Behavioral parity with the reference train() iteration
(train_vidreid_xent_htri.py:393-413):
  loss = lambda_xent * DeepSupervision(xent, outputs, pids)
       + lambda_htri * DeepSupervision(htri, features, pids)
  backward + optimizer step; top-1 precision over all heads is averaged
  for the meter (train_vidreid_xent_htri.py:419).

Everything runs on the model's device. Parameters, Adam's state and the
losses are fp32; a model built with dtype=torch.bfloat16 (`--bf16-train`,
agrl_tpu/models/vmgn.py:65-68) computes its trunk and layer4 in bf16 from
those fp32 parameters and hands fp32 features to the heads, so no loss
scaling is needed (bf16 keeps fp32's exponent range). The batch-hard
triplet term goes through losses.batch_hard_triplet_heads: on the card,
one forward and one backward launch of the mining kernels per step for
all heads (the consistent loss's 5).

`remat` is agrl_tpu's gradient rematerialization
(agrl_tpu/engine/trainer.py:72-82): one checkpoint around the model
forward, the losses outside it (so the mining kernels still launch once
each way). `full` saves nothing (torch.utils.checkpoint, non-reentrant);
`dots` saves the outputs of the products with no batch dimension
(`aten.mm`/`aten.addmm`, as jax's dots_with_no_batch_dims_saveable) and
recomputes the rest, convolutions and batched products included. The
recompute leaves the BN running statistics alone (they are updated once,
by the first forward) and takes the consistent-loss subclips drawn
before the forward, so it computes the first forward's values.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from functools import partial

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


def _remat_contexts(remat: str):
    """checkpoint's context_fn: (forward context, recompute context)."""
    # imported here: a serving host imports this package and no model code
    from agrl_torch.models.backbone import frozen_running_stats

    def contexts():
        if remat == "dots":
            forward, recompute = create_selective_checkpoint_contexts(_save_products)
        else:
            forward, recompute = nullcontext(), nullcontext()
        return forward, _both(recompute, frozen_running_stats())

    return contexts


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
):
    """Returns train_step(imgs, pids, adj, *, generator, flip=None,
    subclip_indices=None) -> metrics.

    With `aug` (e.g. {"flip_aug": True, "rand_erase": True}, the keywords
    of preprocess_clips), `imgs` is the raw uint8 (B, S, H, W, 3) batch
    and is preprocessed on the device; without it, `imgs` is already the
    normalized float batch. `generator` (a CPU torch.Generator) draws the
    augmentations and then the consistent-loss subclips; `flip` and
    `subclip_indices` inject the flips and the subclips instead. `remat` is
    none, dots or full (module docstring). Each call sets every
    param group's lr to `lr_fn(step)` (step = updates taken so far)
    before the optimizer step, as optax reads lr(count) before counting.
    `start_step` is the count already taken: a run resumed after epoch e
    passes (e + 1) * steps_per_epoch, as agrl_tpu's CLI sets its state's
    step, so the schedule goes on where it stopped.

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

    def forward(x, adj, subclips):
        return model(x, adj, subclip_indices=subclips)

    def train_step(imgs, pids, adj, *, generator=None, flip=None, subclip_indices=None):
        nonlocal step
        imgs = torch.as_tensor(imgs).to(device, non_blocking=True)
        pids = torch.as_tensor(pids).to(device, torch.int64, non_blocking=True)
        adj = torch.as_tensor(adj).to(device, torch.float32, non_blocking=True)
        x = imgs if aug is None else preprocess_clips(
            imgs, train=True, generator=generator, flip=flip, **aug
        )
        # drawn before the forward, so a recompute takes the same frames
        subclips = (model.subclip_indices(x.shape[1], generator, subclip_indices)
                    if getattr(model, "consistent_loss", False) else None)

        model.train()
        if remat == "none":
            outputs, features = forward(x, adj, subclips)
        else:
            outputs, features = checkpoint(forward, x, adj, subclips, use_reentrant=False,
                                           context_fn=_remat_contexts(remat))
        xent = deep_supervision(xent_fn, outputs, pids)
        htri = batch_hard_triplet_heads(features, pids, margin=margin, soft=soft_margin)
        loss = lambda_xent * xent + lambda_htri * htri

        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = lr_fn(step)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        step += 1

        with torch.no_grad():
            top1 = torch.stack(
                [(o.argmax(dim=1) == pids).float().mean() for o in outputs]
            ).mean()
        return {
            "loss": loss.detach(),
            "xent_loss": xent.detach(),
            "htri_loss": htri.detach(),
            "top1": top1,
        }

    return train_step
