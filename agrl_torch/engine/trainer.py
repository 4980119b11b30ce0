"""The training step (counterpart of agrl_tpu/engine/trainer.py).

Behavioral parity with the reference train() iteration
(train_vidreid_xent_htri.py:393-413):
  loss = lambda_xent * DeepSupervision(xent, outputs, pids)
       + lambda_htri * DeepSupervision(htri, features, pids)
  backward + optimizer step; top-1 precision over all heads is averaged
  for the meter (train_vidreid_xent_htri.py:419).

Everything runs on the model's device in fp32. The batch-hard triplet
term goes through losses.batch_hard_triplet_heads: on the card, one
forward and one backward launch of the mining kernels per step for all
heads (the consistent loss's 5).
"""

from __future__ import annotations

from functools import partial

import torch

from agrl_torch.data.transforms import preprocess_clips
from agrl_torch.losses import (
    batch_hard_triplet_heads,
    cross_entropy_label_smooth,
    deep_supervision,
)


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
):
    """Returns train_step(imgs, pids, adj, *, generator, flip=None,
    subclip_indices=None) -> metrics.

    With `aug` (e.g. {"flip_aug": True}), `imgs` is the raw uint8
    (B, S, H, W, 3) batch and is preprocessed on the device; without it,
    `imgs` is already the normalized float batch. `generator` (a CPU
    torch.Generator) draws the flips and the consistent-loss subclips;
    `flip` and `subclip_indices` inject them instead. Each call sets every
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    xent_fn = partial(cross_entropy_label_smooth, epsilon=0.1 if label_smooth else 0.0)
    device = next(model.parameters()).device
    step = start_step

    def train_step(imgs, pids, adj, *, generator=None, flip=None, subclip_indices=None):
        nonlocal step
        imgs = torch.as_tensor(imgs).to(device, non_blocking=True)
        pids = torch.as_tensor(pids).to(device, torch.int64, non_blocking=True)
        adj = torch.as_tensor(adj).to(device, torch.float32, non_blocking=True)
        x = imgs if aug is None else preprocess_clips(
            imgs, train=True, generator=generator, flip=flip, **aug
        )

        model.train()
        outputs, features = model(x, adj, generator=generator, subclip_indices=subclip_indices)
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
