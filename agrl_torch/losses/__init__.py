"""Training losses (counterpart of agrl_tpu/losses/__init__.py).

Parity targets in the reference:
  * cross_entropy_label_smooth — torchreid/losses/cross_entropy_loss.py:8-37:
    targets (1 - eps) * onehot + eps / K, loss
    (-targets * log_softmax(logits)).mean(0).sum().
  * batch-hard triplet — torchreid/losses/hard_mine_triplet_loss.py:8-50:
    per anchor the hardest positive and hardest negative distance; soft
    margin softplus(d_ap - d_an).mean() or margin ranking
    max(0, margin + d_ap - d_an).mean().
  * deep_supervision — torchreid/losses/__init__.py:9-19: mean of the
    criterion over a list of heads.

The distance + mining step is `ops.triplet.hard_mine_fused`: the CUDA
kernels on the card, its plain version (`pairwise_euclidean` +
`hard_mine`, re-exported here where agrl_tpu keeps them) on the CPU.
`batch_hard_triplet_heads` is deep_supervision(batch_hard_triplet, ...)
with every head mined in one kernel launch on the card
(`ops.triplet.hard_mine_heads`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from agrl_torch.ops.triplet import hard_mine, hard_mine_fused, hard_mine_heads, pairwise_euclidean

__all__ = [
    "cross_entropy_label_smooth",
    "batch_hard_triplet",
    "batch_hard_triplet_heads",
    "triplet_from_distances",
    "mean_over_heads",
    "pairwise_euclidean",
    "hard_mine",
    "deep_supervision",
]


def cross_entropy_label_smooth(
    logits: torch.Tensor,
    labels: torch.Tensor,
    num_classes: int | None = None,
    epsilon: float = 0.1,
) -> torch.Tensor:
    """logits (B, K); labels (B,) ints. Returns the scalar loss."""
    if num_classes is None:
        num_classes = logits.shape[-1]
    log_probs = F.log_softmax(logits, dim=1)
    onehot = F.one_hot(labels.long(), num_classes).to(log_probs.dtype)
    targets = (1.0 - epsilon) * onehot + epsilon / num_classes
    return (-targets * log_probs).mean(dim=0).sum()


def batch_hard_triplet(
    features: torch.Tensor,
    labels: torch.Tensor,
    margin: float = 0.3,
    soft: bool = True,
) -> torch.Tensor:
    """Batch-hard triplet loss. features (B, D); labels (B,)."""
    return triplet_from_distances(*hard_mine_fused(features, labels), margin, soft).mean()


def triplet_from_distances(d_ap, d_an, margin: float = 0.3, soft: bool = True):
    """Per-anchor loss from the mined distances: softplus(d_ap - d_an), or
    the margin hinge max(0, margin + d_ap - d_an)."""
    if soft:
        return F.softplus(d_ap - d_an)
    return torch.clamp(margin + d_ap - d_an, min=0.0)


def batch_hard_triplet_heads(features, labels, margin: float = 0.3, soft: bool = True,
                             mesh=None):
    """deep_supervision(batch_hard_triplet, features, labels): the mean of
    the batch-hard triplet loss over a list of (B, D) heads. CPU tensors
    take exactly that call. CUDA tensors: one forward kernel launch mines
    every head (and one backward launch gives their gradient), then each
    head's mean over B, summed over heads in deep_supervision's order and
    divided by H.

    With a process-group `mesh` (parallel.make_mesh), each rank holds its
    dp slice of the batch: every head's features (one all_gather for all
    heads) and the labels are gathered over the dp group, and the loss is
    the global batch's, equal on every rank, as agrl_tpu's loss sees the
    global array. The gather's backward sums the dp ranks' gradients of
    that one loss, so each rank's features get dp times their slice of the
    global gradient; the train step's average of the parameter gradients
    over the dp group divides by dp once. The mp ranks of one dp index
    mine the same gathered batch. K3 takes any global B, head count and
    width (above B = 256 on its long schedule)."""
    if not isinstance(features, (list, tuple)):
        features = [features]
    if mesh is not None:
        from agrl_torch.parallel import gather_rows

        features = list(gather_rows(torch.stack(list(features), dim=1), mesh).unbind(dim=1))
        labels = gather_rows(labels, mesh)
    if features[0].device.type == "cpu":
        return deep_supervision(batch_hard_triplet, features, labels, margin=margin, soft=soft)
    # the kernels read dense rows: a head that is a view (msppn's and
    # msppgn's per-vertex features) is copied
    features = [f.contiguous() for f in features]
    return mean_over_heads(triplet_from_distances(*hard_mine_heads(features, labels), margin, soft))


def mean_over_heads(per_anchor: torch.Tensor) -> torch.Tensor:
    """(H, B) per-anchor losses -> each head's mean over B, summed over the
    heads in deep_supervision's order, divided by H."""
    total = 0.0
    for loss in per_anchor.mean(dim=1):
        total = total + loss
    return total / per_anchor.shape[0]


def deep_supervision(criterion, xs, y, **kwargs) -> torch.Tensor:
    """Mean of `criterion(x, y)` over a list/tuple of head outputs."""
    if not isinstance(xs, (list, tuple)):
        xs = [xs]
    total = 0.0
    for x in xs:
        total = total + criterion(x, y, **kwargs)
    return total / len(xs)
