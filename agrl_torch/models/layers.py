"""Shared model components: adaptive graph convolution, BNNeck, temporal
attention fusion. Counterpart of agrl_tpu/models/layers.py.

Parity targets in the reference:
  * GraphLayer         — torchreid/models/vmgn.py:68-172: pose adjacency
    row-L1-normalized, averaged with the row-L1-normalized l2 affinity;
    h' = graph @ (W x); BatchNorm over all (batch x vertex) rows;
    LeakyReLU(0.1); convex residual (1 - gamma) x + gamma h'.
  * BNNeck             — vmgn.py:238-239: BatchNorm1d with the bias frozen
    at zero.
  * temporal attention — vmgn.py:270-278: per-vertex L2 feature norms,
    L1-normalized over the clip axis, used as fusion weights.

`l1_normalize` and `l2_affinity` live beside the fused op they feed
(ops/graph_conv.py) and are re-exported here, where agrl_tpu keeps them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from agrl_torch.models.backbone import BN_EPS, BatchNorm1d
from agrl_torch.ops.graph_conv import blended_graph, graph_propagate, l1_normalize, l2_affinity

__all__ = [
    "BNNeck", "GraphConvLayer", "l1_normalize", "l2_affinity", "temporal_attention",
]


class GraphConvLayer(nn.Module):
    """Adaptive graph convolution with residual learning — the vmgn/gsta
    variant (vmgn.py:68-172): pose graph and l2 learned graph averaged, no
    diagonal mask, gamma 0.1, convex residual.

    The eval forward IS ops.graph_conv.graph_propagate on this layer's
    `linear.weight` and `bn` buffers: the CUDA kernel on the card, its
    plain version on the CPU. The train forward is the plain composition
    of agrl_tpu/models/layers.py:219-251 under autograd (BN on batch
    statistics, which the eval kernel's fusion cannot take). Variants no
    path of the port runs yet raise NotImplementedError: `dot` affinity,
    `mask_diag`, the `additive` residual, pose-only or learned-only graphs,
    `vertex_mask`.
    """

    def __init__(
        self,
        in_features: int,
        out_features: int,
        learn_graph: bool = True,
        use_pose: bool = True,
        dist_method: str = "l2",
        gamma: float = 0.1,
        mask_diag: bool = False,
        residual: str = "convex",
    ):
        super().__init__()
        unsupported = [
            msg for bad, msg in (
                (dist_method != "l2", f"dist_method={dist_method!r}"),
                (mask_diag, "mask_diag"),
                (residual != "convex", f"residual={residual!r}"),
                (not (learn_graph and use_pose), "a graph without both pose and l2 parts"),
                (in_features != out_features, "in_features != out_features"),
            ) if bad
        ]
        if unsupported:
            raise NotImplementedError(f"GraphConvLayer: {', '.join(unsupported)} not ported yet")
        self.gamma = gamma
        self.linear = nn.Linear(in_features, out_features, bias=False)
        self.bn = BatchNorm1d(out_features, eps=BN_EPS)

    def init_weights(self, generator: torch.Generator) -> None:
        """Reference _init_params (vmgn.py:137-140): Linear ~ N(0, 0.01)."""
        with torch.no_grad():
            self.linear.weight.normal_(0.0, 0.01, generator=generator)

    def forward(self, x: torch.Tensor, adj: torch.Tensor, vertex_mask=None) -> torch.Tensor:
        """x: (B, V, C); adj: (B, V, V) pose graph. Returns (B, V, C)."""
        if vertex_mask is not None:
            raise NotImplementedError("GraphConvLayer vertex_mask is not ported yet")
        bn = self.bn
        if not self.training:
            return graph_propagate(
                x, adj, self.linear.weight.t(), bn.weight, bn.bias,
                bn.running_mean, bn.running_var, self.gamma,
            )
        B, V, C = x.shape
        h_prime = torch.matmul(blended_graph(x, adj), self.linear(x))
        # BatchNorm over all (B * V) vertex rows, as BN1d(view(N * V, C))
        h_prime = F.leaky_relu(bn(h_prime.reshape(B * V, C)).reshape(B, V, C), 0.1)
        return (1.0 - self.gamma) * x + self.gamma * h_prime


class BNNeck(BatchNorm1d):
    """BatchNorm bottleneck whose bias is frozen at zero (the reference
    keeps the bias entry in its state dict, so the port does too)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS)
        self.bias.requires_grad_(False)


def temporal_attention(feat: torch.Tensor) -> torch.Tensor:
    """Norm-driven temporal fusion (vmgn.py:270-278).

    feat: (B, S, P, C) -> (B, P, C); weights = L1-normalized (over S)
    per-(frame, part) L2 feature norms."""
    att = torch.linalg.vector_norm(feat, dim=3, keepdim=True)  # (B, S, P, 1)
    att = l1_normalize(att, dim=1)
    return (feat * att).sum(dim=1)
