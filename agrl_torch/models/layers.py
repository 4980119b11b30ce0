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

`l1_normalize`, `l2_affinity` and the vertex pair mask live beside the
fused op they feed (ops/graph_conv.py) and are re-exported here, where
agrl_tpu keeps them. `blend_graph_l2` is agrl_tpu's fused pose + l2
graph with its hand-written backward: off every production path in
agrl_tpu (measured neutral there), kept as tested infrastructure.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from agrl_torch.models.backbone import BN_EPS, BatchNorm1d
from agrl_torch.ops.graph_conv import (
    blended_graph,
    graph_mode,
    graph_propagate,
    graph_propagate_v2,
    l1_normalize,
    l2_affinity,
)
from agrl_torch.ops.graph_conv import pair_mask as _pair_mask

__all__ = [
    "BNNeck", "GraphConvLayer", "blend_graph_l2", "l1_normalize", "l2_affinity",
    "temporal_attention",
]


class GraphConvLayer(nn.Module):
    """Adaptive graph convolution with residual learning — the vmgn/gsta
    variant (vmgn.py:68-172): no diagonal mask, gamma 0.1, convex
    residual, and the graph of agrl_tpu/models/layers.py:219-238 by flags:
    pose and l2 learned graphs averaged (both, the paper's), the
    row-normalized pose graph alone (`use_pose`) or the row-normalized l2
    affinity alone (`learn_graph`); the fused op's `mode` ("both", "pose",
    "learned"). Neither raises, as agrl_tpu's layer asserts.

    The eval forward IS ops.graph_conv.graph_propagate on this layer's
    `linear.weight` and `bn` buffers: the CUDA kernel on the card, its
    plain version on the CPU; a bf16 input takes K2's entry,
    graph_propagate_v2 (f and adj held in bf16, float32 math). The bf16
    eval hands float32 vertex features with bf16-rounded weights, BN
    vectors and adjacency: K1 widens them exactly and computes in float32,
    as agrl_tpu's promotion does (agrl_tpu/models/layers.py:203-252). The
    output is float32 either way. The train forward is the plain composition
    of agrl_tpu/models/layers.py:219-251 under autograd (BN on batch
    statistics, which the eval kernel's fusion cannot take). Variants no
    VMGN flag reaches raise NotImplementedError (ROADMAP A7): `dot`
    affinity, `mask_diag`, the `additive` residual.
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
                (in_features != out_features, "in_features != out_features"),
            ) if bad
        ]
        if unsupported:
            raise NotImplementedError(f"GraphConvLayer: {', '.join(unsupported)} not ported yet")
        self.mode = graph_mode(use_pose, learn_graph)
        self.gamma = gamma
        self.linear = nn.Linear(in_features, out_features, bias=False)
        self.bn = BatchNorm1d(out_features, eps=BN_EPS)

    def init_weights(self, generator: torch.Generator) -> None:
        """Reference _init_params (vmgn.py:137-140): Linear ~ N(0, 0.01)."""
        with torch.no_grad():
            self.linear.weight.normal_(0.0, 0.01, generator=generator)

    def forward(self, x: torch.Tensor, adj: torch.Tensor, vertex_mask=None) -> torch.Tensor:
        """x: (B, V, C); adj: (B, V, V) pose graph. Returns (B, V, C).

        `vertex_mask` (B, V) of 0/1 marks padding vertices (0): the pose
        adjacency and the learned affinity (those the mode uses) are zeroed
        to and from them
        before row normalization, so real vertices aggregate exactly what an
        unpadded run would (agrl_tpu/models/layers.py:192-236). In train
        mode BN's batch statistics still take every row, as agrl_tpu's do."""
        bn = self.bn
        if not self.training:
            propagate = graph_propagate_v2 if x.dtype == torch.bfloat16 else graph_propagate
            var = bn.running_var
            if var.dtype != torch.float32:
                # the bf16 eval's rounded statistics: the kernel takes the
                # variance whose float32 rsqrt(var + eps) is flax's bf16 one
                # (BatchNorm.inv_std)
                var = bn.inv_std().float().pow(-2) - bn.eps
            return propagate(
                x, adj, self.linear.weight.t(), bn.weight, bn.bias,
                bn.running_mean, var, self.gamma, vertex_mask=vertex_mask, mode=self.mode,
            )
        B, V, C = x.shape
        h_prime = torch.matmul(blended_graph(x, adj, vertex_mask, self.mode), self.linear(x))
        # BatchNorm over all (B * V) vertex rows, as BN1d(view(N * V, C))
        h_prime = F.leaky_relu(bn(h_prime.reshape(B * V, C)).reshape(B, V, C), 0.1)
        return (1.0 - self.gamma) * x + self.gamma * h_prime


def _blend_graph_l2_math(x: torch.Tensor, adj: torch.Tensor):
    """agrl_tpu/models/layers.py:79-95: the pose adjacency and the l2
    affinity, each row-L1-normalized, averaged; with the intermediates the
    backward reuses."""
    x = x.float()
    ra = torch.clamp(adj.abs().sum(dim=2, keepdim=True), min=1e-12)
    adjn = adj / ra
    sq = (x * x).sum(dim=2)
    d2 = sq[:, None, :] + sq[:, :, None] - 2.0 * torch.matmul(x, x.transpose(1, 2))
    d = torch.sqrt(torch.clamp(d2, min=1e-12))
    sim = 2.0 * torch.sigmoid(-d)
    r = torch.clamp(sim.sum(dim=2, keepdim=True), min=1e-12)  # sim > 0
    return (adjn + sim / r) / 2.0, (adjn, ra, d2, d, sim, r)


class _BlendGraphL2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, adj):
        G, (adjn, ra, d2, d, sim, r) = _blend_graph_l2_math(x, adj)
        ctx.save_for_backward(x.float(), adj, adjn, ra, d2, d, sim, r)
        ctx.dtypes = (x.dtype, adj.dtype)
        return G

    @staticmethod
    def backward(ctx, dG):
        x, adj, adjn, ra, d2, d, sim, r = ctx.saved_tensors
        dG = dG.float()
        dgn = 0.5 * dG
        # learned branch: the row normalization, the sigmoid, the sqrt and
        # its clamp, then the pairwise distances
        dsim = (dgn - (dgn * sim).sum(dim=2, keepdim=True) / r) / r
        dd = dsim * (-sim * (1.0 - 0.5 * sim))
        dd2 = torch.where(d2 > 1e-12, dd / (2.0 * d), torch.zeros_like(dd))
        M = dd2 + dd2.transpose(1, 2)
        dx = 2.0 * (M.sum(dim=2, keepdim=True) * x - torch.matmul(M, x))
        # pose branch: l1_normalize's numerator is adj (not |adj|), and its
        # clamped row sums pass no gradient; d|a|/da is +1 at 0, as JAX's
        dadjn = 0.5 * dG
        s = adj.abs().sum(dim=2, keepdim=True)
        dabs = torch.where(adj >= 0, 1.0, -1.0)
        denom = torch.where(s > 1e-12, dabs * ((dadjn * adjn).sum(dim=2, keepdim=True) / ra),
                            torch.zeros_like(dabs))
        dadj = dadjn / ra - denom
        return dx.to(ctx.dtypes[0]), dadj.to(ctx.dtypes[1])


def blend_graph_l2(x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """The pose + l2 graph (B, V, V) of x (B, V, C) and adj (B, V, V),
    row_l1(adj) and row_l1(l2_affinity(x)) averaged, with the closed-form
    backward of agrl_tpu's `blend_graph_l2` custom VJP
    (agrl_tpu/models/layers.py:98-159): a few (B, V, V) elementwise passes
    and one (B, V, V) x (B, V, C) product in place of autograd's chain."""
    return _BlendGraphL2.apply(x, adj)


class BNNeck(BatchNorm1d):
    """BatchNorm bottleneck whose bias is frozen at zero (the reference
    keeps the bias entry in its state dict, so the port does too)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS)
        self.bias.requires_grad_(False)


def temporal_attention(feat: torch.Tensor, frame_mask=None) -> torch.Tensor:
    """Norm-driven temporal fusion (vmgn.py:270-278).

    feat: (B, S, P, C) -> (B, P, C); weights = L1-normalized (over S)
    per-(frame, part) L2 feature norms. `frame_mask` (B, S) zeroes the
    weights of padding frames before the normalization, so the fused
    feature equals an unpadded run's (bucketed `--test-sample all`)."""
    att = torch.linalg.vector_norm(feat, dim=3, keepdim=True)  # (B, S, P, 1)
    if frame_mask is not None:
        att = att * frame_mask[:, :, None, None]
    att = l1_normalize(att, dim=1)
    return (feat * att).sum(dim=1)
