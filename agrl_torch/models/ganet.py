"""GANet — GSTA with per-stripe position attention (PAM) and the graph
layers' outputs concatenated (counterpart of agrl_tpu/models/ganet.py;
reference torchreid/models/ganet.py:98-477):

  * pyramid STRIPE SLICING of layer4's map, rows h // n per stripe
    (ganet.py:386-391), not adaptive pooling;
  * PAM per stripe; the stripe feature is the spatial mean of
    pam_out + stripe = 2 * stripe + gamma * attended (ganet.py:393-397);
  * `num_gb` graph layers with a zeroed diagonal, gamma 0.0 (a plain
    float) and the additive residual (ganet.py:253-274): K1 with
    `mask_diag` and `additive` in eval;
  * the vertex features and every layer's output concatenated,
    (num_gb + 1) * 2048 = 6,144-d, fused by temporal attention -> one
    BNNeck and classifier; the consistent loss drops one frame per sample,
    as GSTA's.

CAM (ganet.py:135-167) is defined and no forward calls it, as in
agrl_tpu. PAM is frame-local, so under `frame_mask` padding frames touch
only their own vertices, which the graph layers and the fusion exclude.
"""

from __future__ import annotations

import torch
from torch import nn

from agrl_torch.models.backbone import Conv2d, Linear
from agrl_torch.models.gsta import GSTA
from agrl_torch.models.layers import BNNeck, GraphConvLayer
from agrl_torch.models.vmgn import FEATURE_DIM


class PAM(nn.Module):
    """Position attention (ganet.py:98-132): softmax(q k^T) over the
    stripe's pixels; returns (gamma * attended + x, attended). 1x1 convs
    with bias; `gamma` a learnable (1,) starting at 0."""

    def __init__(self, in_dim: int):
        super().__init__()
        self.query_conv = Conv2d(in_dim, in_dim // 8, 1)
        self.key_conv = Conv2d(in_dim, in_dim // 8, 1)
        self.value_conv = Conv2d(in_dim, in_dim, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor):
        """x: (N, C, H, W) -> ((N, C, H, W), (N, C, H, W))."""
        N, C, H, W = x.shape
        q = self.query_conv(x).reshape(N, -1, H * W)
        k = self.key_conv(x).reshape(N, -1, H * W)
        v = self.value_conv(x).reshape(N, C, H * W)
        attention = torch.softmax(torch.bmm(q.transpose(1, 2), k), dim=-1)  # (N, HW, HW)
        out = torch.bmm(v, attention.transpose(1, 2)).reshape(N, C, H, W)
        return self.gamma * out + x, out


class CAM(nn.Module):
    """Channel attention (ganet.py:135-167); no forward of GANet calls it."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, C, H, W = x.shape
        flat = x.reshape(N, C, H * W)
        energy = torch.bmm(flat, flat.transpose(1, 2))  # (N, C, C)
        attention = torch.softmax(energy.amax(dim=-1, keepdim=True) - energy, dim=-1)
        return self.gamma * torch.bmm(attention, flat).reshape(N, C, H, W) + x


class GANet(GSTA):
    def __init__(
        self,
        num_classes: int,
        layers=(3, 4, 6, 3),
        num_split: int = 4,
        pyramid_part: bool = True,
        num_gb: int = 2,
        use_pose: bool = True,
        learn_graph: bool = True,
        loss=frozenset({"xent", "htri"}),
        consistent_loss: bool = False,
        dtype: torch.dtype | None = None,
    ):
        super().__init__(num_classes, layers, num_split, pyramid_part, num_gb, use_pose,
                         learn_graph, loss, consistent_loss, dtype)
        self.pam_layer = PAM(FEATURE_DIM)
        self.graph_layers = nn.ModuleList(
            GraphConvLayer(FEATURE_DIM, FEATURE_DIM, learn_graph=learn_graph, use_pose=use_pose,
                           gamma=0.0, mask_diag=True, residual="additive")
            for _ in range(num_gb)
        )
        width = (num_gb + 1) * FEATURE_DIM
        self.bottleneck = BNNeck(width)
        self.classifier = Linear(width, num_classes, bias=False)

    def pool_vertices(self, fmap: torch.Tensor, B: int, S: int) -> torch.Tensor:
        """Each split's stripes of h // n rows through PAM, one batch per
        split (the attention stays within a stripe), then each stripe's
        mean of pam_out + stripe; frame-major (B, S * total_split, c)."""
        N, c, h, w = fmap.shape
        parts = []
        for n in self.total_split_list:
            step = h // n
            stripes = (fmap[:, :, : n * step].reshape(N, c, n, step, w).transpose(1, 2)
                       .reshape(N * n, c, step, w))
            pam_f, _ = self.pam_layer(stripes)
            parts.append((pam_f + stripes).mean(dim=(2, 3)).reshape(N, n, c))
        return torch.cat(parts, dim=1).reshape(B, S * self.total_split, c)

    def forward(
        self, x: torch.Tensor, adj: torch.Tensor, frame_mask=None, *,
        generator: torch.Generator | None = None, subclip_indices=None,
    ):
        """As GSTA's forward; the eval feature is (B, (num_gb + 1) * 2048)."""
        B, S = x.shape[:2]
        f, fm, vmask = self.vertex_features(x, frame_mask)
        outs = [f]
        for layer in self.graph_layers:
            outs.append(layer(outs[-1], adj, vertex_mask=vmask))
        f = torch.cat(outs, dim=2).reshape(B, S, self.total_split, -1)
        return self.fuse(f, fm, generator, subclip_indices)


def ganet(num_classes, loss=frozenset({"xent", "htri"}), last_stride=1, num_split=4, num_gb=2,
          num_scale=1, knn=16, pyramid_part=True, use_pose=True, learn_graph=True,
          consistent_loss=False, dtype=None, **kwargs):
    """Factory with agrl_tpu's signature (agrl_tpu/models/ganet.py:197):
    `last_stride`, `num_scale` and `knn` are dropped, other keywords
    ignored."""
    del last_stride, num_scale, knn, kwargs
    return GANet(
        num_classes=num_classes, num_split=num_split, pyramid_part=pyramid_part, num_gb=num_gb,
        use_pose=use_pose, learn_graph=learn_graph, loss=loss, consistent_loss=consistent_loss,
        dtype=dtype,
    )
