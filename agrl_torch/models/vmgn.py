"""VMGN — the pose-guided adaptive-graph video re-id model, eval forward.

Counterpart of agrl_tpu/models/vmgn.py (reference GSTA as built by
`vmgn()`, torchreid/models/vmgn.py:214-357, 373-390):

  * ResNet-50 trunk (last_stride=1) shared through layer3, then two
    independent layer4 branches, `layer4_1` and `layer4_2`.
  * Global branch: layer4_1 -> mean over (S, h, w) -> BNNeck.
  * Attention branch: layer4_2 -> pyramid part pooling (a matmul against
    the adaptive-average-pool matrix) -> (B, S * total_split, 2048)
    vertices -> num_gb graph layers (the fused CUDA kernel on the card) ->
    temporal attention fusion -> mean over parts -> BNNeck.
  * Eval feature: cat([global_bn, att_bn]) — 4096-d.

Public layout follows agrl_tpu: clips (B, S, H, W, 3) float, adjacency
(B, V, V). Inside, frames go to NCHW by a permute (which gives NCHW
tensors in channels_last memory order, no copy).

Submodule names are the reference's, so agrl_tpu's name map
(weight_convert._split_torch_name) covers every entry.

Not ported yet (raise NotImplementedError): the train forward (logits,
consistent-loss subclips) and `frame_mask` (`--test-sample all`).
"""

from __future__ import annotations

import torch
from torch import nn

from agrl_torch.models.backbone import (
    Bottleneck,
    ResLayer,
    ResNetTrunk,
    adaptive_avg_pool_matrix,
    init_conv_,
)
from agrl_torch.models.layers import BNNeck, GraphConvLayer, temporal_attention
from agrl_torch.utils.reidtools import calc_splits

FEATURE_DIM = 512 * Bottleneck.expansion  # layer4 width: 2048


class VMGN(ResNetTrunk):
    def __init__(
        self,
        num_classes: int,
        layers=(3, 4, 6, 3),
        last_stride: int = 1,
        num_split: int = 4,
        pyramid_part: bool = True,
        num_gb: int = 2,
        use_pose: bool = True,
        learn_graph: bool = True,
    ):
        super().__init__(layers)
        self.total_split_list = calc_splits(num_split) if pyramid_part else [num_split]
        self.total_split = sum(self.total_split_list)
        self.layer4_1 = ResLayer(1024, 512, layers[3], stride=last_stride)
        self.layer4_2 = ResLayer(1024, 512, layers[3], stride=last_stride)
        self.global_bottleneck = BNNeck(FEATURE_DIM)
        self.att_bottleneck = BNNeck(FEATURE_DIM)
        self.global_classifier = nn.Linear(FEATURE_DIM, num_classes, bias=False)
        self.att_classifier = nn.Linear(FEATURE_DIM, num_classes, bias=False)
        self.graph_layers = nn.ModuleList(
            GraphConvLayer(FEATURE_DIM, FEATURE_DIM, learn_graph=learn_graph, use_pose=use_pose)
            for _ in range(num_gb)
        )
        self._pool_cache: dict = {}

    def init_weights(self, generator: torch.Generator) -> None:
        """Random init from one generator: convs kaiming (fan_out), BN
        scale 1 / shift 0, graph Linear N(0, 0.01), classifiers
        N(0, 0.001) (reference _init_params / weights_init_classifier)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_conv_(m, generator)
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        for layer in self.graph_layers:
            layer.init_weights(generator)
        with torch.no_grad():
            for head in (self.global_classifier, self.att_classifier):
                head.weight.normal_(0.0, 0.001, generator=generator)

    def _pool_matrix(self, h: int, ref: torch.Tensor) -> torch.Tensor:
        """(total_split, h) pyramid pooling matrix, cached per height/device."""
        key = (h, ref.device)
        if key not in self._pool_cache:
            rows = [adaptive_avg_pool_matrix(h, n) for n in self.total_split_list]
            self._pool_cache[key] = torch.cat(
                [torch.from_numpy(r) for r in rows]
            ).to(ref.device)
        return self._pool_cache[key]

    def forward(self, x: torch.Tensor, adj: torch.Tensor, frame_mask=None) -> torch.Tensor:
        """x: (B, S, H, W, 3) float; adj: (B, V, V), V = S * total_split.
        Returns the (B, 4096) eval feature."""
        if self.training:
            raise NotImplementedError("VMGN train forward is not ported yet")
        if frame_mask is not None:
            raise NotImplementedError("VMGN frame_mask (--test-sample all) is not ported yet")
        B, S, H, W, C = x.shape
        x = x.reshape(B * S, H, W, C).permute(0, 3, 1, 2)
        x3 = self.forward_trunk(x)
        x4_1 = self.layer4_1(x3)
        x4_2 = self.layer4_2(x3)
        _, c, h, w = x4_1.shape

        # global branch
        g_f = x4_1.reshape(B, S, c, h, w).mean(dim=(1, 3, 4))
        g_bn = self.global_bottleneck(g_f)

        # attention branch: pyramid part pooling
        fmap = x4_2.mean(dim=3)  # pool width -> (B*S, c, h)
        v_f = torch.matmul(self._pool_matrix(h, fmap), fmap.transpose(1, 2))  # (B*S, P, c)
        f = v_f.reshape(B, S * self.total_split, c)
        for layer in self.graph_layers:
            f = layer(f, adj)
        f = f.reshape(B, S, self.total_split, c)

        att_f = temporal_attention(f).mean(dim=1)
        att_bn = self.att_bottleneck(att_f)
        return torch.cat([g_bn, att_bn], dim=1)


def vmgn(
    num_classes,
    last_stride=1,
    num_split=4,
    num_gb=2,
    num_scale=1,
    pyramid_part=True,
    use_pose=True,
    learn_graph=True,
    **kwargs,
):
    """Factory matching the reference factory signature (vmgn.py:373-390);
    train-only arguments (`loss`, `consistent_loss`) are accepted and
    unused: the train forward is not ported yet."""
    if num_scale != 1:
        raise ValueError("vmgn's pooling produces one scale of vertices")
    return VMGN(
        num_classes=num_classes,
        layers=(3, 4, 6, 3),
        last_stride=last_stride,
        num_split=num_split,
        pyramid_part=pyramid_part,
        num_gb=num_gb,
        use_pose=use_pose,
        learn_graph=learn_graph,
    )
