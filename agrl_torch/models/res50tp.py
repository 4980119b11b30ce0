"""ResNet50-TP and ResNet50-S1 (counterpart of agrl_tpu/models/res50tp.py).

`res50tp` (reference torchreid/models/res50tp.py:111-235): ResNet-50 with
layer4 at `last_stride`, 4-part pooling, temporal attention from the
L1-normalized per-part feature norms over frames (padding frames weigh 0
under `frame_mask`), the weighted sum, the mean over parts, a BNNeck
and a classifier with no bias. Eval: the 2048-d bottleneck output;
train: (y, f), f taken before the BN.

`resnet50_s1` (reference models/resnet50_s1.py:109-228): global average
pooling per frame, a per-frame BNNeck (its train statistics over B * S
rows) and per-frame logits; train logits and features and the eval
feature are the frame means, a masked mean under `frame_mask`.

Neither reads the adjacency, and neither takes a dtype: the factories
drop it, as agrl_tpu's do, so they follow their input.
"""

from __future__ import annotations

import torch
from torch import nn

from agrl_torch.models.backbone import Linear, ResLayer, ResNetTrunk
from agrl_torch.models.gsta import check_loss
from agrl_torch.models.layers import BNNeck, l1_normalize
from agrl_torch.models.vmgn import FEATURE_DIM


class _SingleLayer4(ResNetTrunk):
    """The trunk and one layer4, a BNNeck and a bias-free classifier with
    the reference's _init_params (convs kaiming, BN 1/0, Linear
    N(0, 0.01))."""

    supports_frame_mask = True

    def __init__(self, num_classes, layers, last_stride, loss):
        super().__init__(layers)
        self.loss = check_loss(loss)
        self.layer4 = ResLayer(1024, 512, layers[3], stride=last_stride)
        self.bottleneck = BNNeck(FEATURE_DIM)
        self.classifier = Linear(FEATURE_DIM, num_classes, bias=False)

    def init_weights(self, generator: torch.Generator) -> None:
        self.init_backbone(generator)
        with torch.no_grad():
            self.classifier.weight.normal_(0.0, 0.01, generator=generator)

    def feature_map(self, x: torch.Tensor, frame_mask) -> torch.Tensor:
        """(B, S, H, W, 3) -> layer4's (B * S, 2048, h, w)."""
        if frame_mask is not None and self.training:
            raise ValueError("frame_mask is an eval-only contract (batch BN mixes rows)")
        B, S, H, W, C = x.shape
        return self.layer4(self.forward_trunk(x.reshape(B * S, H, W, C).permute(0, 3, 1, 2)))

    def heads(self, y: torch.Tensor, f: torch.Tensor):
        return y if self.loss == frozenset({"xent"}) else (y, f)


class ResNet50TP(_SingleLayer4):
    def __init__(self, num_classes: int, layers=(3, 4, 6, 3), last_stride: int = 1,
                 parts: int = 4, loss=frozenset({"xent", "htri"})):
        super().__init__(num_classes, layers, last_stride, loss)
        self.parts = parts

    def forward(self, x: torch.Tensor, adj=None, frame_mask=None):
        """x: (B, S, H, W, 3); `adj` is not read. Eval: (B, 2048)."""
        B, S = x.shape[:2]
        fmap = self.feature_map(x, frame_mask)
        v_g = self.part_pool(fmap, (self.parts,)).reshape(B, S, self.parts, -1)
        att = torch.linalg.vector_norm(v_g, dim=3, keepdim=True)
        if frame_mask is not None:  # padding frames weigh exactly 0
            att = att * frame_mask.float()[:, :, None, None]
        f = (v_g * l1_normalize(att, dim=1)).sum(dim=1).mean(dim=1)
        bn = self.bottleneck(f)
        if not self.training:
            return bn
        return self.heads(self.classifier(bn), f)


class ResNet50S1(_SingleLayer4):
    def __init__(self, num_classes: int, layers=(3, 4, 6, 3), last_stride: int = 1,
                 loss=frozenset({"xent", "htri"})):
        super().__init__(num_classes, layers, last_stride, loss)

    def forward(self, x: torch.Tensor, adj=None, frame_mask=None):
        """x: (B, S, H, W, 3); `adj` is not read. Eval: (B, 2048)."""
        B, S = x.shape[:2]
        f = self.feature_map(x, frame_mask).mean(dim=(2, 3))  # (B * S, c)
        bn = self.bottleneck(f)
        if not self.training:
            bnr = bn.reshape(B, S, -1)
            if frame_mask is None:
                return bnr.mean(dim=1)
            # eval BN is per element: padding rows never touch real ones
            fm = frame_mask.float()
            return (bnr * fm[:, :, None]).sum(dim=1) / fm.sum(dim=1)[:, None]
        y = self.classifier(bn).reshape(B, S, -1).mean(dim=1)
        return self.heads(y, f.reshape(B, S, -1).mean(dim=1))


def res50tp(num_classes=100, loss=frozenset({"xent", "htri"}), last_stride=1, **kwargs):
    """agrl_tpu's factory (agrl_tpu/models/res50tp.py:124): other keywords,
    `dtype` among them, are dropped."""
    return ResNet50TP(num_classes=num_classes, loss=loss, last_stride=last_stride)


def resnet50_s1(num_classes=100, loss=frozenset({"xent", "htri"}), last_stride=1, **kwargs):
    """agrl_tpu's factory (agrl_tpu/models/res50tp.py:128): other keywords
    dropped."""
    return ResNet50S1(num_classes=num_classes, loss=loss, last_stride=last_stride)
