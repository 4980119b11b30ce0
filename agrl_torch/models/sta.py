"""STA and simple STA — spatial-temporal attention with frame picking
(counterpart of agrl_tpu/models/sta.py; reference
torchreid/models/sta.py:116-281, simple_sta.py):

  * ResNet-50, layer4 at stride 1, 4-part pooling -> v_g (B, S, 4, c);
  * scores: sta — each pixel's channel L2 norm, L2-normalized over the
    frame's pixels, part-pooled; simple_sta — the part features' norms.
    L1-normalized over frames (padding frames score 0 under `frame_mask`);
  * f_1: each part's features from its highest-scoring frame (arg-max:
    a near tie of two frames' scores flips it); f_2: the score-weighted sum;
  * concatenated (B, 4, 2c), averaged over the parts -> fc1 (Linear with
    no bias, a BatchNorm1d with flax's running-statistics rule, ReLU) ->
    the 1024-d eval feature; a classifier WITH bias.

The adjacency is not read; the factories drop `dtype`, as agrl_tpu's do.
"""

from __future__ import annotations

import torch
from torch import nn

from agrl_torch.models.backbone import BN_EPS, BatchNorm1d, Linear, ResLayer, ResNetTrunk
from agrl_torch.models.gsta import check_loss
from agrl_torch.models.layers import l1_normalize
from agrl_torch.models.vmgn import FEATURE_DIM


class STA(ResNetTrunk):
    supports_frame_mask = True

    def __init__(self, num_classes: int, layers=(3, 4, 6, 3), reduced_dim: int = 1024,
                 parts: int = 4, simple: bool = False, loss=frozenset({"xent", "htri"})):
        super().__init__(layers)
        self.loss = check_loss(loss)
        self.parts = parts
        self.simple = simple
        self.layer4 = ResLayer(1024, 512, layers[3], stride=1)
        # the reference's Sequential, so its state-dict names (fc1.0, fc1.1)
        self.fc1 = nn.Sequential(Linear(2 * FEATURE_DIM, reduced_dim, bias=False),
                                 BatchNorm1d(reduced_dim, eps=BN_EPS), nn.ReLU())
        self.classifier = Linear(reduced_dim, num_classes)

    def init_weights(self, generator: torch.Generator) -> None:
        """Reference _init_params: convs kaiming, BN 1/0, Linear N(0, 0.01)
        with a zero bias."""
        self.init_backbone(generator)
        with torch.no_grad():
            self.fc1[0].weight.normal_(0.0, 0.01, generator=generator)
            self.classifier.weight.normal_(0.0, 0.01, generator=generator)
            self.classifier.bias.zero_()

    def forward(self, x: torch.Tensor, adj=None, frame_mask=None):
        """x: (B, S, H, W, 3); `adj` is not read. Eval: (B, 1024)."""
        if frame_mask is not None and self.training:
            raise ValueError("frame_mask is an eval-only contract (batch BN mixes rows)")
        B, S, H, W, C = x.shape
        fmap = self.layer4(self.forward_trunk(x.reshape(B * S, H, W, C).permute(0, 3, 1, 2)))
        v_g = self.part_pool(fmap, (self.parts,)).reshape(B, S, self.parts, -1)
        t_a = self.frame_scores(fmap, v_g, None if frame_mask is None else frame_mask.float())
        pick = t_a[..., 0].argmax(dim=1)  # (B, parts)
        f_1 = torch.gather(v_g, 1, pick[:, None, :, None].expand(B, 1, *v_g.shape[2:]))[:, 0]
        f_2 = (v_g * t_a).sum(dim=1)
        f_t = self.fc1(torch.cat([f_1, f_2], dim=2).mean(dim=1))
        if not self.training:
            return f_t
        y = self.classifier(f_t)
        return y if self.loss == frozenset({"xent"}) else (y, f_t)

    def frame_scores(self, fmap: torch.Tensor, v_g: torch.Tensor, fm) -> torch.Tensor:
        """(B, S, parts, 1) temporal attention from layer4's map (B * S, c,
        h, w) and the part features v_g (B, S, parts, c); padding frames
        (fm 0) score 0: out of the normalization, the weighted sum and the
        arg-max (real scores are positive)."""
        B, S = v_g.shape[:2]
        if self.simple:
            att = torch.linalg.vector_norm(v_g, dim=3, keepdim=True)
            if fm is not None:
                att = att * fm[:, :, None, None]
            return l1_normalize(att, dim=1)
        g_a = torch.linalg.vector_norm(fmap, dim=1)  # (B * S, h, w)
        norm = torch.linalg.vector_norm(g_a.reshape(B * S, -1), dim=1)
        g_a = g_a / torch.clamp(norm, min=1e-12)[:, None, None]
        s_a = self.part_pool(g_a[:, None], (self.parts,)).reshape(B, S, self.parts)
        if fm is not None:
            s_a = s_a * fm[:, :, None]
        return l1_normalize(s_a, dim=1)[..., None]

def sta(num_classes, loss=frozenset({"xent", "htri"}), last_stride=1, **kwargs):
    """agrl_tpu's `sta_p4` (agrl_tpu/models/sta.py:117): other keywords,
    `dtype` among them, dropped."""
    return STA(num_classes=num_classes, loss=loss, reduced_dim=1024)


def simple_sta(num_classes, loss=frozenset({"xent", "htri"}), last_stride=1, **kwargs):
    """agrl_tpu's `simple_sta_p4` (agrl_tpu/models/sta.py:122)."""
    return STA(num_classes=num_classes, loss=loss, reduced_dim=1024, simple=True)
