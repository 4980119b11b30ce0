"""GSTA — VMGN's single-branch ancestor (counterpart of
agrl_tpu/models/gsta.py; reference torchreid/models/gsta.py:173-359):

  * ResNet-50 trunk and ONE layer4, at stride 1 whatever `last_stride`
    says (gsta.py:191);
  * pyramid part pooling (the adaptive-average-pool matrix) ->
    (B, S * total_split, 2048) vertices, frame-major -> `num_gb` graph
    layers in VMGN's form (l2 affinity, convex residual; the fused CUDA
    kernel K1 in eval) -> temporal attention -> mean over parts -> one
    BNNeck; the classifier N(0, 0.01), no bias;
  * eval feature: the 2048-d bottleneck output;
  * train: ([y, sy], [f_g, sf_g]) with the consistent loss, else (y, f_g),
    the triplet features taken before the BN. The consistent loss drops
    ONE random frame PER SAMPLE (gsta.py:295-307) and reuses the same
    BNNeck and classifier. The dropped frames come from a torch.Generator
    or are injected (`subclip_indices`, (B,) ints): agrl_tpu draws them
    with jax.random, whose numbers torch cannot reproduce.

`frame_mask` and `dtype` as VMGN's (models/vmgn.py): padding frames leave
the graph layers (a frame-major vertex mask) and the temporal attention;
a dtype sets the trunk's and layer4's compute dtype, and layer4's output
goes to float32.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from agrl_torch.models.backbone import Linear, ResLayer, ResNetTrunk, set_compute_dtype
from agrl_torch.models.layers import BNNeck, GraphConvLayer, temporal_attention
from agrl_torch.models.vmgn import FEATURE_DIM, check_dtype
from agrl_torch.utils.reidtools import calc_splits


def drop_one_frame_per_sample(f: torch.Tensor, drop: torch.Tensor) -> torch.Tensor:
    """(B, S, P, C) -> (B, S-1, P, C): sample b loses frame drop[b], the
    others keep their order (agrl_tpu/models/gsta.py:39-46)."""
    B, S = f.shape[:2]
    base = torch.arange(S - 1, device=f.device)[None, :]
    idx = base + (base >= drop.to(f.device)[:, None]).long()
    return torch.gather(f, 1, idx[:, :, None, None].expand(B, S - 1, *f.shape[2:]))


def check_loss(loss, allowed=(frozenset({"xent"}), frozenset({"xent", "htri"}))) -> frozenset:
    loss = frozenset(loss)
    if loss not in allowed:
        raise KeyError(f"Unsupported loss: {set(loss)}")
    return loss


def heads(loss: frozenset, outputs: list, features: list):
    """The reference's train returns: a list of heads with the consistent
    loss, a bare one without; logits alone for loss {'xent'}."""
    if len(outputs) == 1:
        outputs, features = outputs[0], features[0]
    return outputs if loss == frozenset({"xent"}) else (outputs, features)


class GSTA(ResNetTrunk):
    supports_frame_mask = True

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
        super().__init__(layers)
        check_dtype(dtype)
        self.dtype = dtype
        self.loss = check_loss(loss)
        self.consistent_loss = consistent_loss
        self.total_split_list = calc_splits(num_split) if pyramid_part else [num_split]
        self.total_split = sum(self.total_split_list)
        self.layer4 = ResLayer(1024, 512, layers[3], stride=1)
        self.graph_layers = nn.ModuleList(
            GraphConvLayer(FEATURE_DIM, FEATURE_DIM, learn_graph=learn_graph, use_pose=use_pose)
            for _ in range(num_gb)
        )
        self.bottleneck = BNNeck(FEATURE_DIM)
        self.classifier = Linear(FEATURE_DIM, num_classes, bias=False)
        for stage in (self.conv1, self.bn1, self.layer1, self.layer2, self.layer3, self.layer4):
            set_compute_dtype(stage, dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        """Reference _init_params (gsta.py:235-248): convs kaiming
        (fan_out), BN scale 1 / shift 0, every Linear N(0, 0.01), the
        classifier included."""
        self.init_backbone(generator)
        with torch.no_grad():
            for layer in self.graph_layers:
                layer.init_weights(generator)
            self.classifier.weight.normal_(0.0, 0.01, generator=generator)

    def vertex_features(self, x: torch.Tensor, frame_mask):
        """The trunk, layer4 and the pooling: ((B, S * total_split, c)
        float32 vertices, the float frame mask or None, the vertex mask or
        None)."""
        if frame_mask is not None and self.training:
            raise ValueError("frame_mask is an eval-only contract (batch BN mixes rows)")
        B, S, H, W, C = x.shape
        if self.dtype is not None:
            x = x.to(self.dtype)
        fmap = self.layer4(self.forward_trunk(x.reshape(B * S, H, W, C).permute(0, 3, 1, 2)))
        if self.dtype is not None:  # graph layers, heads and losses in fp32
            fmap = fmap.float()
        fm = vmask = None
        if frame_mask is not None:
            fm = frame_mask.float()
            vmask = fm.repeat_interleave(self.total_split, dim=1)  # (B, V), frame-major
        return self.pool_vertices(fmap, B, S), fm, vmask

    def pool_vertices(self, fmap: torch.Tensor, B: int, S: int) -> torch.Tensor:
        return self.part_pool(fmap, self.total_split_list).reshape(
            B, S * self.total_split, fmap.shape[1])

    def forward(
        self, x: torch.Tensor, adj: torch.Tensor, frame_mask=None, *,
        generator: torch.Generator | None = None, subclip_indices=None,
    ):
        """x: (B, S, H, W, 3) float; adj: (B, V, V), V = S * total_split.

        Eval: the (B, 2048) feature (`frame_mask` (B, S) of 0/1 marks
        padding frames). Train: see the module docstring; with the
        consistent loss `subclip_indices` gives each clip's dropped frame,
        else `generator` draws them."""
        B, S = x.shape[:2]
        f, fm, vmask = self.vertex_features(x, frame_mask)
        for layer in self.graph_layers:
            f = layer(f, adj, vertex_mask=vmask)
        return self.fuse(f.reshape(B, S, self.total_split, -1), fm, generator, subclip_indices)

    def fuse(self, f: torch.Tensor, fm, generator, subclip_indices):
        """(B, S, P, D) part features -> the eval feature or the train heads."""
        f_g = temporal_attention(f, frame_mask=fm).mean(dim=1)
        bn = self.bottleneck(f_g)
        if not self.training:
            return bn
        outputs, features = [self.classifier(bn)], [f_g]
        if self.consistent_loss:
            drop = self.draw_subclips(f.shape[0], f.shape[1], generator, subclip_indices)
            sf_g = temporal_attention(drop_one_frame_per_sample(f, drop)).mean(dim=1)
            outputs.append(self.classifier(self.bottleneck(sf_g)))
            features.append(sf_g)
        return heads(self.loss, outputs, features)

    def draw_subclips(self, batch: int, S: int, generator, given=None) -> torch.Tensor:
        """The consistent loss's draw, asked for by the trainer before the
        forward: the (batch,) frames the clips drop, `given` checked, else
        drawn from `generator`."""
        if given is not None:
            drop = torch.as_tensor(np.asarray(given), dtype=torch.long)
            if tuple(drop.shape) != (batch,) or drop.min() < 0 or drop.max() >= S:
                raise ValueError(f"subclip_indices must hold one frame index in [0, {S}) per "
                                 f"clip ({batch}), got {drop.tolist()}")
            return drop
        if generator is None:
            raise ValueError("the consistent loss needs a torch.Generator or subclip_indices")
        return torch.randint(0, S, (batch,), generator=generator)


def gsta(num_classes, loss=frozenset({"xent", "htri"}), last_stride=1, num_split=4, num_gb=2,
         num_scale=1, pyramid_part=True, use_pose=True, learn_graph=True, consistent_loss=False,
         dtype=None, **kwargs):
    """Factory with agrl_tpu's signature (agrl_tpu/models/gsta.py:150):
    `last_stride` and `num_scale` are dropped (layer4's stride is 1), other
    keywords ignored."""
    del last_stride, num_scale, kwargs
    return GSTA(
        num_classes=num_classes, layers=(3, 4, 6, 3), num_split=num_split,
        pyramid_part=pyramid_part, num_gb=num_gb, use_pose=use_pose, learn_graph=learn_graph,
        loss=loss, consistent_loss=consistent_loss, dtype=dtype,
    )
