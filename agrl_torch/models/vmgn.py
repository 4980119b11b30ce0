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
  * Train outputs: ([g_out, att_out, *subclip_outs], [g_f, att_f,
    *subclip_feats]) for loss {'xent', 'htri'} (vmgn.py:344-355); the
    classifiers have no bias and the triplet features are the pre-BN ones.
  * Consistent loss: sorted random subsets of S-3, S-2 and S-1 frames are
    re-fused through the same attention BNNeck and classifier
    (vmgn.py:327-342). The subsets come from an explicit torch.Generator,
    or are injected (`subclip_indices`): agrl_tpu draws them with
    jax.random, whose numbers torch cannot reproduce.

Public layout follows agrl_tpu: clips (B, S, H, W, 3) float, adjacency
(B, V, V). Inside, frames go to NCHW by a permute (which gives NCHW
tensors in channels_last memory order, no copy).

Submodule names are the reference's, so agrl_tpu's name map
(weight_convert._split_torch_name) covers every entry.

`frame_mask` (eval only, the bucketed `--test-sample all`): padding
frames drop out of the global mean, of every graph layer (a vertex mask,
frame-major) and of the temporal attention, so a padded tracklet's
feature equals its unpadded one (agrl_tpu/models/vmgn.py:118-162).

`dtype` is agrl_tpu's mixed precision (agrl_tpu/models/vmgn.py:65-68,
100-116): the compute dtype of the trunk and both layer4 branches, whose
parameters stay float32. None follows the input (a bf16 input, with the
bf16 eval's bf16-rounded weights, runs them in bf16); float32 casts the
input to float32; bfloat16 runs them in bf16 (`--bf16-train`). With a
dtype set, layer4's output is cast to float32, so the graph layers, heads
and losses run in float32. The pyramid pooling matrix is float32 in every
case, as agrl_tpu's numpy constant is, so the graph layers see float32
vertex features under all three.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from agrl_torch.models.backbone import (
    Bottleneck,
    ResLayer,
    ResNetTrunk,
    adaptive_avg_pool_matrix,
    init_conv_,
    set_compute_dtype,
)
from agrl_torch.models.layers import BNNeck, GraphConvLayer, temporal_attention
from agrl_torch.utils.reidtools import calc_splits

FEATURE_DIM = 512 * Bottleneck.expansion  # layer4 width: 2048


class VMGN(ResNetTrunk):
    supports_frame_mask = True

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
        loss=frozenset({"xent", "htri"}),
        consistent_loss: bool = False,
        dtype: torch.dtype | None = None,
    ):
        super().__init__(layers)
        check_dtype(dtype)
        self.dtype = dtype
        self.loss = frozenset(loss)
        if self.loss not in (frozenset({"xent"}), frozenset({"xent", "htri"})):
            raise KeyError(f"Unsupported loss: {set(self.loss)}")
        self.consistent_loss = consistent_loss
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
        for stage in (self.conv1, self.bn1, self.layer1, self.layer2, self.layer3,
                      self.layer4_1, self.layer4_2):
            set_compute_dtype(stage, dtype)
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
        """(total_split, h) pyramid pooling matrix on ref's device and in its
        dtype, cached per height, device and dtype. While torch.export
        traces, it is made anew (a constant of the program): the cache must
        not keep a tensor of the trace."""
        key = (h, ref.device, ref.dtype)
        tracing = torch.compiler.is_compiling()
        if key in self._pool_cache and not tracing:
            return self._pool_cache[key]
        rows = [adaptive_avg_pool_matrix(h, n) for n in self.total_split_list]
        m = torch.cat([torch.from_numpy(r) for r in rows]).to(ref.device, ref.dtype)
        if not tracing:
            self._pool_cache[key] = m
        return m

    def forward(
        self, x: torch.Tensor, adj: torch.Tensor, frame_mask=None, *,
        generator: torch.Generator | None = None, subclip_indices=None,
    ):
        """x: (B, S, H, W, 3) float; adj: (B, V, V), V = S * total_split.

        Eval mode: the (B, 4096) eval feature; `frame_mask` (B, S) of 0/1
        marks padding frames (eval only). Train mode: (logits list,
        feature list), or the logits list alone for loss {'xent'}. With the
        consistent loss, `subclip_indices` gives the three sorted frame
        subsets (S-3, S-2 and S-1 frames); else `generator` draws them."""
        if frame_mask is not None and self.training:
            raise ValueError("frame_mask is an eval-only contract (batch BN mixes rows)")
        B, S, H, W, C = x.shape
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x.reshape(B * S, H, W, C).permute(0, 3, 1, 2)
        x3 = self.forward_trunk(x)
        x4_1 = self.layer4_1(x3)
        x4_2 = self.layer4_2(x3)
        if self.dtype is not None:  # mixed mode: graph layers, heads, losses in fp32
            x4_1, x4_2 = x4_1.float(), x4_2.float()
        _, c, h, w = x4_1.shape
        fm = vmask = None
        if frame_mask is not None:
            fm = frame_mask.float()  # (B, S)
            vmask = fm.repeat_interleave(self.total_split, dim=1)  # (B, V), frame-major

        # global branch; with a mask, the mean over real frames only
        if fm is None:
            g_f = x4_1.reshape(B, S, c, h, w).mean(dim=(1, 3, 4))
        else:
            g_sum = (x4_1.reshape(B, S, c, h, w) * fm[:, :, None, None, None]).sum(dim=(1, 3, 4))
            g_f = g_sum / (fm.sum(dim=1)[:, None] * (h * w))
        g_bn = self.global_bottleneck(g_f)

        # attention branch: pyramid part pooling against an (at least) float32
        # matrix, which promotes a bf16 fmap (agrl_tpu's einsum with a numpy
        # constant)
        fmap = x4_2.mean(dim=3)  # pool width -> (B*S, c, h)
        fmap = fmap.to(torch.promote_types(fmap.dtype, torch.float32))
        v_f = torch.matmul(self._pool_matrix(h, fmap), fmap.transpose(1, 2))  # (B*S, P, c)
        f = v_f.reshape(B, S * self.total_split, c)
        for layer in self.graph_layers:
            f = layer(f, adj, vertex_mask=vmask)
        f = f.reshape(B, S, self.total_split, c)

        att_f = temporal_attention(f, frame_mask=fm).mean(dim=1)
        att_bn = self.att_bottleneck(att_f)
        if not self.training:
            return torch.cat([g_bn, att_bn], dim=1)  # promotes a bf16 g_bn (dtype None)

        out_list = [self.global_classifier(g_bn), self.att_classifier(att_bn)]
        f_list = [g_f, att_f]
        if self.consistent_loss:
            for index in self.subclip_indices(S, generator, subclip_indices):
                sf = f.index_select(1, torch.as_tensor(index, dtype=torch.long).to(f.device))
                satt_f = temporal_attention(sf).mean(dim=1)
                out_list.append(self.att_classifier(self.att_bottleneck(satt_f)))
                f_list.append(satt_f)
        if self.loss == frozenset({"xent"}):
            return out_list
        return out_list, f_list

    @staticmethod
    def subclip_indices(S: int, generator, given=None) -> list:
        """Sorted random subsets of S-3, S-2, S-1 of the S frames: `given`
        checked, else drawn from `generator`."""
        if S < 5:
            raise ValueError(f"the consistent loss needs seq_len >= 5, got {S}")
        sizes = (S - 3, S - 2, S - 1)
        if given is not None:
            given = [np.asarray(i) for i in given]
            if [len(i) for i in given] != list(sizes) or any(
                i.min() < 0 or i.max() >= S for i in given
            ):
                raise ValueError(f"subclip_indices must hold {sizes} frame indices in "
                                 f"[0, {S}), got {[i.tolist() for i in given]}")
            return given
        if generator is None:
            raise ValueError("the consistent loss needs a torch.Generator or subclip_indices")
        return [
            torch.sort(torch.randperm(S, generator=generator)[:n]).values for n in sizes
        ]


def check_dtype(dtype) -> None:
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"VMGN computes in float32 or bfloat16 (or follows its input: None), "
                         f"got dtype={dtype}")


def check_factory_kwargs(num_scale=1, dtype=None, num_parts=None, bnneck=False, **unknown):
    """The registry keywords the training CLI passes (agrl_tpu's
    `init_model` call) that do not shape this model. `num_parts` sizes the
    pose graph's part sets on the data side; `bnneck` is accepted and
    unused, as in agrl_tpu (its VMGN always has BNNecks); `dtype` is
    checked here and taken by the factory that uses it. A value that would
    change the model raises instead of being ignored."""
    if unknown:
        raise TypeError(f"unexpected model keywords: {sorted(unknown)}")
    if num_scale != 1:
        raise ValueError(f"vmgn's pooling produces one scale of vertices, got "
                         f"num_scale={num_scale}")
    check_dtype(dtype)


def vmgn(
    num_classes,
    loss=frozenset({"xent", "htri"}),
    last_stride=1,
    num_split=4,
    num_gb=2,
    pyramid_part=True,
    use_pose=True,
    learn_graph=True,
    consistent_loss=False,
    dtype=torch.float32,
    **kwargs,
):
    """Factory matching the reference factory signature (vmgn.py:373-390);
    float32 by default, as agrl_tpu/models/vmgn.py:208."""
    check_factory_kwargs(dtype=dtype, **kwargs)
    return VMGN(
        num_classes=num_classes,
        layers=(3, 4, 6, 3),
        last_stride=last_stride,
        num_split=num_split,
        pyramid_part=pyramid_part,
        num_gb=num_gb,
        use_pose=use_pose,
        learn_graph=learn_graph,
        loss=loss,
        consistent_loss=consistent_loss,
        dtype=dtype,
    )
