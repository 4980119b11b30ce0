"""Multi-scale pyramid-part baselines: msppn (no graph) and msppgn (a stack
of GraphBlocks). Counterpart of agrl_tpu/models/graphnet.py (reference
torchreid/models/graphnet.py:120-320):

  * a ResNet-50 trunk with layer4 at stride 2 gives three feature levels
    (layer2, layer3, layer4), each pooled per pyramid scale with avg and
    max pooling SUMMED, then reduced to 512-d (Linear + vertex BN, xavier
    init);
  * the vertex order is SPLIT-MAJOR within each level, then level-major:
    vertex level * (total_split * S) + part * S + frame. The data side
    builds its adjacency frame-major (data/graph.py), so GraphBlock pairs
    vertices across the two orders: a reference inconsistency that
    agrl_tpu keeps, and the port with it;
  * the per-vertex features are averaged over frames (real frames only
    under `frame_mask`); a Conv1d over the vertex axis fuses them, and
    every vertex and the fused vector get a classifier: 3 * total_split
    + 1 heads (22 at --num-split 4) for cross-entropy and the triplet loss;
  * msppgn runs num_gb GraphBlocks over the vertices and concatenates
    the blocks' outputs to its input, (num_gb + 1) * 512 wide;
  * the eval feature is the fused vector.

Module names are the reference's, which the two archs spell differently
(agrl_tpu/models/weight_convert.py:206-273): msppn holds conv1, bn1,
layer1..4, reduce_f{k}, bn_f{k} and `classifier`; msppgn holds the
trunk as `base.{0..7}`, reduce{k}, bn{k} (its bn1 is a head BN), `gbs`
and `classifiers`. `name_scheme` tells weight_convert which. Both drop
`dtype` (they follow their input, float32 under --bf16-train too).

`all` evaluation pads the adjacency through `pad_eval_adjacency`: each
entry moves to the position its split-major vertex takes after the frame
padding (`_pad_eval_adjacency_split_major`), where the frame-major archs
pad a trailing block.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from agrl_torch.models.backbone import (
    BASE_IMAGENET_STAGES,
    BN_EPS,
    BatchNorm1d,
    Linear,
    MultiScaleTrunk,
    PartPooling,
    adaptive_max_pool_rows,
    init_backbone_,
    init_linear_default_,
    levels,
    resnet_base,
)
from agrl_torch.models.gsta import check_loss
from agrl_torch.models.layers import GraphBlock
from agrl_torch.utils.reidtools import calc_splits

NUM_HID = 512
LEVEL_WIDTHS = (512, 1024, 2048)  # layer2, layer3, layer4
NUM_SCALES = 3


def _xavier_normal_(weight: torch.Tensor, fan_in: int, fan_out: int, generator) -> None:
    with torch.no_grad():
        weight.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)), generator=generator)


@functools.lru_cache(maxsize=64)
def _split_major_pad_indices(V, num, Sp, ts):
    """Post-pad flat position of every split-major vertex: index
    level*(ts*num) + part*num + frame -> level*(ts*Sp) + part*Sp + frame.
    Cached: buckets give only O(log max_len) distinct (num, Sp) pairs
    across an eval epoch's tracklets."""
    idx = np.arange(V)
    level, r = idx // (ts * num), idx % (ts * num)
    part, frame = r // num, r % num
    return level * (ts * Sp) + part * Sp + frame


def _pad_eval_adjacency_split_major(adj, num, Sp, ts):
    """Frame-pad an adjacency read through the split-major vertex layout:
    entry (i, j) moves to the flat positions its model vertices occupy
    after S -> Sp, so the padded graph pairs exactly the vertices the
    unpadded run pairs."""
    V = adj.shape[0]
    if V % (ts * num):
        raise ValueError(f"adjacency ({V} vertices) is not a multiple of total_split*num "
                         f"({ts}*{num}); split-major frame padding needs that layout")
    blocks = V // (ts * num)  # vertex scales (3 for msppn/msppgn)
    m = _split_major_pad_indices(V, num, Sp, ts)
    out = np.zeros((blocks * ts * Sp, blocks * ts * Sp), adj.dtype)
    out[np.ix_(m, m)] = adj
    return out


def _masked_temporal_mean(f, B, num_v, S, fm):
    """(B, num_v * S, dim) split-major vertices -> (B, num_v, dim): each
    vertex's mean over the real frames (`fm` (B, S) 0/1; None: all)."""
    vf = f.reshape(B, num_v, S, -1)
    if fm is None:
        return vf.mean(dim=2)
    return (vf * fm[:, None, :, None]).sum(dim=2) / torch.clamp(
        fm.sum(dim=1)[:, None, None], min=1e-6)


class _GraphNetBase(PartPooling, nn.Module):
    """What msppn and msppgn share: the level pooling and reduction, the
    temporal mean, the fusion and the classifiers."""

    supports_frame_mask = True
    num_vertex_scales = NUM_SCALES

    def _setup(self, num_classes, loss, num_split, dim, reduce_names, bn_names, heads_name):
        self._pool_cache: dict = {}
        self.loss = check_loss(loss)
        self.total_parts = calc_splits(num_split)
        self.total_split = sum(self.total_parts)
        self.num_vertices = NUM_SCALES * self.total_split  # per frame-averaged clip
        self._reduce_names, self._bn_names = reduce_names, bn_names
        for rname, bname, width in zip(reduce_names, bn_names, LEVEL_WIDTHS):
            setattr(self, rname, Linear(width, NUM_HID))
            setattr(self, bname, BatchNorm1d(NUM_HID, eps=BN_EPS))
        self.fusion_conv = nn.Conv1d(self.num_vertices, 1, 1, bias=False)
        self._heads_name = heads_name
        setattr(self, heads_name, nn.ModuleList(
            Linear(dim, num_classes) for _ in range(self.num_vertices + 1)))

    @property
    def head_layers(self) -> nn.ModuleList:
        """The classifiers, the fused one last (`classifier` or `classifiers`)."""
        return getattr(self, self._heads_name)

    @property
    def num_heads(self) -> int:
        """Heads of the train step: one per vertex, and the fused one."""
        return self.num_vertices + 1

    def init_head_weights(self, generator: torch.Generator) -> None:
        """agrl_tpu's init of the heads: the reduce Linears and the fusion
        xavier-normal (biases 0), BN 1 / 0, and the classifiers torch's
        default Linear init (the reference's xavier `apply` on a
        ModuleList is a no-op, agrl_tpu/models/graphnet.py:44-49)."""
        for rname, bname in zip(self._reduce_names, self._bn_names):
            lin, bn = getattr(self, rname), getattr(self, bname)
            _xavier_normal_(lin.weight, lin.in_features, lin.out_features, generator)
            with torch.no_grad():
                lin.bias.zero_()
                bn.weight.fill_(1.0)
                bn.bias.zero_()
        _xavier_normal_(self.fusion_conv.weight, self.num_vertices, 1, generator)
        for head in self.head_layers:
            init_linear_default_(head, generator)

    def _vertices(self, stages, x: torch.Tensor, frame_mask):
        """(B, S, H, W, 3) -> (B, 3 * total_split * S, 512) split-major
        vertices, level by level."""
        if frame_mask is not None and self.training:
            raise ValueError("frame_mask is an eval-only contract (batch BN mixes rows)")
        B, S, H, W, C = x.shape
        T = self.total_split
        maps = levels(stages, x.reshape(B * S, H, W, C).permute(0, 3, 1, 2))
        out = []
        for fmap, rname, bname in zip(maps, self._reduce_names, self._bn_names):
            r = getattr(self, rname)(self._pool_level(fmap, B, S))  # (B, T, S, 512)
            r = getattr(self, bname)(r.reshape(B * T * S, NUM_HID))
            out.append(r.reshape(B, T * S, NUM_HID))
        return torch.cat(out, dim=1)

    def _pool_level(self, fmap: torch.Tensor, B: int, S: int) -> torch.Tensor:
        """avg + max pyramid pooling of (B * S, c, h, w) -> (B, total_split,
        S, c), split-major; the average at least float32 (the pooling
        matrix), so a bf16 map sums in float32, as agrl_tpu's does."""
        avg = self.part_pool(fmap, self.total_parts)
        mx = torch.cat([adaptive_max_pool_rows(fmap, n) for n in self.total_parts], dim=1)
        out = avg + mx  # (B * S, total, c)
        return out.reshape(B, S, self.total_split, -1).permute(0, 2, 1, 3)

    def _heads(self, vf: torch.Tensor):
        """vf (B, num_v, dim) -> the fused (B, dim) in eval; in training the
        per-vertex and fused logits and features, fused last."""
        w = self.fusion_conv.weight.reshape(-1)
        dt = torch.promote_types(vf.dtype, w.dtype)
        fused = torch.einsum("bvd,v->bd", vf.to(dt), w.to(dt))
        if not self.training:
            return fused
        feats = [*vf.unbind(dim=1), fused]
        ys = [head(f) for head, f in zip(self.head_layers, feats)]
        return ys if self.loss == frozenset({"xent"}) else (ys, feats)

    def _temporal(self, f, B, S, frame_mask):
        return _masked_temporal_mean(f, B, self.num_vertices, S,
                                     None if frame_mask is None else frame_mask.float())

    def _empty_pad(self, adj, Sp):
        """A zero adjacency of the model's padded vertex count: what a model
        that never reads `adj` takes, for any data-side layout."""
        V = self.num_vertices * Sp
        return np.zeros((V, V), adj.dtype)


class MSPyraPartNet(MultiScaleTrunk, _GraphNetBase):
    """msppn: multi-scale pyramid parts, per-vertex classifiers, no graph."""

    name_scheme = "msppn"
    # the reference's count_num_param leaves out `classifier`: here every head
    count_exclude_heads = ("classifier",)
    # agrl_tpu's "Model size" line counts its params tree with the default
    # exclusion, where these heads are classifier_{i}: it leaves out nothing
    size_line_exclude = ()
    expected_adj_scales = None  # the adjacency is never read (any --num-scale runs)

    def __init__(self, num_classes: int, loss=frozenset({"xent", "htri"}), num_split: int = 4,
                 layers=(3, 4, 6, 3)):
        super().__init__(layers)
        self._setup(num_classes, loss, num_split, NUM_HID, ("reduce_f1", "reduce_f2", "reduce_f3"),
                    ("bn_f1", "bn_f2", "bn_f3"), "classifier")

    def init_weights(self, generator: torch.Generator) -> None:
        self.init_backbone(generator)
        self.init_head_weights(generator)

    def pad_eval_adjacency(self, adj, num, Sp):
        return self._empty_pad(adj, Sp)

    def forward(self, x: torch.Tensor, adj=None, frame_mask=None):
        """x: (B, S, H, W, 3); `adj` is not read. Eval: (B, 512)."""
        B, S = x.shape[:2]
        f = self._vertices(list(self.children())[:8], x, frame_mask)
        return self._heads(self._temporal(f, B, S, frame_mask))


class MSPyraPartGraphNet(_GraphNetBase):
    """msppgn: msppn's vertices through num_gb GraphBlocks, the blocks'
    outputs concatenated to their input."""

    name_scheme = "msppgn"
    # the reference's count_num_param leaves out only `classifier`;
    # msppgn's heads are `classifiers`: nothing is left out
    count_exclude_heads = ()
    # where an ImageNet ResNet-50's stages go (init_pretrained_weights)
    imagenet_stages = BASE_IMAGENET_STAGES

    def __init__(self, num_classes: int, loss=frozenset({"xent", "htri"}), num_split: int = 3,
                 num_gb: int = 3, use_pose: bool = True, learn_graph: bool = True,
                 layers=(3, 4, 6, 3)):
        super().__init__()
        self.base = resnet_base(layers, last_stride=2)
        self.num_gb = num_gb
        self.use_pose = use_pose
        self.learn_graph = learn_graph
        self._setup(num_classes, loss, num_split, (num_gb + 1) * NUM_HID,
                    ("reduce1", "reduce2", "reduce3"), ("bn1", "bn2", "bn3"), "classifiers")
        self.gbs = nn.ModuleList(
            GraphBlock(NUM_HID, NUM_HID, learn_graph=learn_graph, use_pose=use_pose)
            for _ in range(num_gb))

    @property
    def expected_adj_scales(self):
        """3 when a GraphBlock reads `adj` (blending with the pose graph, or
        as the graph itself): its vertices span layer2/3/4."""
        return NUM_SCALES if (self.use_pose or not self.learn_graph) else None

    def init_weights(self, generator: torch.Generator) -> None:
        init_backbone_(self.base, generator)
        self.init_head_weights(generator)
        for gb in self.gbs:
            gb.init_weights(generator)

    def pad_eval_adjacency(self, adj, num, Sp):
        if self.expected_adj_scales is None:
            return self._empty_pad(adj, Sp)  # the blocks never read it
        return _pad_eval_adjacency_split_major(adj, num, Sp, self.total_split)

    def forward(self, x: torch.Tensor, adj, frame_mask=None):
        """x: (B, S, H, W, 3); adj: (B, V, V), V = 3 * total_split * S, read
        through the split-major vertex order. Eval: (B, (num_gb + 1) * 512)."""
        B, S = x.shape[:2]
        vmask = None
        if frame_mask is not None:
            # split-major: vertex v belongs to frame v % S
            vmask = frame_mask.float().repeat(1, self.num_vertices)
        outs = [self._vertices(list(self.base), x, frame_mask)]
        for gb in self.gbs:
            outs.append(gb(outs[-1], adj, vertex_mask=vmask))
        f = torch.cat(outs, dim=2)
        return self._heads(self._temporal(f, B, S, frame_mask))


def msppn(num_classes=100, loss=frozenset({"xent", "htri"}), num_split=4, **kwargs):
    """agrl_tpu's factory (agrl_tpu/models/graphnet.py:322): every other
    keyword (`num_gb`, `dtype`, `last_stride`, `consistent_loss`, ...) is
    dropped."""
    return MSPyraPartNet(num_classes=num_classes, loss=loss, num_split=num_split)


def msppgn(num_classes=100, loss=frozenset({"xent", "htri"}), num_split=3, use_pose=True,
           learn_graph=True, num_gb=3, **kwargs):
    """agrl_tpu's factory (agrl_tpu/models/graphnet.py:326): other keywords
    dropped."""
    return MSPyraPartGraphNet(num_classes=num_classes, loss=loss, num_split=num_split,
                              num_gb=num_gb, use_pose=use_pose, learn_graph=learn_graph)
