"""Temporal-aggregation baselines, the legacy video family (counterpart of
agrl_tpu/models/resnet_temporal.py; reference
torchreid/models/resnet_temporal.py):

  * res50tp_legacy (`ResNet50TPLegacy`): each frame's global mean, then
    the mean over frames;
  * res50ta (`ResNet50TA`): attention scores from a full-map convolution
    to 256 channels and a kernel-3 temporal convolution to one, a softmax
    over frames (or `att_gen="sigmoid"`: a sigmoid, L1-normalized over
    frames), then the weighted sum of the frames' features;
  * res50rnn (`ResNet50RNN`): a one-layer LSTM (hidden 512) over the
    frames' features, then the mean of its outputs over frames.

Each holds the reference's `base` (backbone.resnet_base: conv1, bn1,
relu, maxpool, layer1..4, layer4 at stride 2), whose state-dict names
`base.{0,1,4..7}` are the ones agrl_tpu's convert_temporal_state_dict
reads. Clips arrive as (B, T, H, W, 3). Eval: the feature, 2048 wide
(512 for res50rnn); train: the logits, or (logits, feature) under the
loss {"xent", "htri"} (or {"cent"}). No adjacency is read and no frame
mask is taken: `--test-sample all` runs each tracklet whole, unpadded
(engine/evaluator.py), so the LSTM, the softmax and the temporal
convolution see every frame of it. The factories drop `dtype` and the
other keywords as agrl_tpu's do: the models follow their input (float32
under --bf16-train; the bf16 eval's rounded weights and pixels compute
in bf16, the LSTM's carry in float32 as flax's).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from agrl_torch.models.backbone import (
    BASE_IMAGENET_STAGES,
    Conv1d,
    Conv2d,
    Linear,
    init_backbone_,
    init_lecun_normal_,
    init_linear_default_,
    linear,
    resnet_base,
)
from agrl_torch.models.gsta import check_loss
from agrl_torch.models.layers import l1_normalize

FEATURE_DIM = 2048
# agrl_tpu's temporal family also gives (logits, feature) under {"cent"}
LEGACY_LOSSES = (frozenset({"xent"}), frozenset({"xent", "htri"}), frozenset({"cent"}))


def feature_map_size(height: int, width: int, last_stride: int = 2) -> tuple[int, int]:
    """(h, w) of layer4's map for (height, width) frames: the stem's
    7x7/2 conv and 3x3/2 max pool, then the 3x3 convs of layer2, layer3
    and layer4 at strides 2, 2 and `last_stride` (8x4 at 256x128, 2x1 at
    64x32)."""

    def conv(n, k, s, p):
        return (n + 2 * p - k) // s + 1

    h, w = conv(height, 7, 2, 3), conv(width, 7, 2, 3)
    h, w = conv(h, 3, 2, 1), conv(w, 3, 2, 1)
    for s in (2, 2, last_stride):
        h, w = conv(h, 3, s, 1), conv(w, 3, s, 1)
    return h, w


class LSTM(nn.Module):
    """One layer of torch's nn.LSTM (batch_first, gates packed i, f, g, o)
    under its parameter names, computed as flax's OptimizedLSTMCell under
    nn.RNN (agrl_tpu/models/resnet_temporal.py:97-112), as torch operations
    (so torch.export traces it, the FLOPs probe counts its products, and
    the bf16 eval runs it without a cast): the carry starts as float32
    zeros; each step adds the hidden product (h W_hh^T + bias, at the
    promotion of h's and the weights' dtypes) to the input product
    (x W_ih^T, at the promotion of x's and W_ih's: bf16 under the bf16
    eval), then c = f c + i g and h = o tanh(c).

    flax keeps one bias per gate, on the hidden side: `bias_hh_l0`.
    `bias_ih_l0` is kept for the reference's state-dict names and is frozen
    (no gradient): zero after the port's init and after an agrl_tpu bridge,
    a reference checkpoint's value after a torch-named load; the forward
    adds both, as torch's LSTM does.

    Under `--mesh-mp` the packed weights may be sharded gate by gate
    (parallel.param_shardings: each gate's rows, as flax's four leaves):
    each product is then tensor-parallel and its gathered output comes
    back in gate order (i, f, g, o) before the recurrence reads it."""

    # the packed weights parallel.place_state may shard: four gate blocks each
    MP_BLOCKS = {"weight_ih_l0": 4, "weight_hh_l0": 4}

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        four = 4 * hidden_size
        self.weight_ih_l0 = nn.Parameter(torch.empty(four, input_size))
        self.weight_hh_l0 = nn.Parameter(torch.empty(four, hidden_size))
        self.bias_ih_l0 = nn.Parameter(torch.zeros(four), requires_grad=False)
        self.bias_hh_l0 = nn.Parameter(torch.zeros(four))

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's cell init: each gate's input kernel lecun_normal, its
        recurrent kernel orthogonal, biases zero."""
        H = self.hidden_size
        with torch.no_grad():
            for k in range(4):
                init_lecun_normal_(self.weight_ih_l0[k * H:(k + 1) * H], self.input_size,
                                   generator)
                nn.init.orthogonal_(self.weight_hh_l0[k * H:(k + 1) * H], generator=generator)
            self.bias_ih_l0.zero_()
            self.bias_hh_l0.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, input_size) -> (B, T, hidden_size)."""
        B, T, _ = x.shape
        H = self.hidden_size
        dt_i = torch.promote_types(x.dtype, self.weight_ih_l0.dtype)
        xi = linear(self, "weight_ih_l0", x.to(dt_i), self.weight_ih_l0.to(dt_i))  # (B, T, 4H)
        c = h = torch.zeros(B, H, dtype=torch.float32, device=x.device)
        outs = []
        for t in range(T):
            dt_h = torch.promote_types(h.dtype, self.weight_hh_l0.dtype)
            bias = self.bias_hh_l0.to(dt_h) + self.bias_ih_l0.to(dt_h)
            g = linear(self, "weight_hh_l0", h.to(dt_h), self.weight_hh_l0.to(dt_h), bias)
            g = g + xi[:, t]
            i, f = torch.sigmoid(g[:, :H]), torch.sigmoid(g[:, H:2 * H])
            gg, o = torch.tanh(g[:, 2 * H:3 * H]), torch.sigmoid(g[:, 3 * H:])
            c = f * c + i * gg
            h = o * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, dim=1)


class _LegacyVideo(nn.Module):
    """The `base`, the classifier (torch's default Linear init: the legacy
    family never re-initializes it) and the train heads."""

    name_scheme = "temporal"
    imagenet_stages = BASE_IMAGENET_STAGES

    def __init__(self, num_classes: int, loss, layers, feat_dim: int):
        super().__init__()
        self.loss = check_loss(loss, LEGACY_LOSSES)
        self.base = resnet_base(layers, last_stride=2)
        self.classifier = Linear(feat_dim, num_classes)

    def init_weights(self, generator: torch.Generator) -> None:
        init_backbone_(self.base, generator)
        init_linear_default_(self.classifier, generator)

    def frames(self, x: torch.Tensor):
        """(B, T, H, W, 3) -> layer4's (B * T, 2048, h, w), B, T."""
        B, T, H, W, C = x.shape
        return self.base(x.reshape(B * T, H, W, C).permute(0, 3, 1, 2)), B, T

    def finish(self, f: torch.Tensor):
        if not self.training:
            return f
        y = self.classifier(f)
        return y if self.loss == frozenset({"xent"}) else (y, f)


class ResNet50TPLegacy(_LegacyVideo):
    def __init__(self, num_classes: int, loss=frozenset({"xent"}), layers=(3, 4, 6, 3)):
        super().__init__(num_classes, loss, layers, FEATURE_DIM)

    def forward(self, x: torch.Tensor, adj=None) -> torch.Tensor:
        fmap, B, T = self.frames(x)
        return self.finish(fmap.mean(dim=(2, 3)).reshape(B, T, -1).mean(dim=1))


class ResNet50TA(_LegacyVideo):
    """`attention_conv`'s kernel spans layer4's whole map, so the frame
    size is fixed when the model is built (`height`, `width`); agrl_tpu
    sizes it from the map at create_train_state(..., height, width). A
    model built for one size refuses frames of another."""

    def __init__(self, num_classes: int, loss=frozenset({"xent"}), layers=(3, 4, 6, 3),
                 att_gen: str = "softmax", middle_dim: int = 256, height: int = 256,
                 width: int = 128):
        if att_gen not in ("softmax", "sigmoid"):
            raise KeyError(f"Unsupported attention generation: {att_gen}")
        super().__init__(num_classes, loss, layers, FEATURE_DIM)
        self.att_gen = att_gen
        self.frame_size = (height, width)
        self.att_hw = feature_map_size(height, width)
        self.attention_conv = Conv2d(FEATURE_DIM, middle_dim, self.att_hw)
        self.attention_tconv = Conv1d(middle_dim, 1, 3, padding=1)

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's Conv defaults for the two attention convs: lecun_normal
        kernels, zero biases."""
        super().init_weights(generator)
        for conv in (self.attention_conv, self.attention_tconv):
            init_lecun_normal_(conv.weight, math.prod(conv.weight.shape[1:]), generator)
            nn.init.zeros_(conv.bias)

    def forward(self, x: torch.Tensor, adj=None) -> torch.Tensor:
        fmap, B, T = self.frames(x)
        if tuple(fmap.shape[2:]) != self.att_hw:
            raise ValueError(
                f"res50ta was built for {self.frame_size[0]}x{self.frame_size[1]} frames (a "
                f"{self.att_hw[0]}x{self.att_hw[1]} attention_conv over layer4's map); frames "
                f"of {x.shape[2]}x{x.shape[3]} give a {fmap.shape[2]}x{fmap.shape[3]} map: "
                "build it with that height and width")
        a = F.relu(self.attention_conv(fmap)).reshape(B, T, -1).transpose(1, 2)  # (B, 256, T)
        a = F.relu(self.attention_tconv(a)).reshape(B, T)
        if self.att_gen == "softmax":
            a = torch.softmax(a, dim=1)
        else:
            a = l1_normalize(torch.sigmoid(a), dim=1)
        feats = fmap.mean(dim=(2, 3)).reshape(B, T, -1)
        return self.finish((feats * a[:, :, None]).sum(dim=1))


class ResNet50RNN(_LegacyVideo):
    def __init__(self, num_classes: int, loss=frozenset({"xent"}), layers=(3, 4, 6, 3),
                 hidden_dim: int = 512):
        super().__init__(num_classes, loss, layers, hidden_dim)
        self.lstm = LSTM(FEATURE_DIM, hidden_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        super().init_weights(generator)
        self.lstm.init_weights(generator)

    def forward(self, x: torch.Tensor, adj=None) -> torch.Tensor:
        fmap, B, T = self.frames(x)
        feats = fmap.mean(dim=(2, 3)).reshape(B, T, -1)
        return self.finish(self.lstm(feats).mean(dim=1))


def res50tp_legacy(num_classes, loss=frozenset({"xent"}), **kwargs):
    """agrl_tpu's factory (agrl_tpu/models/resnet_temporal.py:115): other
    keywords, `dtype` and `last_stride` among them, are dropped."""
    return ResNet50TPLegacy(num_classes=num_classes, loss=loss)


def res50ta(num_classes, loss=frozenset({"xent"}), height=256, width=128, **kwargs):
    """agrl_tpu's factory (:119), other keywords dropped. `height` and
    `width` (the training CLI's --height/--width) size attention_conv at
    build, where agrl_tpu sizes it from the map at its first init: 8x4 for
    256x128 frames, so a 256x128 agrl_tpu checkpoint loads strictly."""
    return ResNet50TA(num_classes=num_classes, loss=loss, height=height, width=width)


def res50rnn(num_classes, loss=frozenset({"xent"}), **kwargs):
    """agrl_tpu's factory (:123), other keywords dropped."""
    return ResNet50RNN(num_classes=num_classes, loss=loss)
