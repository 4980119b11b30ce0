"""Image re-id ResNet baselines, the legacy image family (counterpart of
agrl_tpu/models/resnet_image.py; reference torchreid/models/resnet.py,
ResNet50, ResNet101, ResNet50M and ResNet50B):

  * resnet50 / resnet101 (`ResNetImage`, layers (3,4,6,3) / (3,4,23,3)):
    the reference's `base` (layer4 at stride 2), the global mean and a
    classifier;
  * resnet50m (`ResNet50M`): layer4's three blocks tapped one by one; the
    means of blocks a and b, concatenated, go through `fc_fuse` (Linear
    4096 -> 1024, BatchNorm1d, ReLU) and join block c's mean: 3072 wide;
  * resnet50b (`ResNet50B`): layer4 at stride 1 and a 512-d `bottleneck`
    (Linear, BatchNorm1d, LeakyReLU(0.1), Dropout(0.5)) before the
    classifier; the eval feature is the 2048-d global mean.

Input is (B, H, W, 3) images. Eval: the feature; train: the logits, or
(logits, feature) under {"xent", "htri"}, and the BN statistics update.
State-dict names are the reference's: `base.{0,1,4..7}`, and resnet50m's
regrouped torchvision children `layers1` (conv1, bn1, relu), `layers2`
(maxpool, layer1), `layers3`, `layers4`, `layers5a/b/c`. ResNet50B's
dropout draws its mask from its own `torch.Generator` (`Dropout`),
which `init_image_model` seeds. agrl_tpu has no image trainer and no
image CLI, so the port has none either: the registry builds the models.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from agrl_torch.models.backbone import (
    BASE_IMAGENET_STAGES,
    BN_EPS,
    BatchNorm1d,
    Bottleneck,
    Linear,
    ResNetTrunk,
    init_backbone_,
    init_linear_default_,
    resnet_base,
)
from agrl_torch.models.gsta import check_loss


def _heads(loss: frozenset, y: torch.Tensor, f: torch.Tensor):
    return y if loss == frozenset({"xent"}) else (y, f)


def _kaiming_fan_out_(lin: nn.Linear, generator: torch.Generator) -> None:
    """The reference's weights_init_kaiming for ResNet50B's Linears
    (resnet.py:138-141; agrl_tpu's variance_scaling(2, fan_out, normal)):
    N(0, 2 / out_features), zero bias."""
    with torch.no_grad():
        lin.weight.normal_(0.0, math.sqrt(2.0 / lin.out_features), generator=generator)
        lin.bias.zero_()


class Dropout(nn.Module):
    """Dropout as flax's: in training, each entry is kept with probability
    1 - p and scaled by 1 / (1 - p), else 0. The mask is drawn on the CPU
    from `generator` (a torch.Generator; None: torch's default one) and
    moved to the input's device. Identity in eval."""

    def __init__(self, p: float, generator: torch.Generator | None = None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator) >= self.p
        return torch.where(keep.to(x.device), x / (1.0 - self.p), torch.zeros_like(x))


class ResNetImage(nn.Module):
    name_scheme = "temporal"
    imagenet_stages = BASE_IMAGENET_STAGES

    def __init__(self, num_classes: int, loss=frozenset({"xent"}), layers=(3, 4, 6, 3)):
        super().__init__()
        self.loss = check_loss(loss)
        self.base = resnet_base(layers, last_stride=2)
        self.classifier = Linear(2048, num_classes)

    def init_weights(self, generator: torch.Generator) -> None:
        init_backbone_(self.base, generator)
        init_linear_default_(self.classifier, generator)

    def forward(self, x: torch.Tensor):
        """x: (B, H, W, 3). Eval: (B, 2048)."""
        f = self.base(x.permute(0, 3, 1, 2)).mean(dim=(2, 3))
        if not self.training:
            return f
        return _heads(self.loss, self.classifier(f), f)


class ResNet50M(nn.Module):
    name_scheme = "resnet50m"
    # layer4's three blocks are layers5a/b/c (agrl_tpu weight_convert.py:617-631)
    imagenet_stages = {"conv1": "layers1.0", "bn1": "layers1.1", "layer1": "layers2.1",
                       "layer2": "layers3", "layer3": "layers4", "layer4.0": "layers5a",
                       "layer4.1": "layers5b", "layer4.2": "layers5c"}

    def __init__(self, num_classes: int, loss=frozenset({"xent"}), layers=(3, 4, 6, 3)):
        super().__init__()
        self.loss = check_loss(loss)
        trunk = ResNetTrunk(layers)
        self.layers1 = nn.Sequential(trunk.conv1, trunk.bn1, trunk.relu)
        self.layers2 = nn.Sequential(trunk.maxpool, trunk.layer1)
        self.layers3 = trunk.layer2
        self.layers4 = trunk.layer3
        self.layers5a = Bottleneck(1024, 512, stride=2, downsample=True)
        self.layers5b = Bottleneck(2048, 512)
        self.layers5c = Bottleneck(2048, 512)
        self.fc_fuse = nn.Sequential(Linear(4096, 1024), BatchNorm1d(1024, eps=BN_EPS),
                                     nn.ReLU())
        self.classifier = Linear(3072, num_classes)

    def init_weights(self, generator: torch.Generator) -> None:
        for stage in (self.layers1, self.layers2, self.layers3, self.layers4, self.layers5a,
                      self.layers5b, self.layers5c, self.fc_fuse):
            init_backbone_(stage, generator)
        init_linear_default_(self.fc_fuse[0], generator)
        init_linear_default_(self.classifier, generator)

    def forward(self, x: torch.Tensor):
        """x: (B, H, W, 3). Eval: (B, 3072)."""
        x = self.layers4(self.layers3(self.layers2(self.layers1(x.permute(0, 3, 1, 2)))))
        x5a = self.layers5a(x)
        x5b = self.layers5b(x5a)
        x5c = self.layers5c(x5b)
        mid = self.fc_fuse(torch.cat([x5a.mean(dim=(2, 3)), x5b.mean(dim=(2, 3))], dim=1))
        combo = torch.cat([x5c.mean(dim=(2, 3)), mid], dim=1)
        if not self.training:
            return combo
        return _heads(self.loss, self.classifier(combo), combo)


class ResNet50B(nn.Module):
    name_scheme = "temporal"
    imagenet_stages = BASE_IMAGENET_STAGES

    def __init__(self, num_classes: int, loss=frozenset({"xent"}), layers=(3, 4, 6, 3)):
        super().__init__()
        self.loss = check_loss(loss)
        self.base = resnet_base(layers, last_stride=1)
        self.bottleneck = nn.Sequential(Linear(2048, 512), BatchNorm1d(512, eps=BN_EPS),
                                        nn.LeakyReLU(0.1), Dropout(0.5))
        self.classifier = Linear(512, num_classes)

    @property
    def dropout(self) -> Dropout:
        return self.bottleneck[3]

    def init_weights(self, generator: torch.Generator) -> None:
        init_backbone_(self.base, generator)
        init_backbone_(self.bottleneck, generator)
        _kaiming_fan_out_(self.bottleneck[0], generator)
        _kaiming_fan_out_(self.classifier, generator)

    def forward(self, x: torch.Tensor):
        """x: (B, H, W, 3). Eval: the (B, 2048) global feature."""
        global_feat = self.base(x.permute(0, 3, 1, 2)).mean(dim=(2, 3))
        if not self.training:
            return global_feat
        return _heads(self.loss, self.classifier(self.bottleneck(global_feat)), global_feat)


def resnet50_image(num_classes, loss=frozenset({"xent"}), **kwargs):
    return ResNetImage(num_classes=num_classes, loss=loss, layers=(3, 4, 6, 3))


def resnet101_image(num_classes, loss=frozenset({"xent"}), **kwargs):
    return ResNetImage(num_classes=num_classes, loss=loss, layers=(3, 4, 23, 3))


def resnet50m(num_classes, loss=frozenset({"xent"}), **kwargs):
    return ResNet50M(num_classes=num_classes, loss=loss)


def resnet50b(num_classes, loss=frozenset({"xent"}), **kwargs):
    return ResNet50B(num_classes=num_classes, loss=loss)
