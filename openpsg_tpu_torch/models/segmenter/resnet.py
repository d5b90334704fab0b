"""ResNet-50 backbone with frozen BatchNorm (counterpart of
``openpsg_tpu/models/segmenter/resnet.py``), for the v1/v2/v3 Mask2Former
configs: mmdet's ResNet-50 (configs/psg/baseline_r50.py), outputs at
strides 4, 8, 16, 32.

BatchNorm always runs in inference mode (mmdet ``norm_eval`` and a frozen
backbone), so :class:`FrozenBN` is a per-channel affine ``x * scale +
shift`` whose two vectors the weight converter folds from the four BN
tensors.  Strided convolutions pad symmetrically (torch style); the stem's
max-pool pads with -inf.  Runs in NCHW inside; returns [H, W, C] maps.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class FrozenBN(nn.Module):
    """Inference-mode BatchNorm: ``x * weight + shift`` per channel (flax
    ``scale`` → ``weight`` through the bridge)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.shift = nn.Parameter(torch.empty(channels))

    def init_extra(self, gen):
        self.weight.fill_(1.0)
        self.shift.zero_()

    def forward(self, x):
        """x [N, C, H, W]."""
        return x * self.weight.to(x.dtype)[:, None, None] + self.shift.to(x.dtype)[:, None, None]


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 1, bias=False)
        self.bn1 = FrozenBN(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBN(out_ch)
        self.conv3 = nn.Conv2d(out_ch, 4 * out_ch, 1, bias=False)
        self.bn3 = FrozenBN(4 * out_ch)
        if in_ch != 4 * out_ch or stride != 1:
            self.downsample = nn.Conv2d(in_ch, 4 * out_ch, 1, stride=stride, bias=False)
            self.downsample_bn = FrozenBN(4 * out_ch)

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        residual = self.downsample_bn(self.downsample(x)) if hasattr(self, "downsample") else x
        return torch.relu(h + residual)


class ResNet(nn.Module):
    def __init__(self, depths: Sequence[int] = (3, 4, 6, 3), base_ch: int = 64):
        super().__init__()
        self.depths = tuple(depths)
        self.stem = nn.Conv2d(3, base_ch, 7, stride=2, padding=3, bias=False)
        self.stem_bn = FrozenBN(base_ch)
        ch, in_ch = base_ch, base_ch
        for stage, depth in enumerate(self.depths):
            for blk in range(depth):
                stride = 2 if (blk == 0 and stage > 0) else 1
                self.add_module(f"stage{stage}_block{blk}", Bottleneck(in_ch, ch, stride))
                in_ch = 4 * ch
            ch *= 2

    def forward(self, image: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """image [H, W, 3] → [H, W, C] maps at strides 4, 8, 16, 32."""
        x = image.permute(2, 0, 1)[None].to(self.stem.weight.dtype)
        x = torch.relu(self.stem_bn(self.stem(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for stage, depth in enumerate(self.depths):
            for blk in range(depth):
                x = getattr(self, f"stage{stage}_block{blk}")(x)
            outs.append(x[0].permute(1, 2, 0))
        return tuple(outs)
