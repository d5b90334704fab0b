"""Mask2Former panoptic segmenter (counterpart of
``openpsg_tpu/models/segmenter/mask2former.py``), for the v1/v2/v3
generations: backbone (ResNet-50 or Swin) → the deformable-encoder pixel
decoder shared with the OpenSeeD path → the masked-attention query decoder.
Returns the query predictions with a void class column and the stride-4
``mask_features``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from openpsg_tpu_torch.models.segmenter.mask2former_decoder import Mask2FormerDecoder
from openpsg_tpu_torch.models.segmenter.pixel_decoder import PixelDecoder
from openpsg_tpu_torch.models.segmenter.resnet import ResNet
from openpsg_tpu_torch.models.segmenter.swin import SwinTransformer

# backbone preset → (constructor keyword arguments, channels at strides 4..32)
BACKBONES = {
    "r50": ("resnet", dict(depths=(3, 4, 6, 3), base_ch=64)),
    "tiny_r50": ("resnet", dict(depths=(1, 1, 1, 1), base_ch=8)),   # converter tests
    "swin_t": ("swin", dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                            window=7)),
    "swin_b": ("swin", dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
                            window=12)),
    "tiny": ("swin", dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 2),
                          window=4)),
}


@dataclasses.dataclass(frozen=True)
class Mask2FormerConfig:
    backbone: str = "r50"             # r50 | tiny_r50 | swin_t | swin_b | tiny
    dim: int = 256
    mask_dim: int = 256
    num_queries: int = 100
    enc_layers: int = 6
    dec_layers: int = 9
    ffn_hidden: int = 2048            # query decoder FFN width
    # pixel-decoder FFN width (the reference's is 1024 against the
    # decoder's 2048, baseline_r50.py:70-75 vs :100-104); None → ffn_hidden
    enc_ffn_hidden: Optional[int] = None
    num_classes: int = 133
    enc_points_per_level: Optional[Tuple[int, ...]] = None
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny_test() -> "Mask2FormerConfig":
        return Mask2FormerConfig(
            backbone="tiny", dim=32, mask_dim=32, num_queries=20,
            enc_layers=1, dec_layers=3, ffn_hidden=64, num_classes=8,
        )


def backbone_channels(preset: str) -> Tuple[int, ...]:
    kind, kw = BACKBONES[preset]
    if kind == "resnet":
        return tuple(4 * kw["base_ch"] * 2 ** i for i in range(4))
    return tuple(kw["embed_dim"] * 2 ** i for i in range(4))


class Mask2FormerSegmenter(nn.Module):
    def __init__(self, cfg: Mask2FormerConfig):
        super().__init__()
        c = self.cfg = cfg
        if c.backbone not in BACKBONES:
            raise ValueError(c.backbone)
        kind, kw = BACKBONES[c.backbone]
        self.backbone = ResNet(**kw) if kind == "resnet" else SwinTransformer(**kw)
        self.pixel_decoder = PixelDecoder(
            backbone_channels(c.backbone), dim=c.dim, num_layers=c.enc_layers,
            ffn_hidden=c.enc_ffn_hidden or c.ffn_hidden, mask_dim=c.mask_dim,
            total_levels=3, enc_points_per_level=c.enc_points_per_level,
        )
        self.decoder = Mask2FormerDecoder(
            dim=c.dim, num_queries=c.num_queries, num_layers=c.dec_layers,
            ffn_hidden=c.ffn_hidden, mask_dim=c.mask_dim, num_classes=c.num_classes,
        )

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """image [H, W, 3] normalized, H and W divisible by 32."""
        feats = self.backbone(image)
        memory, spatial_shapes, mask_features = self.pixel_decoder(feats)
        out = self.decoder(memory, spatial_shapes, mask_features)
        out["mask_features"] = mask_features
        return out
