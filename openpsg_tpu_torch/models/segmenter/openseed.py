"""OpenSeeD-style panoptic segmenter assembly (counterpart of
``openpsg_tpu/models/segmenter/openseed.py``): Swin backbone → deformable
pixel decoder → two-stage query decoder."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from openpsg_tpu_torch.models.common import device_constant
from openpsg_tpu_torch.models.segmenter.decoder import QueryDecoder
from openpsg_tpu_torch.models.segmenter.pixel_decoder import PixelDecoder
from openpsg_tpu_torch.models.segmenter.swin import SwinTransformer

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


@dataclasses.dataclass(frozen=True)
class SegmenterConfig:
    """Defaults: the published OpenSeeD Swin-T geometry (300 queries, 6
    encoder / 9 decoder layers, 4 levels, 512-d language projection)."""

    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    dim: int = 256
    mask_dim: int = 256
    num_queries: int = 300
    enc_layers: int = 6
    dec_layers: int = 9
    num_points: int = 4
    ffn_hidden: int = 2048
    total_levels: int = 4
    proj_dim: int = 512
    ckpt_level_strides: Tuple[int, ...] = (32, 16, 8, 64)
    enc_points_per_level: Optional[Tuple[int, ...]] = None
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny_test() -> "SegmenterConfig":
        return SegmenterConfig(
            embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 2),
            window=4, dim=32, mask_dim=32, num_queries=20, enc_layers=1,
            dec_layers=2, ffn_hidden=64, total_levels=3, proj_dim=32,
        )


class OpenSeedSegmenter(nn.Module):
    def __init__(self, cfg: SegmenterConfig):
        super().__init__()
        c = self.cfg = cfg
        self.backbone = SwinTransformer(c.embed_dim, c.depths, c.num_heads, c.window)
        self.pixel_decoder = PixelDecoder(
            [c.embed_dim * 2 ** i for i in range(4)], dim=c.dim,
            num_layers=c.enc_layers, num_points=c.num_points,
            ffn_hidden=c.ffn_hidden, mask_dim=c.mask_dim,
            total_levels=c.total_levels,
            enc_points_per_level=c.enc_points_per_level,
        )
        internal_strides = [8, 16, 32] + [64 * 2 ** i for i in range(c.total_levels - 3)]
        wh_exp = tuple(c.ckpt_level_strides.index(s)
                       for s in internal_strides[: c.total_levels])
        self.decoder = QueryDecoder(
            dim=c.dim, num_queries=c.num_queries, num_layers=c.dec_layers,
            num_points=c.num_points, ffn_hidden=c.ffn_hidden,
            mask_dim=c.mask_dim, proj_dim=c.proj_dim,
            num_levels=c.total_levels, level_wh_exp=wh_exp,
        )

    def forward(self, image, class_embeds) -> Dict[str, torch.Tensor]:
        """image: [H, W, 3] normalized, H and W divisible by 32."""
        feats = self.backbone(image)
        memory, spatial_shapes, mask_features = self.pixel_decoder(feats)
        out = self.decoder(memory, spatial_shapes, mask_features, class_embeds)
        out["mask_features"] = mask_features
        return out


@device_constant
def pixel_stats():
    """(mean, std) [3] float32 of the RGB channels."""
    return np.asarray(PIXEL_MEAN, np.float32), np.asarray(PIXEL_STD, np.float32)


def normalize_image(image_u8: torch.Tensor) -> torch.Tensor:
    """uint8/float [H, W, 3] RGB 0-255 → normalized float32."""
    mean, std = pixel_stats(image_u8.device)
    return (image_u8.float() - mean) / std
