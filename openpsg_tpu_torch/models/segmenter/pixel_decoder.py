"""Deformable-encoder pixel decoder (counterpart of
``openpsg_tpu/models/segmenter/pixel_decoder.py``): multi-scale encoder
memory over strides 8/16/32(/64) and stride-4 ``mask_features``."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from openpsg_tpu_torch.models.common import GroupNorm32, conv_hwc
from openpsg_tpu_torch.models.segmenter.deform_layers import (
    DeformableEncoderLayer,
    cumsum_points_on,
    reference_points_on,
    shape_key,
    sine_pos_embed,
)


class PixelDecoder(nn.Module):
    def __init__(self, in_dims: Sequence[int], dim: int = 256, num_layers: int = 6,
                 num_heads: int = 8, num_points: int = 4, ffn_hidden: int = 2048,
                 mask_dim: int = 256, total_levels: int = 3,
                 enc_points_per_level: Optional[Tuple[int, ...]] = None):
        """in_dims: channels of the backbone maps at strides 4, 8, 16, 32."""
        super().__init__()
        self.dim, self.total_levels = dim, total_levels
        c2, c3, c4, c5 = in_dims
        for i, c in enumerate((c3, c4, c5)):
            self.add_module(f"input_proj{i}", nn.Conv2d(c, dim, 1))
            self.add_module(f"input_norm{i}", GroupNorm32(dim))
        for i in range(3, total_levels):
            # 3x3 stride-2, torch-style padding 1 (first from raw res5)
            self.add_module(f"input_proj{i}",
                            nn.Conv2d(c5 if i == 3 else dim, dim, 3, stride=2, padding=1))
            self.add_module(f"input_norm{i}", GroupNorm32(dim))
        self.level_embed = nn.Parameter(torch.empty(total_levels, dim))
        ppl = tuple(enc_points_per_level) if enc_points_per_level else None
        self.layers = nn.ModuleList(
            DeformableEncoderLayer(dim, num_heads, total_levels, num_points,
                                   ffn_hidden, points_per_level=ppl)
            for _ in range(num_layers)
        )
        self.lateral4 = nn.Conv2d(c2, dim, 1, bias=False)
        self.lateral4_norm = GroupNorm32(dim)
        self.output4 = nn.Conv2d(dim, dim, 3, padding=1, bias=False)
        self.output4_norm = GroupNorm32(dim)
        self.mask_feature_proj = nn.Conv2d(dim, mask_dim, 1)

    def init_extra(self, gen):
        self.level_embed.normal_(0.0, 1.0, generator=gen)

    def forward(self, features):
        """features: [H, W, C] maps at strides (4, 8, 16, 32).
        → (memory [Lv, dim] level-major fine-first, spatial_shapes,
        mask_features [H/4, W/4, mask_dim])."""
        c2, c3, c4, c5 = features
        tokens = []
        for i, f in enumerate((c3, c4, c5)):
            tokens.append(getattr(self, f"input_norm{i}")(
                conv_hwc(getattr(self, f"input_proj{i}"), f)))
        prev = c5
        for i in range(3, self.total_levels):
            t = getattr(self, f"input_norm{i}")(
                conv_hwc(getattr(self, f"input_proj{i}"), prev))
            tokens.append(t)
            prev = t
        spatial_shapes = shape_key(t.shape[:2] for t in tokens)
        dtype, dev = tokens[0].dtype, tokens[0].device

        pos = []
        for i, t in enumerate(tokens):
            p = sine_pos_embed(cumsum_points_on(spatial_shapes[i:i + 1], dev), self.dim)
            pos.append(p.to(dtype) + self.level_embed[i][None, :].to(dtype))
        src = torch.cat([t.reshape(-1, self.dim) for t in tokens], 0)
        pos_embed = torch.cat(pos, 0)
        ref = reference_points_on(spatial_shapes, dev)
        for layer in self.layers:
            src = layer(src, spatial_shapes, ref, pos_embed)

        # FPN to stride 4: lateral res2 + bilinear upsample of the stride-8
        # encoder output (half-pixel centres, as jax.image.resize)
        h8, w8 = spatial_shapes[0]
        enc8 = src[: h8 * w8].reshape(h8, w8, self.dim)
        lat4 = self.lateral4_norm(conv_hwc(self.lateral4, c2))
        up = F.interpolate(
            enc8.permute(2, 0, 1)[None], size=(c2.shape[0], c2.shape[1]),
            mode="bilinear", align_corners=False,
        )[0].permute(1, 2, 0).to(dtype)
        fused = self.output4_norm(conv_hwc(self.output4, lat4 + up))
        mask_features = conv_hwc(self.mask_feature_proj, torch.relu(fused))
        return src, spatial_shapes, mask_features
