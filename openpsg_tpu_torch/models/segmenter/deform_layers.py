"""Deformable-transformer building blocks (counterpart of
``openpsg_tpu/models/segmenter/deform_layers.py``).  Single image, no batch
axis; parameter names follow the flax modules."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from openpsg_tpu_torch.models.common import LayerNorm, device_constant
from openpsg_tpu_torch.ops.deform_attn import ms_deform_attn


def shape_key(spatial_shapes) -> Tuple[Tuple[int, int], ...]:
    """Level shapes as a tuple of (h, w) int pairs: the cached constants' key."""
    return tuple((int(h), int(w)) for h, w in spatial_shapes)


def make_reference_points(spatial_shapes: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Normalized (x, y) pixel-centre reference points of every level: [Lv, 2]."""
    pts = []
    for (h, w) in spatial_shapes:
        ys, xs = np.meshgrid(
            (np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij"
        )
        pts.append(np.stack([xs, ys], -1).reshape(-1, 2))
    return np.concatenate(pts, 0).astype(np.float32)


def make_cumsum_points(spatial_shapes: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Normalized (x, y) in the d2/mmdet cumsum convention ((i+1)/(H+1e-6)),
    used for sine position embeddings only."""
    eps = 1e-6
    pts = []
    for (h, w) in spatial_shapes:
        ys, xs = np.meshgrid(
            (np.arange(h) + 1.0) / (h + eps), (np.arange(w) + 1.0) / (w + eps),
            indexing="ij",
        )
        pts.append(np.stack([xs, ys], -1).reshape(-1, 2))
    return np.concatenate(pts, 0).astype(np.float32)


# the same on a device, cached per (spatial_shapes, device): pass the
# shapes as a tuple of (h, w) int pairs
reference_points_on = device_constant(make_reference_points)
cumsum_points_on = device_constant(make_cumsum_points)


@device_constant
def level_sizes(spatial_shapes: Tuple[Tuple[int, int], ...]) -> np.ndarray:
    """Each level's (w, h) as float32: [L, 2]."""
    return np.asarray([(w, h) for (h, w) in spatial_shapes], np.float32)


@device_constant
def point_keep(L: int, K: int, points_per_level: Tuple[int, ...]) -> np.ndarray:
    """[L, K] float32: 1 for the first K_l points of level l, else 0."""
    keep = np.zeros((L, K), np.float32)
    for lvl, kl in enumerate(points_per_level):
        keep[lvl, : int(kl)] = 1.0
    return keep


def _grid_offset_bias(nH: int, L: int, K: int) -> np.ndarray:
    """Deformable DETR's initial sampling ring (``_grid_offset_init``)."""
    theta = np.arange(nH) * (2.0 * np.pi / nH)
    grid = np.stack([np.cos(theta), np.sin(theta)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, L, K, 1))
    for k in range(K):
        grid[:, :, k] *= k + 1
    return grid.reshape(-1).astype(np.float32)


class MSDeformAttnLayer(nn.Module):
    """Learned-offset multi-scale deformable attention; ``points_per_level``
    reads only the first K_l points per level and renormalizes the weights
    over them (parameters unchanged)."""

    def __init__(self, dim=256, num_heads=8, num_levels=3, num_points=4,
                 points_per_level: Optional[Tuple[int, ...]] = None):
        super().__init__()
        self.dim, self.nH, self.L, self.K = dim, num_heads, num_levels, num_points
        self.points_per_level = points_per_level
        self.value_proj = nn.Linear(dim, dim)
        self.sampling_offsets = nn.Linear(dim, num_heads * num_levels * num_points * 2)
        self.attention_weights = nn.Linear(dim, num_heads * num_levels * num_points)
        self.output_proj = nn.Linear(dim, dim)

    def init_extra(self, gen):
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_(
            torch.from_numpy(_grid_offset_bias(self.nH, self.L, self.K))
        )
        self.attention_weights.weight.zero_()

    def forward(self, query, value, spatial_shapes, reference_points):
        """query [Lq, C]; value [Lv, C]; reference_points [Lq, 2] centres or
        [Lq, 4] cxcywh boxes (normalized) → [Lq, C]."""
        Lq = query.shape[0]
        nH, L, K = self.nH, self.L, self.K
        v = self.value_proj(value).reshape(1, -1, nH, self.dim // nH)
        off = self.sampling_offsets(query).reshape(1, Lq, nH, L, K, 2).float()
        attn = self.attention_weights(query).reshape(1, Lq, nH, L * K)
        attn = torch.softmax(attn.float(), dim=-1).reshape(1, Lq, nH, L, K)
        if self.points_per_level is not None:
            attn = attn * point_keep(L, K, tuple(self.points_per_level), attn.device)
            attn = attn / torch.clamp(attn.sum(dim=(-2, -1), keepdim=True), min=1e-9)
        ref = reference_points.float()
        if ref.shape[-1] == 2:
            sizes = level_sizes(shape_key(spatial_shapes), ref.device)
            loc = ref[None, :, None, None, None, :] + off / sizes[None, None, None, :, None, :]
        else:
            centers, wh = ref[..., :2], ref[..., 2:]
            loc = (centers[None, :, None, None, None, :]
                   + off / K * wh[None, :, None, None, None, :] * 0.5)
        out = ms_deform_attn(v, spatial_shapes, loc, attn,
                             points_per_level=self.points_per_level)[0]
        return self.output_proj(out)


class FFN(nn.Module):
    def __init__(self, dim=256, hidden=2048):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        return self.norm(x + self.fc2(torch.relu(self.fc1(x))))


class DeformableEncoderLayer(nn.Module):
    def __init__(self, dim=256, num_heads=8, num_levels=3, num_points=4,
                 ffn_hidden=2048, points_per_level=None):
        super().__init__()
        self.self_attn = MSDeformAttnLayer(dim, num_heads, num_levels, num_points,
                                           points_per_level=points_per_level)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.ffn = FFN(dim, ffn_hidden)

    def forward(self, src, spatial_shapes, reference_points, pos_embed):
        attn_out = self.self_attn(src + pos_embed, src, spatial_shapes, reference_points)
        return self.ffn(self.norm1(src + attn_out))


class MLP(nn.Module):
    def __init__(self, in_dim: int, hidden: int, out: int, layers: int = 3):
        super().__init__()
        self.layers = layers
        dims = [in_dim] + [hidden] * (layers - 1) + [out]
        for i in range(layers):
            self.add_module(f"fc{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.layers - 1):
            x = torch.relu(getattr(self, f"fc{i}")(x))
        return getattr(self, f"fc{self.layers - 1}")(x)


@device_constant
def sine_ladder(half: int, temperature: float) -> np.ndarray:
    """The sine embedding's shared frequency ladder: [half] float32."""
    return np.asarray(temperature ** (2.0 * (np.arange(half) // 2) / half), np.float32)


def _sine_1d(v: torch.Tensor, half: int, temperature: float) -> torch.Tensor:
    """[..., 1] normalized coordinate → [..., half], interleaved (sin, cos)
    over a shared frequency ladder (detectron2 PositionEmbeddingSine)."""
    dim_t = sine_ladder(half, temperature, v.device)
    ang = v.float() * (2.0 * np.pi) / dim_t
    sin = torch.sin(ang[..., 0::2])
    cos = torch.cos(ang[..., 1::2])
    return torch.stack([sin, cos], dim=-1).reshape(*ang.shape[:-1], half)


def sine_pos_embed(coords: torch.Tensor, dim: int = 256, temperature: float = 10000.0):
    """Normalized (x, y) [..., 2] → [..., dim] as [y-features, x-features]."""
    half = dim // 2
    y = _sine_1d(coords[..., 1:2], half, temperature)
    x = _sine_1d(coords[..., 0:1], half, temperature)
    return torch.cat([y, x], dim=-1)


def box_sine_embed(boxes: torch.Tensor, dim: int = 256, temperature: float = 10000.0):
    """Normalized (cx, cy, w, h) [..., 4] → [..., 2*dim] as [cy, cx, w, h]."""
    half = dim // 2
    parts = [_sine_1d(boxes[..., i:i + 1], half, temperature) for i in (1, 0, 2, 3)]
    return torch.cat(parts, dim=-1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))
