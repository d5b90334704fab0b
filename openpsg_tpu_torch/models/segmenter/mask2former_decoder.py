"""Mask2Former masked-attention query decoder (counterpart of
``openpsg_tpu/models/segmenter/mask2former_decoder.py``), the segmenter of
the v1/v2/v3 generations (mmdet Mask2Former, configs/psg/baseline_r50.py):
learned queries, layers cycling over the 3 encoder levels from the
coarsest, and cross-attention restricted to each query's predicted
foreground (arXiv 2112.01527).

The gate is recomputed from the queries at every layer: ``gate_norm`` →
``mask_head`` MLP → a dot product with that level's mask features, taken in
float32 whatever the decoder's dtype, foreground where it is > 0; a query
with no foreground attends everywhere.  The JAX version pads every level to
the largest and masks the pad keys; each layer here attends over its own
level's keys only, which is the same softmax.  LayerNorms use flax's
default epsilon (1e-6), as the JAX version does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from openpsg_tpu_torch.models.common import LayerNorm, mm_f32
from openpsg_tpu_torch.models.segmenter.decoder import MultiHeadAttention
from openpsg_tpu_torch.models.segmenter.deform_layers import (
    MLP,
    cumsum_points_on,
    sine_pos_embed,
)

LN_EPS = 1e-6   # flax nn.LayerNorm's default, which the JAX decoder keeps


class MaskedDecoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_hidden: int, mask_dim: int,
                 num_queries: int):
        super().__init__()
        self.gate_norm = LayerNorm(dim, eps=LN_EPS)
        self.mask_head = MLP(dim, dim, mask_dim, layers=3)
        self.query_pos = nn.Parameter(torch.empty(num_queries, dim))
        self.cross_attn = MultiHeadAttention(dim, num_heads)
        self.ln_cross = LayerNorm(dim, eps=LN_EPS)
        self.self_attn = MultiHeadAttention(dim, num_heads)
        self.ln_self = LayerNorm(dim, eps=LN_EPS)
        self.ffn_up = nn.Linear(dim, ffn_hidden)
        self.ffn_down = nn.Linear(ffn_hidden, dim)
        self.ln_ffn = LayerNorm(dim, eps=LN_EPS)

    def init_extra(self, gen):
        self.query_pos.normal_(0.0, 0.02, generator=gen)

    def forward(self, queries, keys, key_pos, mf_lvl):
        """queries [Q, C]; keys / key_pos [P, C] (one level); mf_lvl [P, Dm]
        the level's mask features."""
        mask_embed = self.mask_head(self.gate_norm(queries))
        gate = mm_f32(mask_embed, mf_lvl, "qc,pc->qp") > 0.0
        gate = gate | ~gate.any(dim=1, keepdim=True)   # empty foreground → everywhere
        qpos = self.query_pos.to(queries.dtype)
        h = self.cross_attn(queries + qpos, keys + key_pos, keys, mask=gate)
        queries = self.ln_cross(queries + h)
        # self-attention adds query_pos to q and k; v stays plain
        sq = queries + qpos
        queries = self.ln_self(queries + self.self_attn(sq, sq, queries))
        f = self.ffn_down(torch.relu(self.ffn_up(queries)))
        return self.ln_ffn(queries + f)


class Mask2FormerDecoder(nn.Module):
    def __init__(self, dim: int = 256, num_queries: int = 100, num_layers: int = 9,
                 num_heads: int = 8, ffn_hidden: int = 2048, mask_dim: int = 256,
                 num_classes: int = 133, num_levels: int = 3):
        super().__init__()
        self.dim, self.num_levels = dim, num_levels
        for lvl in range(num_levels):
            self.register_parameter(f"level_embed{lvl}", nn.Parameter(torch.empty(dim)))
        self.query_embed = nn.Parameter(torch.empty(num_queries, dim))
        self.layers = nn.ModuleList(
            MaskedDecoderLayer(dim, num_heads, ffn_hidden, mask_dim, num_queries)
            for _ in range(num_layers))
        self.decoder_norm = LayerNorm(dim, eps=LN_EPS)
        self.cls_head = nn.Linear(dim, num_classes + 1)
        self.final_mask_head = MLP(dim, dim, mask_dim, layers=3)

    def init_extra(self, gen):
        for lvl in range(self.num_levels):
            getattr(self, f"level_embed{lvl}").normal_(0.0, 1.0, generator=gen)
        self.query_embed.normal_(0.0, 0.02, generator=gen)

    def forward(self, memory: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                mask_features: torch.Tensor):
        """memory [Lv, C] (levels fine-first, strides 8/16/32); mask_features
        [H4, W4, mask_dim] → dict cls_logits [Q, K+1] float32 (void column
        last), masks [Q, H4, W4] float32, query_embed [Q, C]."""
        C = self.dim
        dtype, dev = memory.dtype, memory.device
        levels = []
        start = 0
        for lvl, (h, w) in enumerate(spatial_shapes):
            keys = memory[start:start + h * w]
            pe = sine_pos_embed(cumsum_points_on(((int(h), int(w)),), dev), C).to(dtype)
            pos = pe + getattr(self, f"level_embed{lvl}").to(dtype)[None]
            # torch bilinear without antialiasing: jax.image.resize's
            # antialias=False kernel on this downscale
            mf = F.interpolate(mask_features.permute(2, 0, 1)[None], size=(h, w),
                               mode="bilinear", align_corners=False, antialias=False)
            levels.append((keys, pos, mf[0].permute(1, 2, 0).reshape(h * w, -1)))
            start += h * w
        L = len(spatial_shapes)
        queries = self.query_embed.to(dtype)
        for i, layer in enumerate(self.layers):
            # round-robin from the coarsest level (spatial_shapes are fine-first)
            queries = layer(queries, *levels[L - 1 - (i % L)])
        decoded = self.decoder_norm(queries)
        mask_embed = self.final_mask_head(decoded)
        return {
            "cls_logits": self.cls_head(decoded).float(),
            "masks": mm_f32(mask_embed, mask_features, "qc,hwc->qhw"),
            "query_embed": decoded,
        }
