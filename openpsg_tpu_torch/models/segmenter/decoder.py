"""MaskDINO-style two-stage query decoder with open-vocabulary (cosine)
classification (counterpart of ``openpsg_tpu/models/segmenter/decoder.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from openpsg_tpu_torch.models.common import LayerNorm, device_constant, mm_f32
from openpsg_tpu_torch.models.segmenter.deform_layers import (
    FFN,
    MLP,
    MSDeformAttnLayer,
    box_sine_embed,
    inverse_sigmoid,
    make_reference_points,
    shape_key,
)


@device_constant
def proposal_bases(spatial_shapes: Tuple[Tuple[int, int], ...], wh_exp: Tuple[int, ...]):
    """The two-stage proposals' fixed part (gen_encoder_output_proposals):
    → (valid [Lv] bool, base [Lv, 4] float32 cxcywh, inf, the float32
    scalar that invalid proposal logits take).  A border proposal outside
    (0.01, 0.99) is invalid."""
    centers = make_reference_points(spatial_shapes)
    base_wh = np.concatenate([
        np.full((h * w, 2), 0.05, np.float32) * (2.0 ** wh_exp[lvl])
        for lvl, (h, w) in enumerate(spatial_shapes)
    ])
    base = np.concatenate([centers, base_wh], -1).astype(np.float32)
    valid = ((base > 0.01) & (base < 0.99)).all(-1)
    return valid, base, np.asarray(float("inf"), np.float32)


def topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of a 1-D tensor, ties to the lower
    index (``jax.lax.top_k``'s rule; ``torch.topk`` promises no order)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (query/key/value/out dense
    layers over [heads, head_dim])."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, q_in, k_in, v_in, mask=None):
        """q_in [L, D], k_in / v_in [S, D]; ``mask`` [L, S] bool (True =
        attend; masked logits take float32's minimum, as flax's)."""
        L, D = q_in.shape
        H = self.num_heads
        hd = D // H
        q = self.query(q_in).reshape(L, H, hd) / (hd ** 0.5)
        k = self.key(k_in).reshape(-1, H, hd)
        v = self.value(v_in).reshape(-1, H, hd)
        logits = mm_f32(q, k, "qhd,khd->hqk")
        if mask is not None:
            logits = logits.masked_fill(~mask[None], torch.finfo(logits.dtype).min)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("hqk,khd->qhd", attn, v).reshape(L, D)
        return self.out(out)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.mha = MultiHeadAttention(dim, num_heads)
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x, pos):
        qk = x + pos
        return self.norm(x + self.mha(qk, qk, x))


class DecoderLayer(nn.Module):
    def __init__(self, dim, num_heads, num_levels, num_points, ffn_hidden):
        super().__init__()
        self.ref_point_head = MLP(2 * dim, dim, dim, layers=2)
        self.self_attn = SelfAttention(dim, num_heads)
        self.cross_attn = MSDeformAttnLayer(dim, num_heads, num_levels, num_points)
        self.norm_cross = LayerNorm(dim, eps=1e-5)
        self.ffn = FFN(dim, ffn_hidden)
        self.box_head = MLP(dim, dim, 4, layers=3)

    def forward(self, queries, boxes, memory, spatial_shapes):
        dim = queries.shape[-1]
        qpos = self.ref_point_head(box_sine_embed(boxes, dim).to(queries.dtype))
        queries = self.self_attn(queries, qpos)
        cross = self.cross_attn(queries + qpos, memory, spatial_shapes, boxes)
        queries = self.ffn(self.norm_cross(queries + cross))
        delta = self.box_head(queries)
        boxes = torch.sigmoid(inverse_sigmoid(boxes) + delta.float())
        return queries, boxes


class QueryDecoder(nn.Module):
    def __init__(self, dim=256, num_queries=300, num_layers=9, num_heads=8,
                 num_points=4, ffn_hidden=2048, mask_dim=256, proj_dim=512,
                 num_levels=3, level_wh_exp: Optional[Tuple[int, ...]] = None):
        super().__init__()
        self.num_queries, self.level_wh_exp = num_queries, level_wh_exp
        self.class_embed = nn.Parameter(torch.empty(dim, proj_dim))
        self.logit_scale = nn.Parameter(torch.empty(()))
        self.enc_proj = nn.Linear(dim, dim)
        self.enc_norm = LayerNorm(dim, eps=1e-5)
        self.enc_box_head = MLP(dim, dim, 4, layers=3)
        self.layers = nn.ModuleList(
            DecoderLayer(dim, num_heads, num_levels, num_points, ffn_hidden)
            for _ in range(num_layers)
        )
        self.decoder_norm = LayerNorm(dim, eps=1e-5)
        self.mask_head = MLP(dim, dim, mask_dim, layers=3)

    def init_extra(self, gen):
        self.class_embed.normal_(0.0, self.class_embed.shape[0] ** -0.5, generator=gen)
        self.logit_scale.fill_(2.659)  # ln(1/0.07)

    def _class_logits(self, x, class_embeds):
        proj = mm_f32(x, self.class_embed, "qc,cp->qp")
        proj = proj / (torch.linalg.norm(proj, dim=-1, keepdim=True) + 1e-6)
        return (proj @ class_embeds.float().T) * torch.exp(self.logit_scale.float())

    def forward(self, memory, spatial_shapes, mask_features, class_embeds):
        """memory [Lv, C]; mask_features [H4, W4, mask_dim]; class_embeds
        [num_classes, proj_dim] → dict cls_logits [Q, classes] f32, masks
        [Q, H4, W4] f32, boxes [Q, 4] cxcywh, query_embed [Q, C]."""
        # two-stage proposals: invalid border proposals have their memory
        # zeroed and proposal logits +inf, but all rows still compete in the
        # top-k
        wh_exp = tuple(self.level_wh_exp or range(len(spatial_shapes)))
        valid, base, inf = proposal_bases(shape_key(spatial_shapes), wh_exp, memory.device)

        enc_out = self.enc_norm(self.enc_proj(
            torch.where(valid[:, None], memory, torch.zeros_like(memory))))
        enc_score = self._class_logits(enc_out, class_embeds).max(dim=-1).values
        top_idx = topk_indices(enc_score, self.num_queries)
        enc_delta = self.enc_box_head(enc_out)
        proposal_logits = torch.where(valid[:, None], inverse_sigmoid(base), inf)
        proposal_boxes = torch.sigmoid(proposal_logits + enc_delta.float())
        # the proposals start the decoder without a gradient (the JAX
        # decoder's stop_gradient): in training, the encoder's proposal
        # layers get none
        queries = enc_out[top_idx].detach()
        boxes = proposal_boxes[top_idx].detach()

        for layer in self.layers:
            queries, boxes = layer(queries, boxes, memory, spatial_shapes)

        decoded = self.decoder_norm(queries)
        mask_embed = self.mask_head(decoded)
        return {
            "cls_logits": self._class_logits(decoded, class_embeds),
            "masks": mm_f32(mask_embed, mask_features, "qc,hwc->qhw"),
            "boxes": boxes,
            "query_embed": decoded,
        }
