"""Relation head v1: a BERT-style tower over the object tokens and
per-relation bilinear scores (counterpart of
``openpsg_tpu/models/relation/head_v1.py``; reference
kings_sgg/models/relation_heads/relation_transformer_head.py).

``fc_input`` (only when the token width differs from the tower's) → the
tower, every object token at the constant position id 1 → ``fc_output`` →
either per-relation ``cls_q`` / ``cls_k`` projections scored by a scaled
(``attention``) or plain (``einsum``) dot product, or the predicate-prompt
path: predicate descriptions through an in-head ``sem_encoder`` (pooled,
optionally with per-relation learnable prompt rows) fused with the objects
by the :class:`InteractiveFusionModule`.  :meth:`RelationHeadV1.loss` holds
the loss types v0_softmax / v0_sigmoid / v1 / v1_no_bs_limit with the
-9999 pad masking, and recall@20.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from openpsg_tpu_torch.models.common import mm_f32
from openpsg_tpu_torch.models.commons.interactive_fusion import InteractiveFusionModule
from openpsg_tpu_torch.models.commons.text_encoder import (
    BertStyleConfig,
    BertStyleEncoder,
    DenseLN,
)
from openpsg_tpu_torch.train import losses as L


@dataclasses.dataclass(frozen=True)
class HeadV1Config:
    encoder: BertStyleConfig = BertStyleConfig()
    input_feature_size: int = 256
    output_feature_size: int = 768
    num_relation_classes: int = 56
    cls_qk_size: int = 64
    pred_type: str = "attention"          # attention | einsum
    use_relation_prompts: bool = False    # predicate-text fusion path
    fusion_pred_type: str = "einsum"
    graph_transformer_type: Optional[str] = None   # None | 'base'
    use_learnable_prompts: bool = False
    learnable_prompts_size: int = 16
    semantic_type: str = "relation_classes"
    loss_type: str = "v1"
    loss_weight: float = 50.0
    loss_alpha: float = 1.0
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny_test(**kw) -> "HeadV1Config":
        base = dict(encoder=BertStyleConfig.tiny_test(), input_feature_size=16,
                    output_feature_size=32, cls_qk_size=8)
        base.update(kw)
        return HeadV1Config(**base)


class RelationHeadV1(nn.Module):
    def __init__(self, cfg: HeadV1Config, token_dim: Optional[int] = None,
                 semantic_dim: Optional[int] = None):
        """``token_dim``: the object tokens' width (default
        ``input_feature_size``); ``fc_input`` exists when it differs from
        ``output_feature_size``.  ``semantic_dim``: on the prompt path, the
        width of predicate embeddings the caller passes in place of the
        in-head ``sem_encoder`` (None: the head encodes the descriptions)."""
        super().__init__()
        c = self.cfg = cfg
        D, R = c.output_feature_size, c.num_relation_classes
        token_dim = token_dim or c.input_feature_size
        if token_dim != D:
            self.fc_input = DenseLN(token_dim, D)
        tower = dataclasses.replace(c.encoder, hidden_size=D)
        self.encoder = BertStyleEncoder(tower, word_embeddings=False)
        self.fc_output = DenseLN(D, D)
        if not c.use_relation_prompts:
            if c.pred_type not in ("attention", "einsum"):
                raise ValueError(c.pred_type)
            self.cls_q = nn.Linear(D, R * c.cls_qk_size)
            self.cls_k = nn.Linear(D, R * c.cls_qk_size)
            return
        if semantic_dim is None:
            if c.use_learnable_prompts:
                self.learnable_prompts_embedding = nn.Parameter(
                    torch.empty(R, c.learnable_prompts_size, D))
            self.sem_encoder = BertStyleEncoder(tower)
        self.fusion = InteractiveFusionModule(
            D, semantic_dim or D, pred_type=c.fusion_pred_type, output_size=c.cls_qk_size,
            use_graph_transformer=c.graph_transformer_type is not None)

    def init_extra(self, gen):
        if hasattr(self, "learnable_prompts_embedding"):
            self.learnable_prompts_embedding.normal_(0.0, 0.02, generator=gen)

    def forward(self, object_embeds, attention_mask, semantic_embeds=None,
                semantic_token_ids=None, semantic_token_mask=None):
        """object_embeds [B, N, C] mask-pooled tokens; attention_mask [B, N]
        bool; the prompt path takes ``semantic_embeds`` [R, D] or the
        predicate descriptions' ``semantic_token_ids`` / ``_mask`` [R, L]
        → [B, R, N, N] float32 scores."""
        c = self.cfg
        x = self.fc_input(object_embeds) if hasattr(self, "fc_input") else object_embeds
        x = self.encoder(input_embeds=x, attention_mask=attention_mask, position_ids=1)
        x = self.fc_output(x)
        B, N, _ = x.shape
        R = c.num_relation_classes
        if not c.use_relation_prompts:
            q = self.cls_q(x).reshape(B, N, R, c.cls_qk_size).permute(0, 2, 1, 3)
            k = self.cls_k(x).reshape(B, N, R, c.cls_qk_size).permute(0, 2, 1, 3)
            scores = mm_f32(q, k, "brnc,brmc->brnm")
            if c.pred_type == "attention":
                scores = scores / (c.cls_qk_size ** 0.5)
            return scores
        if semantic_embeds is None:
            if semantic_token_ids is None:
                raise ValueError("the prompt path needs semantic_embeds or semantic_token_ids")
            semantic_embeds = self.sem_encoder(
                token_ids=semantic_token_ids, attention_mask=semantic_token_mask, pool=True,
                learnable_embeds=getattr(self, "learnable_prompts_embedding", None))
        return self.fusion(x, semantic_embeds)

    def loss(self, pred, target, valid) -> Dict[str, torch.Tensor]:
        """pred / target [B, R, N, N]; valid [B, N] bool → {loss_relation,
        relation.recall@20 (not for v0_softmax)}."""
        c = self.cfg
        B, R, N, _ = pred.shape
        pair = valid[:, None, :, None] & valid[:, None, None, :]
        mask = pair.expand(pred.shape).to(pred.dtype)
        pred = pred * mask + L.NEG_INF * (1.0 - mask)
        if c.loss_type == "v0_sigmoid":
            per = pred.clamp(min=0) - pred * target + torch.log1p(torch.exp(-pred.abs()))
            loss = per.mean()
        elif c.loss_type == "v0_softmax":
            labels = target.argmax(dim=1)                          # [B, N, N]
            labels = torch.where((target > 0).any(dim=1), labels, torch.full_like(labels, R))
            logits = torch.cat([pred, pred.new_zeros(B, 1, N, N)], dim=1).permute(0, 2, 3, 1)
            logp = torch.log_softmax(logits, dim=-1)
            nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
            w = pair[:, 0].expand(nll.shape).to(nll.dtype)
            loss = (nll * w).sum() / w.sum().clamp(min=1.0)
        elif c.loss_type in ("v1", "v1_no_bs_limit"):
            flat_p = pred.permute(1, 0, 2, 3).reshape(R, -1)
            flat_t = target.permute(1, 0, 2, 3).reshape(R, -1)
            per = L.multilabel_categorical_crossentropy(flat_t, flat_p)
            w = (per / (per.max() + 1e-12)) ** c.loss_alpha
            loss = (per * w).mean()
        else:
            raise ValueError(c.loss_type)
        out = {"loss_relation": loss * c.loss_weight}
        if c.loss_type != "v0_softmax":
            out["relation.recall@20"] = L.recall_at_k(pred, target, k=20)
        return out
