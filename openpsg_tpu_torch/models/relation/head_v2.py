"""Relation head v2: five switchable experts and a learned MoE gate
(counterpart of ``openpsg_tpu/models/relation/head_v2.py``; reference
kings_sgg/models/relation_heads/relation_transformer_head_v2.py).

Experts, each a dense [B, R, N, N] score map:

* ``object_vision_only``: DenseLN → BERT over the object tokens → DenseLN →
  per-relation full-width sub/obj projections, unscaled dot product;
* ``pair_vision_only``: the N² sub⊕obj pair tokens through the shared pair
  tower, self-attention only;
* ``pair_text2vision``: pair text attends to pair vision;
* ``pair_vision2text``: pair vision attends to pair text;
* ``triplet_text_w_vision``: pair vision attends to per-relation triplet
  text (the relation axis folded into the batch: one tower call), with
  per-relation Linear(D, 1) heads.

Experts 2-5 share one cross-attention tower (``pair_encoder``, causal over
the sub-major pair order, as HF decoder-mode BERT is); every tower call
uses the constant position id 0.  The gate (``use_moe_gate``) weighs the
experts per pair (``moe_weight_type`` v1) or per (relation, pair) (v2).
:meth:`RelationHeadV2.primary` picks the map inference uses: the last
enabled expert, the gate over all.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn as nn

from openpsg_tpu_torch.models.common import mm_f32
from openpsg_tpu_torch.models.commons.text_encoder import (
    BertStyleConfig,
    BertStyleEncoder,
    DenseLN,
)

# the reference's cascade order: later entries override earlier ones at
# inference; moe wins over all
EXPERT_ORDER = (
    "object_vision_only",
    "pair_vision_only",
    "pair_text2vision",
    "pair_vision2text",
    "triplet_text_w_vision",
)


@dataclasses.dataclass(frozen=True)
class HeadV2Config:
    encoder: BertStyleConfig = BertStyleConfig()
    feature_size: int = 768
    num_relation_classes: int = 56
    text_embedding_size: int = 1536      # ada-002
    experts: Tuple[str, ...] = ("object_vision_only",)
    use_moe_gate: bool = False
    moe_weight_type: str = "v1"          # v1 (per pair) | v2 (per pair and relation)
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny_test(**kw) -> "HeadV2Config":
        base = dict(encoder=BertStyleConfig.tiny_test(), feature_size=32,
                    text_embedding_size=16)
        base.update(kw)
        return HeadV2Config(**base)


class RelationHeadV2(nn.Module):
    def __init__(self, cfg: HeadV2Config, token_dim: int, max_objects: int):
        """``token_dim``: the raw object tokens' width; ``max_objects``: the
        padded object count N (the pair tower's position table covers N²)."""
        super().__init__()
        c = self.cfg = cfg
        D, R, T = c.feature_size, c.num_relation_classes, c.text_embedding_size
        experts = set(c.experts)
        if not experts:
            raise ValueError("no experts enabled")
        pair_in = 2 * token_dim
        if "object_vision_only" in experts:
            self.fc_ovo_input = DenseLN(token_dim, D)
            self.object_encoder = BertStyleEncoder(
                dataclasses.replace(c.encoder, hidden_size=D), word_embeddings=False)
            self.fc_ovo_output = DenseLN(D, D)
            self.ovo_sub = nn.Linear(D, R * D)
            self.ovo_obj = nn.Linear(D, R * D)
        if experts & set(EXPERT_ORDER[1:]):
            self.pair_encoder = BertStyleEncoder(dataclasses.replace(
                c.encoder, hidden_size=D, add_cross_attention=True, encoder_hidden_size=D,
                causal=True, max_len=max(c.encoder.max_len, max_objects ** 2)),
                word_embeddings=False)
        if "pair_vision_only" in experts:
            self.fc_pvo_input = DenseLN(pair_in, D)
            self.fc_pvo_output = DenseLN(D, D)
            self.pvo_cls = nn.Linear(D, R)
        if "pair_text2vision" in experts:
            self.fc_pt2v_text_input = DenseLN(T, D)
            self.fc_pt2v_vision_prompt = DenseLN(pair_in, D)
            self.fc_pt2v_output = DenseLN(D, D)
            self.pt2v_cls = nn.Linear(D, R)
        if "pair_vision2text" in experts:
            self.fc_pv2t_vision_input = DenseLN(pair_in, D)
            self.fc_pv2t_text_prompt = DenseLN(T, D)
            self.fc_pv2t_output = DenseLN(D, D)
            self.pv2t_cls = nn.Linear(D, R)
        if "triplet_text_w_vision" in experts:
            self.fc_ttwv_vision_input = DenseLN(pair_in, D)
            self.fc_ttwv_text_prompt = DenseLN(T, D)
            self.fc_ttwv_output = DenseLN(D, D)
            self.ttwv_cls_w = nn.Parameter(torch.empty(R, D))
            self.ttwv_cls_b = nn.Parameter(torch.empty(R))
        if c.use_moe_gate:
            if c.moe_weight_type not in ("v1", "v2"):
                raise ValueError(c.moe_weight_type)
            E = sum(e in experts for e in EXPERT_ORDER)
            self.moe_input_pair_vision = DenseLN(pair_in, D)
            self.moe_input_pair_text = DenseLN(T, D)
            self.moe_input_triplet_text = DenseLN(T, D)
            self.moe_fc1 = DenseLN(D, D)
            self.moe_fc2 = DenseLN(D, D)
            self.moe_out = nn.Linear(D, E if c.moe_weight_type == "v1" else R * E)

    def init_extra(self, gen):
        if hasattr(self, "ttwv_cls_w"):
            self.ttwv_cls_w.normal_(0.0, self.cfg.feature_size ** -0.5, generator=gen)
            self.ttwv_cls_b.zero_()

    def forward(self, object_embeds, attention_mask, pair_text_embeds=None,
                triplet_text_embeds=None) -> Dict[str, torch.Tensor]:
        """object_embeds [B, N, D0]; attention_mask [B, N] bool;
        pair_text_embeds [B, N, N, T]; triplet_text_embeds [B, N, N, R, T]
        (or [B, N, N, T] for the gate alone) → {expert: [B, R, N, N]
        float32} (+ ``moe``)."""
        c = self.cfg
        B, N, D0 = object_embeds.shape
        R, D = c.num_relation_classes, c.feature_size
        experts = set(c.experts)
        out: Dict[str, torch.Tensor] = {}
        pm = (attention_mask[:, :, None] & attention_mask[:, None, :]).reshape(B, N * N)
        pair_raw = None
        if hasattr(self, "pair_encoder") or c.use_moe_gate:
            # sub-major concat of the raw object tokens
            pair_raw = torch.cat([object_embeds[:, :, None].expand(B, N, N, D0),
                                  object_embeds[:, None, :].expand(B, N, N, D0)],
                                 dim=-1).reshape(B, N * N, 2 * D0)

        def pair_scores(h, cls):  # [B, N², R] sub-major → [B, R, N, N]
            return cls(h).reshape(B, N, N, R).permute(0, 3, 1, 2).float()

        if "object_vision_only" in experts:
            x = self.fc_ovo_input(object_embeds)
            x = self.object_encoder(input_embeds=x, attention_mask=attention_mask,
                                    position_ids=0)
            x = self.fc_ovo_output(x)
            q = self.ovo_sub(x).reshape(B, N, R, D)
            k = self.ovo_obj(x).reshape(B, N, R, D)
            out["object_vision_only"] = mm_f32(q, k, "bsrc,borc->brso")
        if "pair_vision_only" in experts:
            h = self.pair_encoder(input_embeds=self.fc_pvo_input(pair_raw), attention_mask=pm,
                                  position_ids=0)
            out["pair_vision_only"] = pair_scores(self.fc_pvo_output(h), self.pvo_cls)
        if "pair_text2vision" in experts:
            t = self.fc_pt2v_text_input(pair_text_embeds.reshape(B, N * N, -1))
            v = self.fc_pt2v_vision_prompt(pair_raw)
            h = self.pair_encoder(input_embeds=t, attention_mask=pm, encoder_hidden=v,
                                  encoder_mask=pm, position_ids=0)
            out["pair_text2vision"] = pair_scores(self.fc_pt2v_output(h), self.pt2v_cls)
        if "pair_vision2text" in experts:
            v = self.fc_pv2t_vision_input(pair_raw)
            t = self.fc_pv2t_text_prompt(pair_text_embeds.reshape(B, N * N, -1))
            h = self.pair_encoder(input_embeds=v, attention_mask=pm, encoder_hidden=t,
                                  encoder_mask=pm, position_ids=0)
            out["pair_vision2text"] = pair_scores(self.fc_pv2t_output(h), self.pv2t_cls)
        if "triplet_text_w_vision" in experts:
            if triplet_text_embeds is None or triplet_text_embeds.ndim != 5:
                raise ValueError("the triplet expert needs per-relation text [B, N, N, R, T]")
            v = self.fc_ttwv_vision_input(pair_raw)
            t = self.fc_ttwv_text_prompt(triplet_text_embeds.reshape(B, N * N, R, -1))
            vr = v[:, None].expand(B, R, N * N, D).reshape(B * R, N * N, D)
            tr = t.permute(0, 2, 1, 3).reshape(B * R, N * N, D)
            pmr = pm[:, None].expand(B, R, N * N).reshape(B * R, N * N)
            h = self.pair_encoder(input_embeds=vr, attention_mask=pmr, encoder_hidden=tr,
                                  encoder_mask=pmr, position_ids=0)
            h = self.fc_ttwv_output(h).reshape(B, R, N * N, D)
            s = mm_f32(h, self.ttwv_cls_w.to(h.dtype), "brpd,rd->brp")
            out["triplet_text_w_vision"] = (s + self.ttwv_cls_b.float()[None, :, None]
                                            ).reshape(B, R, N, N)
        if c.use_moe_gate:
            mv = self.moe_input_pair_vision(pair_raw)
            mt = self.moe_input_pair_text(pair_text_embeds.reshape(B, N * N, -1))
            tt = triplet_text_embeds.reshape((B, N * N) + tuple(triplet_text_embeds.shape[3:]))
            mtr = self.moe_input_triplet_text(tt)
            if mtr.ndim == 4:          # [B, N², R, D] → mean over relations
                mtr = mtr.mean(dim=2)
            g = torch.relu(self.moe_fc1(mv + mt + mtr))
            g = torch.relu(self.moe_fc2(g))
            maps = torch.stack([out[k] for k in EXPERT_ORDER if k in out], dim=1)
            E = maps.shape[1]
            g = self.moe_out(g).float()
            if c.moe_weight_type == "v1":
                wgt = torch.softmax(g, dim=-1).permute(0, 2, 1).reshape(B, E, 1, N, N)
            else:
                wgt = torch.softmax(g.reshape(B, N * N, R, E), dim=-1)
                wgt = wgt.permute(0, 3, 2, 1).reshape(B, E, R, N, N)
            out["moe"] = (maps * wgt).sum(dim=1)
        return out

    @staticmethod
    def primary(out: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The map inference uses: the last enabled expert in cascade
        order; moe over all."""
        sel = None
        for k in EXPERT_ORDER + ("moe",):
            if k in out:
                sel = out[k]
        if sel is None:
            raise ValueError("no expert output")
        return sel
