"""Relation head v3: a truncated Llama as relation encoder, closed or open
vocabulary (counterpart of ``openpsg_tpu/models/relation/head_v3.py``;
reference kings_sgg/models/relation_heads/relation_transformer_head_v3.py).

Closed vocabulary: ``fc_input`` (Linear + LayerNorm) lifts the object
tokens to the Llama width, the first ``shave_language_decoder_at`` blocks
run (causal or not, ``llm.causal``), ``fc_output`` projects down and two
per-relation projections give sub/obj embeddings scored by an unscaled dot
product.

Open vocabulary: the object tokens go through the "former" width
(``fc_in_former``, an optional bare BERT stack ``o_in_former``), up to the
Llama width, and are joined with the embedded predicate-name sequence
("<sep> rel₁ <sep> rel₂ …", the Llama's own ``tok_embed``).  The Llama runs
over the joint sequence; the object half flows back to the former width
(``o_out_former``) and out; the relation half is mean-pooled per predicate
span (a span includes its leading separator) and becomes a per-predicate
classifier weight [P] and bias [1]; ``fc_sub_pred`` / ``fc_obj_pred`` give
the pair features (concat [sub; obj] or the product) that classifier
scores.

As the JAX version does, the head pools the relation segment of the Llama's
output (the reference's :229-233 indexes a 512-wide tensor with relation
token indices, which cannot run as written), keeps the batch dimension, and
masks pad keys in its padded layout.  The relation tokens' rotary positions
restart at each image's valid object count, as in the reference's compact
layout.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from openpsg_tpu_torch.models.common import mm_f32
from openpsg_tpu_torch.models.commons.text_encoder import (
    BertStyleConfig,
    BertStyleEncoder,
    DenseLN,
)
from openpsg_tpu_torch.models.llm.llama import Llama, LlamaConfig, LlamaWithEmbeddings


@dataclasses.dataclass(frozen=True)
class HeadV3Config:
    llm: LlamaConfig = LlamaConfig(n_layers=6, causal=True)
    input_feature_size: int = 256
    former_feature_size: int = 768
    output_feature_size: int = 512
    num_relation_classes: int = 56
    ov_relation: bool = False
    sub_obj_merge_type: str = "concat"  # concat | multiply
    num_object_in_layers: int = 0
    num_object_out_layers: int = 0
    num_relation_out_layers: int = 0
    former_heads: int = 12
    former_intermediate: int = 3072
    dtype: torch.dtype = torch.float32

    def former_cfg(self, num_layers: int) -> BertStyleConfig:
        return BertStyleConfig(hidden_size=self.former_feature_size, num_layers=num_layers,
                               num_heads=self.former_heads,
                               intermediate=self.former_intermediate, bare=True,
                               dtype=self.dtype)

    @property
    def relation_output_size(self) -> int:
        per_pair = (2 * self.output_feature_size if self.sub_obj_merge_type == "concat"
                    else self.output_feature_size)
        return per_pair + 1

    @staticmethod
    def tiny_test(**kw) -> "HeadV3Config":
        base = dict(llm=LlamaConfig.tiny_test(vocab_size=512).truncate(2),
                    input_feature_size=16, former_feature_size=32, output_feature_size=16,
                    former_heads=2, former_intermediate=64)
        base.update(kw)
        return HeadV3Config(**base)


def build_relation_token_layout(tokenizer, relation_names: List[str],
                                sep_id: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """→ (token_ids [L_rel] int32, span matrix [R, L_rel] float32) for
    "<sep> rel₁ <sep> rel₂ …" (separator: the tokenizer's EOS); each span
    runs from its separator up to the next one, rows normalized for a
    mean."""
    sep = tokenizer.eos_id if sep_id is None else sep_id
    ids: List[int] = []
    starts: List[int] = []
    for name in relation_names:
        starts.append(len(ids))
        ids.append(sep)
        ids.extend(tokenizer.encode(name))
    L = len(ids)
    span = np.zeros((len(relation_names), L), np.float32)
    bounds = starts + [L]
    for r in range(len(relation_names)):
        a, b = bounds[r], bounds[r + 1]
        span[r, a:b] = 1.0 / (b - a)
    return np.asarray(ids, np.int32), span


class RelationHeadV3(nn.Module):
    def __init__(self, cfg: HeadV3Config, token_dim: Optional[int] = None):
        """``token_dim``: the object tokens' width (default
        ``input_feature_size``)."""
        super().__init__()
        c = self.cfg = cfg
        token_dim = token_dim or c.input_feature_size
        R, D = c.num_relation_classes, c.output_feature_size
        if c.sub_obj_merge_type not in ("concat", "multiply"):
            raise ValueError(f"sub_obj_merge_type must be concat|multiply, "
                             f"got {c.sub_obj_merge_type!r}")
        if not c.ov_relation:
            self.fc_input = DenseLN(token_dim, c.llm.dim)
            self.llama = Llama(c.llm, lm_head=False)
            self.fc_output = DenseLN(c.llm.dim, D)
            self.ovo_sub = nn.Linear(D, R * D)
            self.ovo_obj = nn.Linear(D, R * D)
            return
        F_ = c.former_feature_size
        self.fc_in_former = DenseLN(token_dim, F_)
        if c.num_object_in_layers > 0:
            self.o_in_former = BertStyleEncoder(c.former_cfg(c.num_object_in_layers),
                                                word_embeddings=False)
        self.fc_former_to_llm = DenseLN(F_, c.llm.dim)
        self.llama = LlamaWithEmbeddings(c.llm, lm_head=False)
        self.fc_llm_to_former = DenseLN(c.llm.dim, F_)
        if c.num_object_out_layers > 0:
            self.o_out_former = BertStyleEncoder(c.former_cfg(c.num_object_out_layers),
                                                 word_embeddings=False)
        self.fc_out_former = DenseLN(F_, D)
        self.fc_rel_llm_to_former = DenseLN(c.llm.dim, F_)
        if c.num_relation_out_layers > 0:
            self.r_out_former = BertStyleEncoder(c.former_cfg(c.num_relation_out_layers),
                                                 word_embeddings=False)
        self.fc_rel_out_former = DenseLN(F_, c.relation_output_size)
        self.fc_sub_pred = nn.Linear(D, D)
        self.fc_obj_pred = nn.Linear(D, D)

    def forward(self, object_embeds, attention_mask, relation_token_ids=None,
                relation_spans=None):
        """object_embeds [B, N, C]; attention_mask [B, N] bool; the open
        vocabulary takes relation_token_ids [L_rel] and relation_spans
        [R, L_rel] → [B, R, N, N] float32 scores."""
        c = self.cfg
        B, N, _ = object_embeds.shape
        R = c.num_relation_classes
        dev = object_embeds.device
        dt = c.dtype
        x_in = object_embeds.to(dt)
        if not c.ov_relation:
            x = self.fc_input(x_in)
            pos = torch.arange(N, device=dev)[None].expand(B, N)
            hidden, _ = self.llama(x, attention_mask, pos, return_hidden=True)
            h = self.fc_output(hidden)
            D = c.output_feature_size
            q = self.ovo_sub(h).reshape(B, N, R, D).permute(0, 2, 1, 3)
            k = self.ovo_obj(h).reshape(B, N, R, D).permute(0, 2, 1, 3)
            return mm_f32(q, k, "brnc,brmc->brnm")

        L = relation_token_ids.shape[0]
        x = self.fc_in_former(x_in)
        if c.num_object_in_layers > 0:
            x = self.o_in_former(input_embeds=x, attention_mask=attention_mask)
        x = self.fc_former_to_llm(x)
        rel_emb = self.llama.embed(relation_token_ids.long())[None].expand(B, L, c.llm.dim)
        joint = torch.cat([x.to(c.llm.dtype), rel_emb.to(c.llm.dtype)], dim=1)
        mask = torch.cat([attention_mask, torch.ones(B, L, dtype=torch.bool, device=dev)], 1)
        n_valid = attention_mask.sum(dim=-1)
        pos = torch.cat([torch.arange(N, device=dev)[None].expand(B, N),
                         n_valid[:, None] + torch.arange(L, device=dev)[None]], dim=1)
        hidden, _ = self.llama.core(joint, mask, pos, return_hidden=True)
        obj_h = self.fc_llm_to_former(hidden[:, :N].to(dt))
        if c.num_object_out_layers > 0:
            obj_h = self.o_out_former(input_embeds=obj_h, attention_mask=attention_mask)
        obj_h = self.fc_out_former(obj_h)
        rel_h = mm_f32(relation_spans, hidden[:, N:], "rl,bld->brd")
        rel_h = self.fc_rel_llm_to_former(rel_h.to(dt))
        if c.num_relation_out_layers > 0:
            rel_h = self.r_out_former(input_embeds=rel_h)
        rel_h = self.fc_rel_out_former(rel_h)
        w, b = rel_h[..., :-1], rel_h[..., -1]
        sub, obj = self.fc_sub_pred(obj_h), self.fc_obj_pred(obj_h)
        if c.sub_obj_merge_type == "concat":
            P = sub.shape[-1]
            pair = torch.cat([sub[:, :, None].expand(B, N, N, P),
                              obj[:, None, :].expand(B, N, N, P)], dim=-1)
        else:
            pair = sub[:, :, None, :] * obj[:, None, :, :]
        return mm_f32(pair, w, "bnmp,brp->brnm") + b.float()[:, :, None, None]
