"""Relation head v4: Q-Former + existence filter + LLM visual tokens
(counterpart of ``openpsg_tpu/models/relation/head_v4.py``), plus the
device-side helpers that assemble instructions and pick pairs."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from openpsg_tpu_torch.models.common import conv_hwc
from openpsg_tpu_torch.models.relation.qformer import QFormerConfig, RelationQFormer
from openpsg_tpu_torch.ops.mask_ops import downsample_mask_bilinear, pair_or_masks


@dataclasses.dataclass(frozen=True)
class HeadV4Config:
    qformer: QFormerConfig = QFormerConfig()
    patch_size: int = 16
    object_feature_size: int = 256
    num_relation_classes: int = 56
    max_object_num: int = 30
    max_objects_padded: int = 32
    rel_cls_type: str = "binary+multiclass"
    llm_feature_size: int = 4096
    sampled_qformer_batch_size: int = 32  # training: pairs through the Q-Former
    max_llm_forward_num: int = 4          # training: pairs through the LLM
    top_pairs: int = 20
    dtype: torch.dtype = torch.float32

    @property
    def max_pairs(self) -> int:
        return self.max_objects_padded ** 2

    @staticmethod
    def tiny_test() -> "HeadV4Config":
        return HeadV4Config(
            qformer=QFormerConfig.tiny_test(), patch_size=4,
            object_feature_size=16, max_object_num=6, max_objects_padded=8,
            llm_feature_size=32, top_pairs=4, sampled_qformer_batch_size=8,
        )


def topk_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of a 1-D tensor, ties to
    the lower index as ``jax.lax.top_k`` gives them."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def build_instruction_table(tokenizer, class_names, template: str, min_len: int):
    """Host-side, once: template prefix/infix/suffix ids and a
    [num_classes, name_tokens] name table (pad_id-padded); ``max_len`` is
    the static instruction width."""
    pad_id = getattr(tokenizer, "pad_id", 0)
    pre, rest = template.split("{}", 1)
    mid, post = rest.split("{}", 1)
    seg = lambda s: np.asarray(tokenizer.encode(s), np.int32).reshape(-1)
    name_ids = [tokenizer.encode(n) for n in class_names]
    name_tokens = max(max(len(e) for e in name_ids), 1)
    names = np.full((len(class_names), name_tokens), pad_id, np.int32)
    for i, ids in enumerate(name_ids):
        names[i, : len(ids)] = ids
    parts = {"pre": seg(pre), "mid": seg(mid), "post": seg(post), "names": names,
             "pad_id": pad_id}
    total = (len(parts["pre"]) + len(parts["mid"]) + len(parts["post"])
             + 2 * name_tokens)
    parts["max_len"] = max(min_len, total)
    return parts


def right_align(ids: torch.Tensor, mask: torch.Tensor):
    """Shift each row so its LAST real token sits in the last column (pads
    wrap to the front; token order kept)."""
    NP, L = ids.shape
    last_real = L - 1 - torch.argmax(mask.flip(1).to(torch.int32), dim=1)
    shift = (L - 1 - last_real)[:, None]
    cols = torch.arange(L, device=ids.device)[None, :]
    src = (cols - shift) % L
    return torch.gather(ids, 1, src), torch.gather(mask, 1, src)


def assemble_pair_instructions(parts, sub_labels: torch.Tensor, obj_labels: torch.Tensor):
    """[NP] class labels → ([NP, max_len] ids, [NP, max_len] mask):
    pre ⧺ name(sub) ⧺ mid ⧺ name(obj) ⧺ post, right-padded with pad_id."""
    dev = sub_labels.device
    NP = sub_labels.shape[0]
    pad_id = int(parts.get("pad_id", 0))
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long, device=dev)
    names = t(parts["names"])
    row = lambda a: t(a)[None].expand(NP, -1)
    ids = torch.cat([row(parts["pre"]), names[sub_labels.long()], row(parts["mid"]),
                     names[obj_labels.long()], row(parts["post"])], dim=1)
    pad = parts["max_len"] - ids.shape[1]
    ids = torch.nn.functional.pad(ids, (0, pad), value=pad_id)
    return ids, ids != pad_id


class RelationHeadV4(nn.Module):
    def __init__(self, cfg: HeadV4Config, mask_dim: int):
        super().__init__()
        c = self.cfg = cfg
        D = c.qformer.hidden_size
        self.patch_embed = nn.Conv2d(mask_dim, c.object_feature_size, c.patch_size,
                                     stride=c.patch_size)
        self.relation_query = nn.Parameter(torch.empty(c.qformer.num_relation_queries, D))
        self.rel_cls_query = nn.Parameter(torch.empty(1, D))
        self.qformer = RelationQFormer(c.qformer)
        if "binary" in c.rel_cls_type:
            self.binary_rel_cls = nn.Linear(D, 1)
        if "multiclass" in c.rel_cls_type:
            self.multiclass_rel_cls = nn.Linear(D, c.num_relation_classes)
        self.language_projection = nn.Linear(D, c.llm_feature_size)

    def init_extra(self, gen):
        self.relation_query.normal_(0.0, 1.0, generator=gen)
        self.rel_cls_query.normal_(0.0, 1.0, generator=gen)

    def forward(self, mask_features, object_masks, object_valid, text_ids, text_mask,
                pair_select=None, plain_attention: bool = False) -> Dict[str, torch.Tensor]:
        """mask_features [H4, W4, C]; object_masks [M, H4, W4] bool;
        object_valid [M]; text_ids/text_mask [M², T] (pair-major).
        ``pair_select`` [S] (training): only these pairs go through the
        Q-Former.  ``plain_attention`` forces the plain cross-attention
        (tests only)."""
        c = self.cfg
        M = object_masks.shape[0]
        patches = conv_hwc(self.patch_embed, mask_features)       # [hp, wp, C]
        hp, wp, _ = patches.shape
        patches = patches.reshape(hp * wp, c.object_feature_size)

        obj = downsample_mask_bilinear(object_masks, (hp, wp)) & object_valid[:, None, None]
        pmask = pair_or_masks(obj.reshape(M, hp * wp)).reshape(M * M, hp * wp)

        if pair_select is not None:
            sel = pair_select.long()
            pmask, text_ids, text_mask = pmask[sel], text_ids[sel], text_mask[sel]
        query = torch.cat([self.rel_cls_query, self.relation_query], dim=0)
        queries = query[None].expand(pmask.shape[0], -1, -1)
        qf_out = self.qformer(queries, text_ids, text_mask, patches, pmask,
                              plain_attention=plain_attention)
        out = {"qformer_out": qf_out, "pair_mask": pmask}
        cls_feat = qf_out[:, 0]
        if "binary" in c.rel_cls_type:
            out["binary_logits"] = self.binary_rel_cls(cls_feat)[:, 0].float()
        if "multiclass" in c.rel_cls_type:
            out["multiclass_logits"] = self.multiclass_rel_cls(cls_feat).float()
        out["llm_visual_tokens"] = self.language_projection(qf_out[:, 1:])
        return out


def select_topk_pairs(binary_logits, pair_valid, k: int):
    """Top-k pairs by binary existence score; invalid pairs get -inf."""
    scored = torch.where(pair_valid, binary_logits,
                         torch.full_like(binary_logits, float("-inf")))
    scores, idx = topk_stable(scored, k)
    return idx.to(torch.int32), torch.sigmoid(scores)


def multiclass_topk_triplets(multiclass_logits, pair_valid, n_obj_padded: int, k: int = 100):
    """Top-k (sub, obj, rel) triplets: sigmoid scores, self-pairs and
    invalid pairs zeroed, flattened pair-major [NP*R]."""
    NP, R = multiclass_logits.shape
    probs = torch.sigmoid(multiclass_logits)
    pair_idx = torch.arange(NP, device=probs.device)
    valid = pair_valid & (pair_idx // n_obj_padded != pair_idx % n_obj_padded)
    probs = torch.where(valid[:, None], probs, torch.zeros_like(probs))
    scores, idx = topk_stable(probs.reshape(-1), k)
    trip = torch.stack([(idx // R) // n_obj_padded, (idx // R) % n_obj_padded, idx % R], dim=1)
    return trip.to(torch.int32), scores
