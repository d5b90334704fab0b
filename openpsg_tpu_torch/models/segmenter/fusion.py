"""Panoptic fusion with mmdet-scheme ids (counterpart of ``panoptic_fusion``
in ``openpsg_tpu/models/segmenter/fusion.py:48-142``): sigmoid class scores
(OpenSeeD) or a softmax with a void column (mmdet Mask2Former), and
per-class (OpenSeeD remap) or global (mmdet fusion head) instance ids."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from openpsg_tpu_torch.data.vocab import (
    INSTANCE_OFFSET,
    NUM_OBJECT_CLASSES,
    NUM_THING_CLASSES,
)

VOID_ID = NUM_OBJECT_CLASSES  # 133


class FusionResult(NamedTuple):
    pan_seg: torch.Tensor       # [H, W] int32 ids, void = 133
    winner_score: torch.Tensor  # [H, W] f32
    object_ids: torch.Tensor    # [Q] int32
    survive: torch.Tensor       # [Q] bool
    query_scores: torch.Tensor  # [Q] f32
    labels: torch.Tensor        # [Q] int32


def panoptic_fusion(
    cls_logits: torch.Tensor,    # [Q, K], or [Q, K + 1] with softmax_void
    mask_logits: torch.Tensor,   # [Q, H, W]
    *,
    cls_mode: str = "sigmoid",
    object_mask_thr: float = 0.25,
    iou_thr: float = 0.8,
    instance_mode: str = "per_class",
    num_things: int = NUM_THING_CLASSES,
    region_mask: Optional[torch.Tensor] = None,  # [H, W] bool
) -> FusionResult:
    """Greedy score-weighted per-pixel winner and area/``iou_thr`` filter.

    ``cls_mode``: ``"sigmoid"`` (per-class sigmoid scores) or
    ``"softmax_void"`` (softmax over the classes and a last void column; a
    query whose best class is void is dropped).  ``instance_mode``:
    ``"per_class"`` (OpenSeeD's remap: things count from 0 per class in
    query order; stuff of one class shares id = class) or ``"global"``
    (mmdet's fusion head: one counter over surviving things, from 1)."""
    Q = cls_logits.shape[0]
    logits32 = cls_logits.float()
    if cls_mode == "softmax_void":
        probs = torch.softmax(logits32, dim=-1)
        scores = probs.max(dim=-1).values
        labels = probs.argmax(dim=-1).to(torch.int32)   # first index on ties
        keep = (labels != probs.shape[-1] - 1) & (scores > object_mask_thr)
        labels = torch.clamp(labels, max=probs.shape[-1] - 2)   # clamp the void label
    elif cls_mode == "sigmoid":
        probs = torch.sigmoid(logits32)
        scores = probs.max(dim=-1).values
        labels = probs.argmax(dim=-1).to(torch.int32)
        keep = scores > object_mask_thr
    else:
        raise ValueError(cls_mode)
    K = cls_logits.shape[-1]

    mask_probs = torch.sigmoid(mask_logits.float())
    if region_mask is not None:
        mask_probs = torch.where(region_mask[None], mask_probs, torch.zeros_like(mask_probs))
    weighted = scores[:, None, None] * mask_probs
    weighted = torch.where(keep[:, None, None], weighted, torch.full_like(weighted, -1.0))
    winner = weighted.argmax(dim=0)
    winner_score = weighted.max(dim=0).values
    winner_score = torch.where(keep.any(), winner_score, torch.zeros_like(winner_score))

    qidx = torch.arange(Q, device=winner.device)
    assigned = (winner[None] == qidx[:, None, None]) & keep[:, None, None]
    if region_mask is not None:
        assigned = assigned & region_mask[None]
    binary = mask_probs >= 0.5
    mask_area = assigned.sum(dim=(1, 2))
    orig_area = binary.sum(dim=(1, 2))
    ratio_ok = mask_area >= iou_thr * orig_area
    survive = keep & (mask_area > 0) & (orig_area > 0) & ratio_ok

    is_thing = labels < num_things
    if instance_mode == "global":
        counted = (survive & is_thing).to(torch.int32)
        inst = torch.cumsum(counted, dim=0) * counted
    elif instance_mode == "per_class":
        onehot = F.one_hot(labels.long(), K).to(torch.int32)
        counted = onehot * (survive & is_thing)[:, None].to(torch.int32)
        occ = torch.cumsum(counted, dim=0) - counted         # exclusive
        inst = torch.gather(occ, 1, labels.long()[:, None])[:, 0]
    else:
        raise ValueError(instance_mode)
    object_ids = torch.where(is_thing, labels + INSTANCE_OFFSET * inst, labels).to(torch.int32)

    pix_ok = survive[winner] & keep[winner] & assigned.any(dim=0)
    pan_seg = torch.where(pix_ok, object_ids[winner],
                          torch.full_like(object_ids[winner], VOID_ID))

    seg_mask = assigned & pix_ok[None]
    seg_area = seg_mask.sum(dim=(1, 2))
    seg_sum = torch.where(seg_mask, winner_score[None], torch.zeros_like(weighted)).sum(dim=(1, 2))
    query_scores = seg_sum / torch.clamp(seg_area, min=1)
    return FusionResult(
        pan_seg=pan_seg.to(torch.int32),
        winner_score=winner_score,
        object_ids=object_ids,
        survive=survive & (seg_area > 0),
        query_scores=query_scores,
        labels=labels,
    )
