"""Panoptic fusion with mmdet-scheme ids (counterpart of
``openpsg_tpu/models/segmenter/fusion.py``).

* :func:`panoptic_fusion`: the reference's 'raw' mode, sigmoid class
  scores (OpenSeeD) or a softmax with a void column (mmdet Mask2Former),
  and per-class (OpenSeeD remap) or global (mmdet fusion head) instance
  ids; :func:`extract_object_lists` reads its object list on the host.
* :func:`panoptic_fusion_area`: the reference's 'area' mode (kept queries
  painted largest first), as one argmin per pixel;
  :func:`extract_object_lists_area` reads its object list in paint order.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
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
    filter_low_score: bool = False,
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
    (mmdet's fusion head: one counter over surviving things, from 1).
    ``filter_low_score``: a query's segment keeps only the pixels where its
    own mask probability is at least 0.5 (the area filter still counts every
    pixel it won)."""
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
    write_mask = assigned & binary if filter_low_score else assigned
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

    pix_ok = survive[winner] & keep[winner] & write_mask.any(dim=0)
    pan_seg = torch.where(pix_ok, object_ids[winner],
                          torch.full_like(object_ids[winner], VOID_ID))

    seg_mask = write_mask & pix_ok[None]
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


def panoptic_fusion_area(
    cls_logits: torch.Tensor,    # [Q, K + 1]: softmax over the classes and void
    mask_logits: torch.Tensor,   # [Q, H, W]
    *,
    object_mask_thr: float = 0.8,
    num_things: int = NUM_THING_CLASSES,
    region_mask: Optional[torch.Tensor] = None,  # [H, W] bool
) -> Tuple[FusionResult, torch.Tensor]:
    """The reference's 'area' mode (maskformer_fusion_relation_head.py:37-63):
    kept queries are painted largest binary area first, so a smaller mask
    overwrites a larger one.  The query painted last over a pixel is the
    covering one with the smallest ``key = area * Q + index`` (equal areas
    paint the higher index first), so each pixel takes one argmin and
    nothing is painted in sequence.  Thing instance ids count from 1 in
    paint order; stuff takes its bare class id.  Every painted query stays
    listed, even when fully overpainted, and scores the mean of its own
    score-weighted probabilities over its own binary mask.

    → (FusionResult, paint_pos [Q] int32: each painted query's place in the
    paint order, Q for the others).  ``survive`` marks painted queries."""
    Q = cls_logits.shape[0]
    probs = torch.softmax(cls_logits.float(), dim=-1)
    scores = probs.max(dim=-1).values
    labels = probs.argmax(dim=-1).to(torch.int32)
    keep = (labels != probs.shape[-1] - 1) & (scores > object_mask_thr)
    labels = torch.clamp(labels, max=probs.shape[-1] - 2)

    mask_probs = torch.sigmoid(mask_logits.float())
    if region_mask is not None:
        mask_probs = torch.where(region_mask[None], mask_probs, torch.zeros_like(mask_probs))
    binary = mask_probs >= 0.5
    area = binary.sum(dim=(1, 2)).to(torch.int32)
    valid = keep & (area > 0)

    big = torch.iinfo(torch.int32).max
    key = area * Q + torch.arange(Q, dtype=torch.int32, device=area.device)
    cover_key = torch.where(valid[:, None, None] & binary, key[:, None, None],
                            torch.full_like(binary, big, dtype=torch.int32))
    best = cover_key.min(dim=0)
    winner, covered = best.indices, best.values < big

    is_thing = labels < num_things
    thing_key = torch.where(valid & is_thing, key, torch.full_like(key, -1))
    # 1 + the valid things painted earlier (a larger key)
    inst = 1 + ((thing_key[None, :] > key[:, None]) & (thing_key[None, :] >= 0)).sum(dim=1)
    object_ids = torch.where(is_thing, labels + INSTANCE_OFFSET * inst, labels).to(torch.int32)
    pan_seg = torch.where(covered, object_ids[winner],
                          torch.full_like(object_ids[winner], VOID_ID))

    weighted = scores[:, None, None] * mask_probs
    own_sum = torch.where(binary, weighted, torch.zeros_like(weighted)).sum(dim=(1, 2))
    query_scores = own_sum / torch.clamp(area, min=1)
    winner_score = torch.where(covered, torch.gather(weighted, 0, winner[None])[0],
                               torch.zeros_like(weighted[0]))
    paint_pos = torch.where(valid, ((key[None, :] > key[:, None]) & valid[None, :]).sum(dim=1),
                            torch.full_like(key, Q)).to(torch.int32)
    result = FusionResult(pan_seg=pan_seg.to(torch.int32), winner_score=winner_score,
                          object_ids=object_ids, survive=valid, query_scores=query_scores,
                          labels=labels)
    return result, paint_pos


def extract_object_lists_area(result: FusionResult, paint_pos) -> Tuple[List[int], List[float]]:
    """Host object lists of 'area' mode → (ids, scores) of the painted
    queries in paint order, overpainted ones included (the reference appends
    while it paints and never re-derives the list, :52-63)."""
    pos = np.asarray(_host(paint_pos))
    surv = np.asarray(_host(result.survive))
    oids = np.asarray(_host(result.object_ids))
    scores = np.asarray(_host(result.query_scores))
    order = [q for q in np.argsort(pos, kind="stable") if surv[q]]
    return [int(oids[q]) for q in order], [float(scores[q]) for q in order]


def extract_object_lists(result: FusionResult) -> Tuple[List[int], List[float]]:
    """Host object lists of 'raw' mode → (sorted unique ids, scores), as the
    reference takes ``torch.unique`` over the final map (:100-108): stuff
    queries of one class are one entry, scored by the first survivor."""
    oids = np.asarray(_host(result.object_ids))
    surv = np.asarray(_host(result.survive))
    scores = np.asarray(_host(result.query_scores))
    seen = {}
    for q in np.nonzero(surv)[0]:
        seen.setdefault(int(oids[q]), float(scores[q]))
    ordered = sorted(seen)
    return ordered, [seen[o] for o in ordered]


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
