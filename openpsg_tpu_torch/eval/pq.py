"""Panoptic Quality (PQ/SQ/RQ) evaluation.

The reference configures ``evaluation = dict(metric=['PQ'])``
(configs/psg/baseline_v4_ov.py:172) but delegates the computation to
mmdet/panopticapi.  Self-contained numpy implementation of the standard
metric (Kirillov et al., arXiv 1801.00868): segments match iff
IoU > 0.5 (which makes matching unique); per class,

    PQ = Σ_{TP} IoU / (|TP| + |FP|/2 + |FN|/2),  SQ = Σ IoU/|TP|,  RQ = ...

Inputs are mmdet-scheme id maps (category + INSTANCE_OFFSET·instance,
void = VOID_ID) — the format every segmenter in this framework emits.

A copy of ``openpsg_tpu/eval/pq.py``; the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from openpsg_tpu_torch.data.vocab import INSTANCE_OFFSET, NUM_OBJECT_CLASSES

VOID = NUM_OBJECT_CLASSES  # 133


def _segments(idmap: np.ndarray) -> Dict[int, int]:
    ids, counts = np.unique(idmap, return_counts=True)
    return {int(i): int(c) for i, c in zip(ids, counts) if i != VOID}


def panoptic_quality(
    pairs: Iterable[Tuple[np.ndarray, np.ndarray]],
    num_classes: int = NUM_OBJECT_CLASSES,
) -> Dict[str, float]:
    """pairs: iterable of (pred_idmap, gt_idmap) per image → PQ/SQ/RQ
    overall and per-class arrays."""
    iou_sum = np.zeros(num_classes)
    tp = np.zeros(num_classes, np.int64)
    fp = np.zeros(num_classes, np.int64)
    fn = np.zeros(num_classes, np.int64)

    for pred, gt in pairs:
        pred = np.asarray(pred)
        gt = np.asarray(gt)
        pred_seg = _segments(pred)
        gt_seg = _segments(gt)

        # joint histogram over (gt_id, pred_id) via a packed 64-bit key
        both = (gt.astype(np.int64) << 32) | (pred.astype(np.int64) & 0xFFFFFFFF)
        keys, counts = np.unique(both, return_counts=True)
        inter: Dict[Tuple[int, int], int] = {}
        for k, c in zip(keys, counts):
            g = int(k >> 32)
            p = int(np.int32(k & 0xFFFFFFFF))
            inter[(g, p)] = int(c)

        # per-pred intersection with the GT void region (panopticapi: void
        # overlap is excluded from the match union, and unmatched preds
        # mostly covered by void are not counted as FP)
        pred_void = {
            p: c for (g, p), c in inter.items() if g == VOID and p != VOID
        }

        matched_gt, matched_pred = set(), set()
        for (g, p), c in inter.items():
            if g == VOID or p == VOID:
                continue
            if g % INSTANCE_OFFSET != p % INSTANCE_OFFSET:
                continue  # classes must match
            union = gt_seg[g] + pred_seg[p] - c - pred_void.get(p, 0)
            iou = c / union
            if iou > 0.5:
                cls = g % INSTANCE_OFFSET
                iou_sum[cls] += iou
                tp[cls] += 1
                matched_gt.add(g)
                matched_pred.add(p)
        for g in gt_seg:
            if g not in matched_gt:
                fn[g % INSTANCE_OFFSET] += 1
        for p in pred_seg:
            if p not in matched_pred:
                if pred_void.get(p, 0) / pred_seg[p] > 0.5:
                    continue  # mostly void-covered: ignored, not an FP
                fp[p % INSTANCE_OFFSET] += 1

    denom = tp + fp / 2.0 + fn / 2.0
    with np.errstate(divide="ignore", invalid="ignore"):
        pq_cls = np.where(denom > 0, iou_sum / denom, np.nan)
        sq_cls = np.where(tp > 0, iou_sum / np.maximum(tp, 1), np.nan)
        rq_cls = np.where(denom > 0, tp / denom, np.nan)
    present = ~np.isnan(pq_cls)

    def _mean(arr):
        return float(np.nanmean(arr)) * 100 if np.isfinite(arr).any() else 0.0

    return {
        "PQ": _mean(pq_cls) if present.any() else 0.0,
        "SQ": _mean(sq_cls),
        "RQ": _mean(rq_cls) if present.any() else 0.0,
        "per_class_pq": pq_cls * 100,
        "n_classes_present": int(present.sum()),
    }
