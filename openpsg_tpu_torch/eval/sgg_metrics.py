"""Scene-graph recall metrics (R@K / mR@K) over submission files.

The reference grades externally with the HiLo repo's ``tools/grade.py``
(README.md:34-40).  Self-contained equivalent so the framework can score
its own submissions: a predicted triplet (sub, obj, rel) matches a GT
triplet iff the predicates agree and both the subject and object masks
overlap their GT counterparts with IoU > 0.5 (standard PSG protocol).

  * R@K  — mean over images of (matched GT triplets in top-K) / (#GT)
  * mR@K — same but averaged per predicate class first (mean recall)

Inputs mirror what tools/infer.py writes + the GT json: per image, the
predicted panoptic id map + 0-indexed triplets over its object list, and
the GT map + triplets over its segments_info order.

A copy of ``openpsg_tpu/eval/sgg_metrics.py``; the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from openpsg_tpu_torch.data.vocab import NUM_RELATION_CLASSES


def _mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / float(union) if union else 0.0


def sgg_recall(
    images: Sequence[dict],
    ks: Sequence[int] = (20, 50, 100),
    iou_thr: float = 0.5,
    num_predicates: int = NUM_RELATION_CLASSES,
    per_predicate: bool = False,
) -> Dict[str, float]:
    """images: list of dicts with keys
        pred_masks  [Np, H, W] bool — predicted object masks (list order =
                    triplet subject/object indices)
        pred_triplets [[s, o, r], ...] ranked best-first (0-indexed rel)
        gt_masks    [Ng, H, W] bool
        gt_triplets [[s, o, r], ...]
        pred_labels [Np] int (optional) — object category per pred mask
        gt_labels   [Ng] int (optional)
    → {"R@20": ..., "mR@20": ..., ...}

    The standard PSG protocol requires the predicted subject/object
    *categories* to match GT in addition to mask IoU > 0.5; label checks
    are enforced whenever both label lists are provided (grading without
    them inflates recall — wrong-class masks with good overlap count).
    """
    per_k_hits = {k: [] for k in ks}
    per_k_cls_hits = {k: np.zeros(num_predicates) for k in ks}
    per_k_cls_total = {k: np.zeros(num_predicates) for k in ks}

    for im in images:
        gt = [tuple(t) for t in im["gt_triplets"]]
        if not gt:
            continue
        pred = [tuple(t) for t in im["pred_triplets"]]
        pm, gm = im["pred_masks"], im["gt_masks"]
        pl, gl = im.get("pred_labels"), im.get("gt_labels")

        # precompute IoU between every pred and gt object; entity match =
        # IoU > thr AND (when labels are given) same category
        iou = np.zeros((len(pm), len(gm)))
        for i in range(len(pm)):
            for j in range(len(gm)):
                iou[i, j] = _mask_iou(pm[i], gm[j])
        ent = iou > iou_thr
        if pl is not None and gl is not None:
            ent &= np.asarray(pl)[:, None] == np.asarray(gl)[None, :]

        for k in ks:
            matched = set()
            for (ps, po, pr) in pred[:k]:
                if ps >= len(pm) or po >= len(pm):
                    continue
                for gi, (gs, go, gr) in enumerate(gt):
                    if gi in matched or pr != gr:
                        continue
                    if ent[ps, gs] and ent[po, go]:
                        matched.add(gi)
                        break
            per_k_hits[k].append(len(matched) / len(gt))
            for gi, (gs, go, gr) in enumerate(gt):
                per_k_cls_total[k][gr] += 1
                if gi in matched:
                    per_k_cls_hits[k][gr] += 1

    out: Dict[str, float] = {}
    for k in ks:
        out[f"R@{k}"] = float(np.mean(per_k_hits[k]) * 100) if per_k_hits[k] else 0.0
        tot = per_k_cls_total[k]
        with np.errstate(divide="ignore", invalid="ignore"):
            per_cls = np.where(tot > 0, per_k_cls_hits[k] / tot, np.nan)
        out[f"mR@{k}"] = (
            float(np.nanmean(per_cls) * 100) if np.isfinite(per_cls).any() else 0.0
        )
        if per_predicate:
            # recall per predicate id, only ids present in GT (mR@K is
            # their mean) — lets callers read e.g. a HELD-OUT predicate's
            # zero-shot recall from the standard grading path
            out[f"perR@{k}"] = {
                int(r): float(per_cls[r] * 100)
                for r in np.nonzero(tot > 0)[0]
            }
    return out
