"""Grade a submission against PSG ground truth: R@K / mR@K (counterpart of
``tools/grade.py``).

    python -m openpsg_tpu_torch.tools.grade --submission DIR --gt-json J --data-dir D

Reads ``submission/panseg/*.png`` and ``submission/relation.json`` as the
infer tool writes them, rebuilds each image's predicted masks and
triplets, and scores them against the GT panoptic PNGs and relations with
the PSG protocol (mask IoU > 0.5, subject/object category match, exact
predicate).  PNGs are read by :func:`load_image_rgb` (cv2 where it can be
imported, else the port's PNG reader).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from openpsg_tpu_torch.data.preprocess import resize_nearest
from openpsg_tpu_torch.eval.sgg_metrics import sgg_recall
from openpsg_tpu_torch.utils.image_io import load_image_rgb
from openpsg_tpu_torch.utils.panoptic import rgb2id
from openpsg_tpu_torch.utils.submission import submission_records


def load_submission_image(sub_dir, rec):
    ids = rgb2id(load_image_rgb(os.path.join(sub_dir, "panseg", rec["pan_seg_file_name"])))
    masks = [ids == seg["id"] for seg in rec["segments_info"]]
    # submission category_id and predicates are 1-indexed → back to 0-indexed
    labels = [seg["category_id"] - 1 for seg in rec["segments_info"]]
    triplets = [[s, o, r - 1] for s, o, r in rec["relations"]]
    return masks, labels, triplets


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m openpsg_tpu_torch.tools.grade")
    ap.add_argument("--submission", required=True, help="dir containing submission/")
    ap.add_argument("--gt-json", required=True)
    ap.add_argument("--data-dir", required=True, help="root for GT panoptic PNGs")
    ap.add_argument("--ks", type=int, nargs="+", default=[20, 50, 100])
    ap.add_argument("--per-predicate", action="store_true",
                    help="also report recall per predicate id (the mR@K components)")
    args = ap.parse_args(argv)

    sub_dir = os.path.join(args.submission, "submission")
    with open(os.path.join(sub_dir, "relation.json"), "r", encoding="utf-8") as f:
        submission = json.load(f)
    with open(args.gt_json, "r", encoding="utf-8") as f:
        records = submission_records(json.load(f))
    assert len(submission) == len(records), (
        f"submission has {len(submission)} records, GT {len(records)}")

    images = []
    for rec, gt_rec in zip(submission, records):
        pred_masks, pred_labels, pred_triplets = load_submission_image(sub_dir, rec)
        gt_ids = rgb2id(load_image_rgb(os.path.join(args.data_dir, gt_rec["pan_seg_file_name"])))
        if pred_masks and pred_masks[0].shape != gt_ids.shape:
            pred_masks = [resize_nearest(m, gt_ids.shape) for m in pred_masks]
        images.append({
            "pred_masks": pred_masks,
            "pred_labels": pred_labels,
            "pred_triplets": pred_triplets,
            "gt_masks": [gt_ids == seg["id"] for seg in gt_rec["segments_info"]],
            "gt_labels": [seg["category_id"] for seg in gt_rec["segments_info"]],
            "gt_triplets": [list(t) for t in gt_rec["relations"]],
        })

    res = sgg_recall(images, ks=tuple(args.ks), per_predicate=args.per_predicate)
    print(json.dumps({k: (v if isinstance(v, dict) else round(v, 2)) for k, v in res.items()}))
    return res


if __name__ == "__main__":
    main()
