"""Panoptic Quality of a submission against GT panoptic PNGs (counterpart of
``tools/eval_pq.py``).

    python -m openpsg_tpu_torch.tools.eval_pq --submission DIR --gt-json J --data-dir D

PNGs are read by :func:`load_image_rgb` (cv2 where it can be imported,
else the port's PNG reader).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from openpsg_tpu_torch.data.preprocess import resize_nearest
from openpsg_tpu_torch.data.vocab import INSTANCE_OFFSET
from openpsg_tpu_torch.eval.pq import VOID, panoptic_quality
from openpsg_tpu_torch.utils.image_io import load_image_rgb
from openpsg_tpu_torch.utils.panoptic import rgb2id
from openpsg_tpu_torch.utils.submission import submission_records


def to_mmdet_scheme(ids: np.ndarray, segments_info, category_offset: int) -> np.ndarray:
    """RGB ids + segments_info → mmdet-scheme map (per-class instance
    counters in segments_info order); ``category_offset`` is 1 for a
    submission's 1-indexed categories, 0 for the GT's."""
    out = np.full(ids.shape, VOID, np.int64)
    counters = {}
    for seg in segments_info:
        c = int(seg["category_id"] if "category_id" in seg else seg["category"]) - category_offset
        k = counters.get(c, 0)
        counters[c] = k + 1
        out[ids == seg["id"]] = c + INSTANCE_OFFSET * k
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m openpsg_tpu_torch.tools.eval_pq")
    ap.add_argument("--submission", required=True)
    ap.add_argument("--gt-json", required=True)
    ap.add_argument("--data-dir", required=True)
    args = ap.parse_args(argv)

    sub_dir = os.path.join(args.submission, "submission")
    with open(os.path.join(sub_dir, "relation.json"), "r", encoding="utf-8") as f:
        submission = json.load(f)
    with open(args.gt_json, "r", encoding="utf-8") as f:
        records = submission_records(json.load(f))

    def pairs():
        for rec, gt_rec in zip(submission, records):
            png = load_image_rgb(os.path.join(sub_dir, "panseg", rec["pan_seg_file_name"]))
            pred = to_mmdet_scheme(rgb2id(png), rec["segments_info"], 1)
            gt_png = load_image_rgb(os.path.join(args.data_dir, gt_rec["pan_seg_file_name"]))
            gt_map = to_mmdet_scheme(rgb2id(gt_png), gt_rec["segments_info"], 0)
            if pred.shape != gt_map.shape:
                pred = resize_nearest(pred, gt_map.shape)
            yield pred, gt_map

    res = panoptic_quality(pairs())
    out = {k: round(float(v), 2) for k, v in res.items() if not k.startswith("per_class")}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
