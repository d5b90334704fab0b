"""Read ``tools.predict`` output back as named triplets (counterpart of
``tools/parse_predict.py``).

    python -m openpsg_tpu_torch.tools.parse_predict --predictions P --panseg-dir D
        [--interactive]

Each record's panoptic PNG is read with the port's PNG reader and turned
into segment masks by rgb2id; each 1-indexed relation becomes
(subject name, relation name, object name, subject mask, object mask,
score).  Relations that name a segment the record does not have are
skipped.
"""

from __future__ import annotations

import argparse
import json
import os

from openpsg_tpu_torch.data.vocab import OBJECT_CLASSES, RELATION_CLASSES
from openpsg_tpu_torch.utils.image_io import read_png
from openpsg_tpu_torch.utils.panoptic import rgb2id


def parse_record(record, panseg_dir):
    """One prediction record → list of named triplet dicts."""
    seg_id_map = rgb2id(read_png(os.path.join(panseg_dir, record["pan_seg_file_name"])))

    seg_masks, seg_names = [], []
    for seg in record["segments_info"]:
        seg_masks.append(seg_id_map == seg["id"])
        seg_names.append(OBJECT_CLASSES[int(seg["category_id"]) - 1])

    out = []
    scores = record.get("relation_scores", [1.0] * len(record["relations"]))
    for (s, o, r), score in zip(record["relations"], scores):
        if s >= len(seg_names) or o >= len(seg_names):
            continue
        out.append(dict(subject=seg_names[s], relation=RELATION_CLASSES[int(r) - 1],
                        object=seg_names[o], sub_mask=seg_masks[s], obj_mask=seg_masks[o],
                        score=float(score)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m openpsg_tpu_torch.tools.parse_predict")
    ap.add_argument("--predictions", required=True)
    ap.add_argument("--panseg-dir", required=True)
    ap.add_argument("--interactive", action="store_true")
    args = ap.parse_args(argv)

    with open(args.predictions, "r", encoding="utf-8") as f:
        records = json.load(f)
    for rec in records:
        triplets = parse_record(rec, args.panseg_dir)
        print(f"== {rec.get('file_name', rec['pan_seg_file_name'])}: {len(triplets)} triplets")
        for t in triplets:
            print(f"  {t['subject']} --{t['relation']}--> {t['object']} ({t['score']:.3f})")
            if args.interactive:
                input()


if __name__ == "__main__":
    main()
