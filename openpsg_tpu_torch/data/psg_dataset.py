"""PSG dataset: COCO-panoptic JSON plus per-image relation triplets (a copy
of ``openpsg_tpu/data/psg_dataset.py``).

Two JSON layouts are accepted:

* COCO-panoptic style: {images, annotations: [{image_id, file_name,
  segments_info, relations?}], categories}, relations on the annotation or
  in a top-level map keyed by image id;
* flat PSG style: {data: [{image_id, file_name, pan_seg_file_name,
  segments_info, relations}], test_image_ids, ...}; images in
  ``test_image_ids`` form the val/test split, the others the train split.

A relation ``[sub, obj, rel]`` indexes the image's ``segments_info``.  An
example is the static-shape array set a training batch takes
(:class:`openpsg_tpu_torch.train.trainer.TrainBatch`): the padded bucket
image, per-object masks on the stride-4 grid, labels, validity and the dense
[M, M, R] relation target.  All of it is host-side numpy.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from openpsg_tpu_torch.data.preprocess import Preprocessor
from openpsg_tpu_torch.data.vocab import NUM_RELATION_CLASSES
from openpsg_tpu_torch.utils.image_io import load_image_rgb
from openpsg_tpu_torch.utils.panoptic import extract_masks_downsampled, rgb2id


@dataclasses.dataclass
class PSGRecord:
    image_id: Any
    file_name: str
    pan_seg_file_name: Optional[str]
    segments_info: List[Dict[str, Any]]   # [{id, category, is_thing}]
    relations: List[List[int]]            # [[sub, obj, rel]]
    height: int = 0
    width: int = 0


class PSGDataset:
    def __init__(self, ann_file: str, img_prefix: str = "", seg_prefix: str = "",
                 split: str = "train", filter_no_relation: bool = False):
        self.img_prefix = img_prefix
        self.seg_prefix = seg_prefix
        with open(ann_file, "r", encoding="utf-8") as f:
            raw = json.load(f)
        self.records = self._parse(raw, split)
        if filter_no_relation:   # the infer tool keeps test images with a relation
            self.records = [r for r in self.records if len(r.relations) > 0]

    @staticmethod
    def _parse(raw: Dict[str, Any], split: str) -> List[PSGRecord]:
        records: List[PSGRecord] = []
        if "data" in raw:  # flat PSG style
            test_ids = set(raw.get("test_image_ids", []))
            for item in raw["data"]:
                in_test = item.get("image_id") in test_ids
                if split == "train" and in_test:
                    continue
                if split in ("val", "test") and not in_test:
                    continue
                segs = [{"id": s["id"], "category": s["category_id"],
                         "is_thing": bool(s.get("isthing", 1))}
                        for s in item.get("segments_info", [])]
                records.append(PSGRecord(
                    image_id=item.get("image_id"), file_name=item["file_name"],
                    pan_seg_file_name=item.get("pan_seg_file_name"), segments_info=segs,
                    relations=[list(r) for r in item.get("relations", [])],
                    height=item.get("height", 0), width=item.get("width", 0)))
        elif "annotations" in raw:  # COCO-panoptic style
            cats = sorted(raw.get("categories", []), key=lambda c: c["id"])
            cat2contig = {c["id"]: i for i, c in enumerate(cats)}
            isthing = {c["id"]: bool(c.get("isthing", 1)) for c in cats}
            img_by_id = {im["id"]: im for im in raw.get("images", [])}
            rel_map = raw.get("relations", {})
            for ann in raw["annotations"]:
                im = img_by_id.get(ann["image_id"], {})
                segs = [{"id": s["id"],
                         "category": cat2contig.get(s["category_id"], s["category_id"]),
                         "is_thing": isthing.get(s["category_id"], True)}
                        for s in ann.get("segments_info", [])]
                rels = ann.get("relations", rel_map.get(str(ann["image_id"]), []))
                records.append(PSGRecord(
                    image_id=ann["image_id"],
                    file_name=im.get("file_name", ann.get("file_name", "")),
                    pan_seg_file_name=ann.get("file_name"), segments_info=segs,
                    relations=[list(r) for r in rels],
                    height=im.get("height", 0), width=im.get("width", 0)))
        else:
            raise ValueError("unrecognized PSG annotation format")
        return records

    def __len__(self) -> int:
        return len(self.records)

    def load_example(self, idx: int, preproc: Preprocessor, max_objects: int,
                     flip_prob: float = 0.0, scale_jitter: Optional[tuple] = None,
                     rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        """One record → static-shape arrays: horizontal flip with
        ``flip_prob``; with ``scale_jitter=(lo, hi)`` the short side is drawn
        from [lo, hi] and clamped to the bucket's; masks of the first
        ``max_objects`` segments on the stride-4 grid of the valid region."""
        rec = self.records[idx]
        rng = rng or np.random.default_rng()
        image = load_image_rgb(os.path.join(self.img_prefix, rec.file_name))

        pan_id = None
        if rec.pan_seg_file_name:
            pan_id = rgb2id(load_image_rgb(os.path.join(self.seg_prefix, rec.pan_seg_file_name)))

        if flip_prob > 0 and rng.uniform() < flip_prob:
            image = image[:, ::-1].copy()
            if pan_id is not None:
                pan_id = pan_id[:, ::-1].copy()

        if scale_jitter is not None:
            lo, hi = scale_jitter
            short = int(rng.integers(lo, hi + 1))
            preproc = Preprocessor(scale=(preproc.scale[0], min(short, preproc.scale[1])),
                                   size_divisor=preproc.size_divisor)

        out = preproc(image)
        H, W = preproc.bucket_hw
        nh, nw = out["img_shape"]

        M = max_objects
        masks = np.zeros((M, H // 4, W // 4), bool)
        labels = np.zeros((M,), np.int32)
        valid = np.zeros((M,), bool)
        if pan_id is not None:
            segs = rec.segments_info[:M]
            oh, ow = max(nh // 4, 1), max(nw // 4, 1)
            small = extract_masks_downsampled(pan_id, [s["id"] for s in segs], (oh, ow))
            for i, seg in enumerate(segs):
                masks[i, :oh, :ow] = small[i].astype(bool)
                labels[i] = seg["category"]
                valid[i] = True

        R = NUM_RELATION_CLASSES
        target = np.zeros((M, M, R), np.float32)
        for s, o, r in rec.relations:
            if s < M and o < M and r < R:
                target[s, o, r] = 1.0

        return {
            "image": out["image"].astype(np.float32),
            "img_shape": np.asarray(out["img_shape"], np.int32),
            "ori_shape": np.asarray(out["ori_shape"], np.int32),
            "object_masks": masks,
            "object_labels": labels,
            "object_valid": valid,
            "relation_target": target,
            "image_id": rec.image_id,
        }

    def iter_train(self, preproc: Preprocessor, max_objects: int, batch_size: int,
                   seed: int = 0, flip_prob: float = 0.5, scale_jitter: Optional[tuple] = None,
                   epochs: int = 1) -> Iterator[List[Dict[str, np.ndarray]]]:
        """Shuffled batches of examples, one generator for the order, flips
        and jitter; a set smaller than the batch is tiled to one batch."""
        rng = np.random.default_rng(seed)
        for _ in range(epochs):
            order = rng.permutation(len(self.records))
            if len(order) < batch_size:
                order = np.tile(order, -(-batch_size // len(order)))[:batch_size]
            for i in range(0, len(order) - batch_size + 1, batch_size):
                yield [self.load_example(int(j), preproc, max_objects, flip_prob=flip_prob,
                                         scale_jitter=scale_jitter, rng=rng)
                       for j in order[i: i + batch_size]]
