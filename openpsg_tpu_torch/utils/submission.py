"""HiLo submission writer (counterpart of ``openpsg_tpu/utils/submission.py``).

Emission rules (reference tools/infer.py:149-188):
  * one PNG per test image, ``{test_idx}.png`` under ``submission/panseg/``,
    each object painted a distinct random RGB, segment id = rgb2id(colour);
  * ``segments_info`` in object_id_list order with 1-indexed
    ``category_id = object_id % INSTANCE_OFFSET + 1``; id 133 (void) skipped;
  * ``relations = [[sub, obj, rel + 1], ...]`` (1-indexed predicates);
  * empty outputs dummy-filled: relation ``[[0, 0, 0]]``, one random segment;
  * ``submission/relation.json`` lists the images in ``test_idx`` order.

Colours come from a seeded RNG (``seed + test_idx``), drawn as the JAX
package draws them.  PNGs are 8-bit palette files written by
:mod:`openpsg_tpu_torch.utils.image_io`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from openpsg_tpu_torch.data.vocab import INSTANCE_OFFSET
from openpsg_tpu_torch.utils.image_io import encode_palette_png, write_png
from openpsg_tpu_torch.utils.panoptic import random_colors, rgb2id


def submission_records(dataset: dict) -> List[dict]:
    """The records a submission lists, in order: the PSG json's test
    images with ≥ 1 relation, in file order."""
    test_ids = set(dataset.get("test_image_ids", []))
    return [d for d in dataset["data"]
            if d["image_id"] in test_ids and len(d.get("relations", []))]


def paint_index(ids: np.ndarray, segment_ids: Sequence[int]) -> np.ndarray:
    """[h, w] id map + K segment ids → [h, w] uint8 palette indices (0 =
    background, s + 1 = segment s) in one vector pass: a stable sort of the
    ids, then ``searchsorted``."""
    seg = np.ascontiguousarray(segment_ids, np.int32)
    ids = np.ascontiguousarray(ids, np.int32)
    if len(seg) == 0:
        return np.zeros(ids.shape, np.uint8)
    order = np.argsort(seg, kind="stable")
    sorted_seg = seg[order]
    pos = np.minimum(np.searchsorted(sorted_seg, ids), len(seg) - 1)
    hit = sorted_seg[pos] == ids
    return np.where(hit, (order[pos] + 1).astype(np.int64), 0).astype(np.uint8)


def paint_panoptic_indexed(
    pan_results: np.ndarray, object_id_list: List[int], seed: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, List[Dict[str, Any]], List[int], np.ndarray]:
    """→ ``(idx, palette_rgb, segments_info, kept_oids, colors)``: ``idx``
    [H, W] uint8 (0 = background, black), ``palette_rgb`` [K + 1, 3];
    ``palette_rgb[idx]`` is the RGB image.  ``colors`` has ≥ 1 entry (the
    dummy fill of an empty image needs one)."""
    kept = [int(oid) for oid in object_id_list if oid != 133]
    colors = random_colors(max(len(kept), 1), seed=seed)
    idx = paint_index(pan_results, kept)
    palette = np.zeros((len(kept) + 1, 3), np.uint8)
    palette[1:] = colors[: len(kept)]
    segments_info = [
        dict(category_id=int(oid % INSTANCE_OFFSET) + 1, id=int(rgb2id(colors[i])))
        for i, oid in enumerate(kept)
    ]
    return idx, palette, segments_info, kept, colors


def paint_panoptic(
    pan_results: np.ndarray, object_id_list: List[int], seed: Optional[int] = None,
) -> Tuple[np.ndarray, List[Dict[str, Any]], List[int], np.ndarray]:
    """→ ``(out_bgr, segments_info, kept_oids, colors)``, the painted image
    in BGR order (the JAX package's surface, for cv2 writers)."""
    idx, palette, segments_info, kept, colors = paint_panoptic_indexed(
        pan_results, object_id_list, seed=seed)
    return palette[..., ::-1][idx], segments_info, kept, colors


def relations_1indexed(relation) -> List[List[int]]:
    """``[[sub, obj, rel + 1], ...]`` — submission predicates are 1-indexed."""
    return [[int(s), int(o), int(r) + 1] for s, o, r in relation]


class SubmissionWriter:
    def __init__(self, output_dir: str, seed: Optional[int] = None):
        self.panseg_dir = os.path.join(output_dir, "submission", "panseg")
        self.json_dir = os.path.join(output_dir, "submission")
        os.makedirs(self.panseg_dir, exist_ok=True)
        # (test_idx, record); finalize() sorts by test_idx, so images added
        # out of order (grouped by bucket) land in the grader's order
        self.results: List[Tuple[int, Dict[str, Any]]] = []
        self.seed = seed
        self._counter = 0

    def add(self, pan_results: np.ndarray, object_id_list: List[int],
            relation: List[List[int]], test_idx: Optional[int] = None) -> None:
        """pan_results [H, W] mmdet-scheme ids at the original size."""
        test_idx = self._counter if test_idx is None else test_idx
        self._counter += 1
        idx, palette, segments_info, _, colors = paint_panoptic_indexed(
            pan_results, object_id_list,
            seed=None if self.seed is None else self.seed + test_idx)
        write_png(os.path.join(self.panseg_dir, f"{test_idx}.png"),
                  encode_palette_png(idx, palette))
        if len(relation) == 0:
            relation = [[0, 0, 0]]
        if len(segments_info) == 0:
            segments_info = [dict(category_id=1, id=int(rgb2id(colors[0])))]
        self.results.append((test_idx, dict(
            relations=relations_1indexed(relation),
            segments_info=segments_info,
            pan_seg_file_name=f"{test_idx}.png",
        )))

    def finalize(self) -> str:
        path = os.path.join(self.json_dir, "relation.json")
        ordered = [r for _, r in sorted(self.results, key=lambda t: t[0])]
        with open(path, "w", encoding="utf-8") as f:
            json.dump(ordered, f, default=str)
        return path
