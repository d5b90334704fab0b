"""Synthetic mini PSG datasets (copies of ``tests/fixtures.make_fixture``
and ``make_rich_fixture``): images, panoptic PNGs and a flat PSG json whose
known ground truth isolates the pipeline's stages from model quality.  For
the same arguments the files are byte-identical to the JAX package's test
fixtures; like them, they write through cv2 (JPEG images, PNG panoptic
maps), imported when called.
"""

from __future__ import annotations

import json
import os

import numpy as np

from openpsg_tpu_torch.utils.panoptic import id2rgb


def make_fixture(root: str, n_images: int = 4, hw=(96, 64), seed: int = 0, relations=None) -> str:
    """Write ``n_images`` images of three colour-coded regions plus noise,
    each with a GT panoptic PNG of three segments (person, dog, sky), into
    ``root/images`` and ``root/panoptic``, and ``root/psg.json`` (the last
    half of the images is the test split) → the json's path.

    ``hw``: one (H, W) for all images, or a list cycled per image.
    ``relations``: ``None`` gives every image ``[[0, 2, 4], [1, 0, 23]]``;
    a callable ``f(i) -> [[s, o, r], ...]`` gives image i its own."""
    import cv2

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images")
    pan_dir = os.path.join(root, "panoptic")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(pan_dir, exist_ok=True)

    hws = list(hw) if isinstance(hw, list) else [tuple(hw)]
    data = []
    # colour-coded regions (plus noise), so that a segmenter trained from
    # scratch learns appearance → class and generalizes to held-out images
    region_colors = np.asarray([[200, 60, 60], [60, 200, 60], [60, 60, 200]], np.int64)
    for i in range(n_images):
        H, W = hws[i % len(hws)]
        img = np.zeros((H, W, 3), np.int64)
        img[: H // 2, : W // 2] = region_colors[0]
        img[: H // 2, W // 2:] = region_colors[1]
        img[H // 2:, :] = region_colors[2]
        img = np.clip(img + rng.integers(-30, 30, (H, W, 3)), 0, 255).astype(np.uint8)
        cv2.imwrite(os.path.join(img_dir, f"{i}.jpg"), img[..., ::-1])

        # three segments: person (thing 0), dog (thing 16), sky (stuff 119)
        pan = np.zeros((H, W), np.int64)
        pan[: H // 2, : W // 2] = 7001
        pan[: H // 2, W // 2:] = 7002
        pan[H // 2:, :] = 7003
        cv2.imwrite(os.path.join(pan_dir, f"{i}.png"), id2rgb(pan)[..., ::-1])
        data.append({
            "image_id": str(i),
            "file_name": f"images/{i}.jpg",
            "pan_seg_file_name": f"panoptic/{i}.png",
            "height": H,
            "width": W,
            "segments_info": [
                {"id": 7001, "category_id": 0, "isthing": 1},
                {"id": 7002, "category_id": 16, "isthing": 1},
                {"id": 7003, "category_id": 119, "isthing": 0},
            ],
            "relations": ([[0, 2, 4], [1, 0, 23]]        # in (4), looking at (23)
                          if relations is None else [list(t) for t in relations(i)]),
        })
    payload = {"data": data, "test_image_ids": [str(i) for i in range(n_images // 2, n_images)]}
    path = os.path.join(root, "psg.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f)
    return path


# The rich fixture's vocabulary: 8 PSG thing classes with visually distinct
# fixed colours, and the first 12 PSG predicates, all spatial and mutually
# confusable (over, in front of, beside, on, in, attached to, ...).
RICH_CLASSES = [0, 2, 7, 16, 20, 25, 39, 56]
RICH_CLASS_COLORS = np.asarray(
    [[220, 40, 40], [40, 220, 40], [40, 40, 220], [220, 220, 40],
     [220, 40, 220], [40, 220, 220], [240, 140, 40], [140, 80, 200]],
    np.int64,
)
RICH_PREDICATES = list(range(12))


def rich_relations(classes, grid=(2, 4)):
    """The rich fixture's ground-truth rule: every grid-adjacent object pair
    gets a predicate that is a function of (subject class, object class,
    direction), learnable from appearance and layout but spread over 12
    confusable predicates → [[subject, object, predicate], ...]."""
    rows, cols = grid
    idx = {(r, c): r * cols + c for r in range(rows) for c in range(cols)}
    rels = []
    for r in range(rows):
        for c in range(cols):
            s = idx[(r, c)]
            if c + 1 < cols:   # horizontal: the subject is the left cell
                o = idx[(r, c + 1)]
                p = (classes[s] * 5 + classes[o]) % 6
                rels.append([s, o, RICH_PREDICATES[p]])
            if r + 1 < rows:   # vertical: the subject is the top cell
                o = idx[(r + 1, c)]
                p = 6 + (classes[s] * 5 + classes[o]) % 6
                rels.append([s, o, RICH_PREDICATES[p]])
    return rels


def make_rich_fixture(root: str, n_images: int = 16, hw=(64, 64), grid=(2, 4),
                      seed: int = 0) -> str:
    """A fixture on which a tiny model trained from scratch lands clearly
    below recall 100, so that quality costs become measurable: one object
    per ``grid`` cell (8 by default), the classes a seeded permutation of
    :data:`RICH_CLASSES` per image, relations from :func:`rich_relations`.
    Layout as :func:`make_fixture` (flat json, the last half of the images
    is the test split) → the json's path."""
    import cv2

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images")
    pan_dir = os.path.join(root, "panoptic")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(pan_dir, exist_ok=True)

    rows, cols = grid
    n_obj = rows * cols
    assert n_obj <= len(RICH_CLASSES)
    H, W = hw
    data = []
    for i in range(n_images):
        classes = rng.permutation(len(RICH_CLASSES))[:n_obj]
        img = np.zeros((H, W, 3), np.int64)
        pan = np.zeros((H, W), np.int64)
        segments_info = []
        for r in range(rows):
            for c in range(cols):
                k = r * cols + c
                ys, ye = H * r // rows, H * (r + 1) // rows
                xs, xe = W * c // cols, W * (c + 1) // cols
                img[ys:ye, xs:xe] = RICH_CLASS_COLORS[classes[k]]
                pan[ys:ye, xs:xe] = 9001 + k
                segments_info.append({"id": 9001 + k,
                                      "category_id": int(RICH_CLASSES[classes[k]]),
                                      "isthing": 1})
        img = np.clip(img + rng.integers(-25, 25, (H, W, 3)), 0, 255).astype(np.uint8)
        cv2.imwrite(os.path.join(img_dir, f"{i}.jpg"), img[..., ::-1])
        cv2.imwrite(os.path.join(pan_dir, f"{i}.png"), id2rgb(pan)[..., ::-1])
        data.append({
            "image_id": str(i),
            "file_name": f"images/{i}.jpg",
            "pan_seg_file_name": f"panoptic/{i}.png",
            "height": H,
            "width": W,
            "segments_info": segments_info,
            "relations": rich_relations(classes, grid),
        })
    payload = {"data": data, "test_image_ids": [str(i) for i in range(n_images // 2, n_images)]}
    path = os.path.join(root, "psg.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f)
    return path
