"""A synthetic mini PSG dataset (a copy of ``tests/fixtures.make_fixture``):
images, panoptic PNGs and a flat PSG json whose known ground truth isolates
the pipeline's stages from model quality.  For the same arguments the files
are byte-identical to the JAX package's test fixture; like it, it writes
through cv2 (JPEG images, PNG panoptic maps), imported when called.
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
