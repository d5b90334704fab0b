"""Inference visualization: panoptic overlay + triplet table (counterpart
of ``openpsg_tpu/utils/visualize.py``).

The reference's ``use_vis`` path (tools/infer.py:191-253): blend a
per-object colored segmentation over the image, draw thick segment
boundaries, label each object at its mask centroid with ``{idx}_{name}``,
write ``{stem}_pan_seg.jpg``, and print the top-20 predicted triplets as a
text table.  cv2-only (the reference additionally pulls seaborn for the
palette and skimage for boundaries — both replaced with self-contained
equivalents: a seeded HSV palette and a 4-neighbor difference).
:func:`triplet_table` needs no cv2; :func:`vis` imports it when called."""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from openpsg_tpu_torch.data.vocab import INSTANCE_OFFSET, clean_name


def find_boundaries(idmap: np.ndarray) -> np.ndarray:
    """'thick'-mode boundaries: a pixel whose 4-neighborhood crosses a
    segment edge (skimage.segmentation.find_boundaries equivalent)."""
    b = np.zeros(idmap.shape, bool)
    b[:-1] |= idmap[:-1] != idmap[1:]
    b[1:] |= idmap[1:] != idmap[:-1]
    b[:, :-1] |= idmap[:, :-1] != idmap[:, 1:]
    b[:, 1:] |= idmap[:, 1:] != idmap[:, :-1]
    return b


def make_palette(n: int, seed: int = 0) -> np.ndarray:
    """[n, 3] float colors in [0, 1] (stands in for seaborn color_palette)."""
    rng = np.random.default_rng(seed)
    import colorsys

    hues = (np.arange(n) / max(n, 1) + rng.uniform(0, 1)) % 1.0
    return np.asarray(
        [colorsys.hsv_to_rgb(h, 0.75, 0.95) for h in hues], np.float64
    )


def triplet_table(
    relations: Sequence[Sequence[int]],
    object_labels: Sequence[int],
    object_classes: Sequence[str],
    predicate_classes: Sequence[str],
    topk: int = 20,
) -> str:
    """Reference's PrettyTable of (subject, relation, object) rows
    (tools/infer.py:243-252), plain-text."""
    rows = [("subject", "relation", "object")]
    for sub_id, obj_id, rel_label in list(relations)[:topk]:
        rows.append((
            f"{sub_id}_{object_classes[object_labels[sub_id]]}",
            predicate_classes[rel_label],
            f"{obj_id}_{object_classes[object_labels[obj_id]]}",
        ))
    widths = [max(len(r[c]) for r in rows) for c in range(3)]
    sep = "+-" + "-+-".join("-" * w for w in widths) + "-+"
    out = [sep]
    for i, r in enumerate(rows):
        out.append("| " + " | ".join(x.ljust(w) for x, w in zip(r, widths)) + " |")
        if i == 0:
            out.append(sep)
    out.append(sep)
    return "\n".join(out)


def vis(
    image_rgb: np.ndarray,
    pan_seg: np.ndarray,
    object_id_list: Sequence[int],
    relations: Sequence[Sequence[int]],
    object_classes: Sequence[str],
    predicate_classes: Sequence[str],
    output_path: str,
    file_name: str,
    palette: Optional[np.ndarray] = None,
    topk: int = 20,
) -> Tuple[str, str]:
    """→ (written overlay path, triplet table string)."""
    import cv2

    os.makedirs(output_path, exist_ok=True)
    if palette is None:
        palette = make_palette(len(object_classes))
    seg_id = np.asarray(pan_seg)
    if seg_id.shape != image_rgb.shape[:2]:
        seg_id = cv2.resize(
            seg_id.astype(np.float64),
            (image_rgb.shape[1], image_rgb.shape[0]),
            interpolation=cv2.INTER_NEAREST,
        ).astype(np.int64)

    object_labels = [int(x) % INSTANCE_OFFSET for x in object_id_list]
    new_seg = image_rgb.copy()
    annotations: List[Tuple[Tuple[int, int], str, List[int]]] = []
    for idx, oid in enumerate(object_id_list):
        ys, xs = np.where(seg_id == oid)
        if not len(ys):
            continue
        label = object_labels[idx]
        color = [int(c * 255) for c in palette[label]]
        new_seg[ys, xs] = color
        pos = (int(xs.mean()), int(ys.mean()))
        annotations.append((pos, f"{idx}_{clean_name(object_classes[label])}", color))

    overlay = (image_rgb * 0.5 + new_seg * 0.5).astype(np.uint8)
    overlay[find_boundaries(seg_id)] = [64, 64, 64]

    for pos, name, color in annotations:
        (tw, th), _ = cv2.getTextSize(name, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        cv2.circle(overlay, pos, 3, color, -1, cv2.LINE_AA)
        cv2.rectangle(
            overlay, pos, (pos[0] + tw, pos[1] + th + 2),
            [255 - c for c in color], -1,
        )
        cv2.putText(
            overlay, name, (pos[0], pos[1] + th),
            cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1,
        )

    stem = os.path.splitext(os.path.basename(file_name))[0]
    out_file = os.path.join(output_path, f"{stem}_pan_seg.jpg")
    cv2.imwrite(out_file, overlay[..., ::-1])

    table = triplet_table(
        relations, object_labels, object_classes, predicate_classes, topk
    )
    return out_file, table
