"""Panoptic PNG id encoding (a copy of ``openpsg_tpu/utils/panoptic.py``),
and the training loader's mask extraction (the JAX package's
``native.extract_masks_downsampled``).

Submission PNGs encode segment ids in RGB: ``id = R + 256*G + 256²*B``
(panopticapi convention).  Colours per segment are drawn from a seedable
RNG, in the JAX package's draw order, so equal seeds give equal colours and
so equal segment ids in ``relation.json``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def rgb2id(color: np.ndarray) -> np.ndarray:
    """[..., 3] uint8 RGB → [...] int32 id."""
    color = color.astype(np.uint32)
    return (color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]).astype(np.int32)


def id2rgb(id_map: np.ndarray) -> np.ndarray:
    """[...] int id → [..., 3] uint8 RGB."""
    id_map = id_map.astype(np.uint32)
    rgb = np.zeros(id_map.shape + (3,), dtype=np.uint8)
    rgb[..., 0] = id_map % 256
    rgb[..., 1] = (id_map // 256) % 256
    rgb[..., 2] = (id_map // (256 * 256)) % 256
    return rgb


def random_colors(n: int, seed: Optional[int] = None, forbid_black: bool = True) -> np.ndarray:
    """n distinct random RGB colours, uint8 [n, 3]: one ``integers(0, 256,
    3)`` draw per attempt, repeats and (optionally) black skipped."""
    rng = np.random.default_rng(seed)
    seen = set()
    out = []
    while len(out) < n:
        c = tuple(int(x) for x in rng.integers(0, 256, size=3))
        if c in seen or (forbid_black and c == (0, 0, 0)):
            continue
        seen.add(c)
        out.append(c)
    return np.array(out, dtype=np.uint8)


def extract_masks_downsampled(ids: np.ndarray, segment_ids: Sequence[int],
                              out_hw: Tuple[int, int]) -> np.ndarray:
    """[h, w] id map + K segment ids → [K, oh, ow] uint8 masks on a nearest
    grid: output (y, x) samples ``ids[floor((y + 0.5) · h / oh), floor((x +
    0.5) · w / ow)]`` (clamped), in float64 as the JAX package's native
    codec and its numpy fallback compute it.  A pixel marks only the first
    slot that holds its id, as the native codec does when an id repeats."""
    oh, ow = out_hw
    h, w = ids.shape
    sy = np.minimum(((np.arange(oh) + 0.5) * h / oh).astype(np.int64), h - 1)
    sx = np.minimum(((np.arange(ow) + 0.5) * w / ow).astype(np.int64), w - 1)
    small = np.asarray(ids)[sy][:, sx]
    seg = np.asarray(segment_ids, np.int64).reshape(-1)
    out = np.zeros((len(seg), oh, ow), np.uint8)
    for k, s in enumerate(seg):
        if s not in seg[:k]:
            out[k] = small == s
    return out
