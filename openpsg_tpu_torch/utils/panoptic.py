"""Panoptic PNG id encoding (a copy of ``openpsg_tpu/utils/panoptic.py``).

Submission PNGs encode segment ids in RGB: ``id = R + 256*G + 256²*B``
(panopticapi convention).  Colours per segment are drawn from a seedable
RNG, in the JAX package's draw order, so equal seeds give equal colours and
so equal segment ids in ``relation.json``.
"""

from __future__ import annotations

from typing import Optional

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
