"""The one traffic generator: images and arrival times from a traffic
file's parameters and a run's seed.

A mix lists image sizes with a fixed count each, so every seed gets the
same set of sizes (and the same work) in another order; the pixels are
seeded noise.  An open-loop mix adds a Poisson schedule at a fixed rate.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from psgbench.weights import sub_seed


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, stream))


def image_sizes(mix: Sequence[Dict], seed: int) -> List[Tuple[int, int]]:
    """[(h, w)] with each entry's ``count`` copies of its ``hw``, shuffled."""
    sizes = [tuple(int(x) for x in m["hw"]) for m in mix for _ in range(int(m["count"]))]
    order = rng(seed, 2).permutation(len(sizes))
    return [sizes[i] for i in order]


def make_images(sizes: Sequence[Tuple[int, int]], seed: int) -> List[np.ndarray]:
    """Seeded uint8 RGB noise, one array [h, w, 3] per size."""
    r = rng(seed, 3)
    return [r.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in sizes]


def chunks_by_bucket(buckets: Sequence[Tuple[int, int]], group: int):
    """Indices grouped by bucket, in runs of ``group`` (the infer tool's
    grouping; a last short run per bucket stays short) → [(bucket, [i])]."""
    by: Dict[Tuple[int, int], List[int]] = {}
    for i, b in enumerate(buckets):
        by.setdefault(tuple(b), []).append(i)
    out = []
    for b in sorted(by, key=lambda b: -b[0] * b[1]):
        idx = by[b]
        out += [(b, idx[s:s + group]) for s in range(0, len(idx), group)]
    return out


def chunk_order(chunk_buckets: Sequence[Tuple[int, int]], seed: int):
    """Endless chunk indices, every chunk once per cycle.  The sequence of
    buckets is the same for every seed and spreads each bucket evenly over
    the cycle (at each step the bucket furthest behind its share), so any
    stretch of the loop does the same work; the seed picks which of a
    bucket's chunks comes when."""
    kinds = sorted(set(chunk_buckets), key=lambda b: -b[0] * b[1])
    members = {b: [i for i, c in enumerate(chunk_buckets) if c == b] for b in kinds}
    n = len(chunk_buckets)
    seq, taken = [], dict.fromkeys(kinds, 0)
    for k in range(1, n + 1):
        b = max(kinds, key=lambda b: (k * len(members[b]) / n - taken[b], -kinds.index(b)))
        seq.append(b)
        taken[b] += 1
    r = rng(seed, 4)
    while True:
        perm = {b: iter(r.permutation(members[b]).tolist()) for b in kinds}
        yield from (next(perm[b]) for b in seq)


def poisson_arrivals(rate: float, n: int, seed: int) -> np.ndarray:
    """``n`` arrival times (s) of a Poisson process at ``rate`` per second."""
    return np.cumsum(rng(seed, 5).exponential(1.0 / float(rate), size=int(n)))
