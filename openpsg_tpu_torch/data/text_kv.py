"""Offline text KV stores (pair/triplet descriptions + embeddings); a copy of
``openpsg_tpu/data/text_kv.py`` (numpy, ``dbm`` and ``pickle`` only).

Reference (SURVEY.md §2.12): dbm files keyed ``"sub#obj"`` /
``"sub#obj#rel"`` holding GPT-3.5 description strings and ada-002 1536-d
embeddings, opened read-only at detector init
(mask2former_relation_v2.py:101-105) and ``pickle.loads``-ed per lookup;
missing keys fall back to empty string / zero embedding
(openseed_relation.py:346-354).

Design: the detector reads the store once at construction (the pair
matrix, and the compacted triplet index) and gathers rows by class label on
the device — no per-forward dbm reads.  An in-memory dict backend makes
tests hermetic; a builder utility writes stores from a json of
{key: vector} for users generating their own descriptions.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class TextKVStore:
    """Read-only KV of numpy vectors with zero-fallback."""

    def __init__(
        self,
        path: Optional[str] = None,
        embedding_size: int = 1536,
        table: Optional[Dict[str, np.ndarray]] = None,
    ):
        self.embedding_size = embedding_size
        self._db = None
        self._table = table
        if path is not None and os.path.exists(path):
            import dbm

            self._db = dbm.open(path, "r")

    def get(self, key: str) -> np.ndarray:
        if self._table is not None and key in self._table:
            return np.asarray(self._table[key], np.float32)
        if self._db is not None:
            raw = self._db.get(key.encode("utf-8"))
            if raw is not None:
                val = pickle.loads(raw)
                return np.asarray(val, np.float32)
        return np.zeros(self.embedding_size, np.float32)

    def pair_matrix(self, names: Sequence[str]) -> np.ndarray:
        """[N, N, T] embeddings for all ordered name pairs ('sub#obj')."""
        N = len(names)
        out = np.zeros((N, N, self.embedding_size), np.float32)
        for i, a in enumerate(names):
            for j, b in enumerate(names):
                out[i, j] = self.get(f"{a}#{b}")
        return out

    def triplet_matrix(
        self, names: Sequence[str], relations: Sequence[str]
    ) -> np.ndarray:
        """[N, N, R, T] embeddings for 'sub#obj#rel' keys."""
        N, R = len(names), len(relations)
        out = np.zeros((N, N, R, self.embedding_size), np.float32)
        for i, a in enumerate(names):
            for j, b in enumerate(names):
                for r, rel in enumerate(relations):
                    out[i, j, r] = self.get(f"{a}#{b}#{rel}")
        return out

    def _keys(self) -> List[str]:
        ks: List[str] = []
        if self._table is not None:
            ks.extend(self._table.keys())
        if self._db is not None:
            ks.extend(k.decode("utf-8") for k in self._db.keys())
        return ks

    def triplet_index(
        self, names: Sequence[str], relations: Sequence[str]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Compact per-relation triplet embeddings for on-device gather.

        The dense ``triplet_matrix`` is ~6 GB at PSG scale (133² pairs ×
        56 predicates × 1536 floats), so rows are materialized only for
        ``"sub#obj#rel"`` keys PRESENT in the store (one pass over the
        store's own keys, not 990k probes).  Returns ``(lookup, table)``:
        ``lookup[sub_cls, obj_cls, rel] -> row`` (int32, [N, N, R], ~4 MB
        at PSG scale) and ``table`` [rows+1, T] with row 0 the zero
        vector — the reference's missing-key fallback
        (openseed_relation.py:346-354).  The detector gathers
        ``table[lookup[labels⊗labels]]`` per image on the device."""
        name_idx = {n: i for i, n in enumerate(names)}
        rel_idx = {r: i for i, r in enumerate(relations)}
        lookup = np.zeros(
            (len(names), len(names), len(relations)), np.int32
        )
        rows: List[np.ndarray] = [np.zeros(self.embedding_size, np.float32)]
        for key in self._keys():
            parts = key.split("#")
            if len(parts) != 3:
                continue
            a, b, r = parts
            if a in name_idx and b in name_idx and r in rel_idx:
                lookup[name_idx[a], name_idx[b], rel_idx[r]] = len(rows)
                rows.append(self.get(key))
        return lookup, np.stack(rows)

    def close(self):
        if self._db is not None:
            self._db.close()


def build_store(path: str, table: Dict[str, np.ndarray]) -> None:
    """Write a dbm store from {key: vector} (generation-script stand-in;
    the reference's generators are not in its repo)."""
    import dbm

    with dbm.open(path, "c") as db:
        for k, v in table.items():
            db[k.encode("utf-8")] = pickle.dumps(np.asarray(v, np.float32))
