"""Readers of the files the JAX package writes, with no JAX, flax or orbax.

* :func:`read_flax_msgpack`: a flax ``serialization.to_bytes`` file, as
  the JAX ``tools/convert_openseed.py`` and ``tools/convert_mask2former.py``
  write ``segmenter.msgpack``.  It is msgpack whose arrays are an ext type
  (code 1: ``(shape, dtype name, C-order bytes)``, itself msgpack; code 3:
  a numpy scalar in the same form); arrays over 1 GiB are split into a
  ``__msgpack_chunked_array__`` dict.  Needs ``msgpack``.
* :func:`read_orbax_tree`: one item of an orbax checkpoint saved with
  ``StandardSave`` (the JAX ``PartCheckpointer``'s ``params`` and
  ``opt_state``): the tree comes from its ``_METADATA`` JSON, each array
  from its zarr store inside the item's OCDBT key-value store (the layout
  the JAX package's orbax writes; another is refused by name) through
  ``tensorstore``.  A tuple or namedtuple node (an optax chain's state,
  its members by position) is a dict keyed by position (``"0"``, ...) or
  field name, as its ``_METADATA`` names them; an empty state (optax's
  ``EmptyState``, saved as a ``None`` leaf) is ``None``.

Both give nested dicts of numpy arrays; bfloat16 arrays become float32
(numpy has no bfloat16 of its own).  ``msgpack`` and ``tensorstore`` are
imported when a file is read, and their absence raises an ``ImportError``
that names them.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


def _require(name: str, what: str):
    import importlib

    try:
        return importlib.import_module(name)
    except ImportError as e:
        raise ImportError(f"reading {what} needs the {name!r} package, which is not "
                          f"installed; install {name} or convert the file with the JAX "
                          "package's tools first") from e


def _bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    """bfloat16 bits (uint16) → the float32 of the same value (exact)."""
    return (raw.astype(np.uint32) << 16).view(np.float32)


def _array_from_bytes(msgpack, data: bytes) -> np.ndarray:
    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    if dtype == "bfloat16":
        return _bf16_to_f32(np.frombuffer(buf, np.uint16)).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype)).reshape(shape).copy()


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(path: str) -> Dict[str, Any]:
    """A flax ``serialization.to_bytes`` file → its state dict (nested
    dicts, numpy leaves)."""
    msgpack = _require("msgpack", f"the flax msgpack file {path}")

    def ext_hook(code, data):
        if code == _EXT_NDARRAY:
            return _array_from_bytes(msgpack, data)
        if code == _EXT_NPSCALAR:
            return _array_from_bytes(msgpack, data)[()]
        raise ValueError(f"{path}: msgpack ext type {code} holds no array")

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)
    return _unchunk(tree)


def read_orbax_tree(item_dir: str) -> Dict[str, Any]:
    """One ``StandardSave`` item of an orbax checkpoint (a directory holding
    ``_METADATA``) → its tree (nested dicts, numpy leaves, ``None`` for an
    empty state)."""
    ts = _require("tensorstore", f"the orbax checkpoint {item_dir}")
    with open(os.path.join(item_dir, "_METADATA"), encoding="utf-8") as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
        raise ValueError(f"{item_dir}: arrays stored with use_ocdbt="
                         f"{meta.get('use_ocdbt')}, use_zarr3={meta.get('use_zarr3')}; this "
                         "reader takes the JAX package's layout (zarr inside OCDBT)")
    base = "file://" + os.path.abspath(item_dir)
    tree: Dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        kind = entry["value_metadata"]["value_type"]
        if kind == "None":
            arr = None
        elif kind in ("jax.Array", "np.ndarray"):
            spec = {"driver": "zarr", "path": ".".join(keys),
                    "kvstore": {"driver": "ocdbt", "base": base}}
            arr = np.asarray(ts.open(spec, open=True, read=True).result().read().result())
            if arr.dtype.name == "bfloat16":
                arr = _bf16_to_f32(arr.view(np.uint16))
        else:
            raise ValueError(f"{item_dir}: leaf {'/'.join(keys)} is a {kind!r}, not an array")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return tree
