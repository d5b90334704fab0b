"""Load the JAX package's ``PSGv4.params`` tree into the port's modules.

The tree arrives as numpy arrays (``jax.device_get`` of the params; this
module imports no JAX).  Top keys: ``segmenter``, ``head``, ``llm`` (each
``{"params": ...}``), ``text`` and ``class_embeds``.  The port's parameter
names mirror the flax names, so the map is mechanical:

* ``nn.scan`` stacks (pixel-decoder encoder, query decoder, LLM blocks)
  are unstacked along their leading layer axis into ``layers.{i}``;
* flax dense kernels ``[in, out]`` become ``[out, in]``; convolutions HWIO
  become OIHW; flax ``MultiHeadDotProductAttention`` kernels
  ``[in, heads, hd]`` / ``[heads, hd, out]`` and biases ``[heads, hd]`` are
  flattened over (heads, hd);
* ``scale`` (norms) and ``embedding`` become ``weight``.

Accounting is strict: every leaf maps to distinct port parameters, every
port parameter is filled (``load_state_dict(strict=True)``), and ``text``
is reported as the one part left unused (the language encoder is a later
slice; ``class_embeds`` arrives as a tensor).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

# flax path prefix of each nn.scan stack → port prefix of its ModuleList
SCANNED = {
    ("segmenter", "pixel_decoder", "layers", "layer"): ("segmenter", "pixel_decoder", "layers"),
    ("segmenter", "decoder", "layers"): ("segmenter", "decoder", "layers"),
    ("llm", "core", "layers"): ("llm", "core", "layers"),
}
MODULE_PARTS = ("segmenter", "head", "llm")
UNUSED_PARTS = ("text",)


def _leaves(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, path + (str(k),))
        else:
            yield path + (str(k),), np.asarray(v)


def _convert_leaf(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    name, parent = path[-1], (path[-2] if len(path) > 1 else "")
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 3:  # MultiHeadDotProductAttention DenseGeneral
            if parent == "out":
                return "weight", arr.reshape(-1, arr.shape[-1]).T
            return "weight", arr.reshape(arr.shape[0], -1).T
        raise ValueError(f"kernel of rank {arr.ndim} at {'/'.join(path)}")
    if name == "bias" and arr.ndim == 2 and parent in ("query", "key", "value"):
        return "bias", arr.reshape(-1)
    if name in ("scale", "embedding"):
        return "weight", arr
    return name, arr


def part_state_dict(part: str, tree) -> Dict[str, np.ndarray]:
    """One part's flax ``{"params": ...}`` tree → {port parameter name:
    array}.  Raises on any leaf that would land on a name already taken."""
    out: Dict[str, np.ndarray] = {}

    def put(name, arr, src):
        if name in out:
            raise ValueError(f"{src} collides with another leaf at {part}.{name}")
        out[name] = np.array(arr, order="C")  # owned, writable copy

    for path, arr in _leaves(tree["params"], (part,)):
        src = "/".join(path)
        scan = next((k for k in SCANNED if path[: len(k)] == k), None)
        if scan is None:
            leaf, conv = _convert_leaf(path, arr)
            put(".".join(path[1:-1] + (leaf,)), conv, src)
            continue
        rest = path[len(scan):]
        for i in range(arr.shape[0]):
            leaf, conv = _convert_leaf(path, arr[i])
            put(".".join(SCANNED[scan][1:] + (str(i),) + rest[:-1] + (leaf,)), conv, src)
    return out


def load_part(module: torch.nn.Module, part: str, tree) -> int:
    """Load one part (``segmenter``, ``head`` or ``llm``) into its port
    module; returns the number of JAX leaves used.  Raises on a missing,
    extra or misshapen parameter."""
    ref = module.state_dict()
    sd = {}
    for name, arr in part_state_dict(part, tree).items():
        if name in ref and tuple(ref[name].shape) != arr.shape:
            raise ValueError(
                f"{part}.{name}: JAX {arr.shape} vs port {tuple(ref[name].shape)}")
        sd[name] = torch.from_numpy(arr)
    module.load_state_dict(sd, strict=True)
    return sum(1 for _ in _leaves(tree["params"]))


def load_jax_params(model, params) -> Dict[str, object]:
    """Load a JAX ``PSGv4.params`` tree (numpy leaves) into a port
    ``PSGv4``.  Returns a report: leaves used per part and the parts left
    unused."""
    unknown = set(params) - set(MODULE_PARTS) - set(UNUSED_PARTS) - {"class_embeds"}
    if unknown:
        raise KeyError(f"unexpected top-level keys {sorted(unknown)}")
    report = {"used": {}, "unused": [p for p in UNUSED_PARTS if p in params]}
    for part in MODULE_PARTS:
        report["used"][part] = load_part(getattr(model, part), part, params[part])
    ce = np.array(params["class_embeds"], dtype=np.float32)
    model.class_embeds = torch.from_numpy(ce).to(model.device)
    report["used"]["class_embeds"] = 1
    return report
