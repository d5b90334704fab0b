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
* ``scale`` (norms) and ``embedding`` become ``weight``;
* int8 ``QDense`` leaves (``quantize_llama`` trees): ``kernel_q`` ``[in, out]``
  becomes ``weight_q`` ``[out, in]`` (still int8), and the per-channel
  ``scale`` under a quantized projection stays ``scale``.

:func:`jax_paths` runs the map backwards: each port parameter's JAX leaf
path, which ``paramwise_cfg`` classifies (train/trainer.py).

Accounting is strict: every leaf maps to distinct port parameters and every
port parameter is filled (``load_state_dict(strict=True)``).  ``text`` is
the class-name language encoder; ``class_embeds``, the matrix the JAX model
classifies against (its encoder's output, or a precomputed ``.npy``), is
taken as it is.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from openpsg_tpu_torch.models.llm.llama import QUANT_TARGETS

# flax path prefix of each nn.scan stack → port prefix of its ModuleList
SCANNED = {
    ("segmenter", "pixel_decoder", "layers", "layer"): ("segmenter", "pixel_decoder", "layers"),
    ("segmenter", "decoder", "layers"): ("segmenter", "decoder", "layers"),
    ("llm", "core", "layers"): ("llm", "core", "layers"),
}
MODULE_PARTS = ("segmenter", "head", "llm", "text")


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
    if name == "kernel_q":  # QDense int8 [in, out]
        return "weight_q", arr.T
    if name == "bias" and arr.ndim == 2 and parent in ("query", "key", "value"):
        return "bias", arr.reshape(-1)
    if name == "scale" and parent in QUANT_TARGETS:  # QDense per-channel scale
        return "scale", arr
    if name in ("scale", "embedding"):
        return "weight", arr
    return name, arr


def _part_items(part: str, tree, scanned=None) -> Iterator[Tuple[str, np.ndarray, str]]:
    """(port parameter name, converted array, '/'-joined JAX path under
    ``params``) for each leaf of one part's tree, scan stacks unstacked
    (``scanned``: {flax path prefix: port prefix}, default :data:`SCANNED`)."""
    scanned = SCANNED if scanned is None else scanned
    for path, arr in _leaves(tree["params"], (part,)):
        src = "/".join(path)
        scan = next((k for k in scanned if path[: len(k)] == k), None)
        if scan is None:
            leaf, conv = _convert_leaf(path, arr)
            yield ".".join(path[1:-1] + (leaf,)), conv, src
            continue
        rest = path[len(scan):]
        for i in range(arr.shape[0]):
            leaf, conv = _convert_leaf(path, arr[i])
            yield ".".join(scanned[scan][1:] + (str(i),) + rest[:-1] + (leaf,)), conv, src


def part_state_dict(part: str, tree, scanned=None) -> Dict[str, np.ndarray]:
    """One part's flax ``{"params": ...}`` tree → {port parameter name:
    array}.  Raises on any leaf that would land on a name already taken."""
    out: Dict[str, np.ndarray] = {}
    for name, arr, src in _part_items(part, tree, scanned):
        if name in out:
            raise ValueError(f"{src} collides with another leaf at {part}.{name}")
        out[name] = np.array(arr, order="C")  # owned, writable copy
    return out


def part_sources(part: str, tree) -> Dict[str, str]:
    """{port parameter name: the JAX leaf path it comes from} for one part's
    tree, in :func:`jax_paths`' form (``part/params/...``)."""
    return {name: part + "/params" + src[len(part):]
            for name, _, src in _part_items(part, tree)}


def _jax_leaf(module: torch.nn.Module, leaf: str) -> str:
    """The flax leaf name of the port parameter ``leaf`` of ``module``."""
    if leaf == "weight_q":
        return "kernel_q"
    if leaf != "weight":
        return leaf
    if isinstance(module, (torch.nn.Linear, torch.nn.Conv2d)):
        return "kernel"
    if isinstance(module, torch.nn.Embedding):
        return "embedding"
    if isinstance(module, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
        return "scale"
    return leaf  # RMSNorm's own 'weight


def jax_paths(module: torch.nn.Module, part: str) -> Dict[str, str]:
    """{port parameter name: '/'-joined path of its JAX leaf} for one part's
    module, as ``jax.tree_util`` spells the path in ``{part: {"params":
    ...}}`` (a scan stack's layers share their stacked leaf's path)."""
    modules = dict(module.named_modules())
    port_scans = {v[1:]: k[1:] for k, v in SCANNED.items() if k[0] == part}
    out = {}
    for name, _ in module.named_parameters():
        *mod_path, leaf = name.split(".")
        jax_leaf = _jax_leaf(modules[".".join(mod_path)], leaf)
        path = tuple(mod_path)
        for port_prefix, jax_prefix in port_scans.items():
            if path[: len(port_prefix)] == port_prefix:   # drop the layer index
                path = jax_prefix + path[len(port_prefix) + 1:]
                break
        out[name] = "/".join((part, "params") + path + (jax_leaf,))
    return out


def load_part(module: torch.nn.Module, part: str, tree, scanned=None) -> int:
    """Load one part (``segmenter``, ``head`` or ``llm``) into its port
    module, each array cast to its parameter's dtype; returns the number of
    JAX leaves used.  Raises on a missing, extra or misshapen parameter."""
    ref = module.state_dict()
    sd = {}
    for name, arr in part_state_dict(part, tree, scanned).items():
        if name in ref and tuple(ref[name].shape) != arr.shape:
            raise ValueError(
                f"{part}.{name}: JAX {arr.shape} vs port {tuple(ref[name].shape)}")
        sd[name] = torch.from_numpy(arr)
    module.load_state_dict(sd, strict=True)
    return sum(1 for _ in _leaves(tree["params"]))


def scan_prefixes(module: torch.nn.Module, part: str) -> Dict[Tuple[str, ...], Tuple[str, ...]]:
    """The ``scanned=`` map of one part of a model whose every ``layers``
    ModuleList is a flax ``nn.scan`` stack at the same path (the
    closed-set family: BERT towers, the Llama trunk, the graph transformer,
    the masked-attention decoder), and the pixel decoder's, whose flax
    stack sits one scope deeper (``layers/layer``)."""
    out = {}
    for name, sub in module.named_modules():
        path = tuple(name.split(".")) if name else ()
        if path and path[-1] == "layers" and isinstance(sub, torch.nn.ModuleList):
            flax = (part,) + path
            if path[-2:] == ("pixel_decoder", "layers"):
                flax = flax + ("layer",)
            out[flax] = (part,) + path
    return out


def load_family_params(model, params) -> Dict[str, object]:
    """Load a JAX ``PSGMask2FormerRelation.params`` tree (numpy leaves:
    ``segmenter``, ``head``, ``object_cls_embed``) into the port's model of
    the closed-set family.  Returns a report: leaves used per part."""
    unknown = set(params) - {"segmenter", "head", "object_cls_embed"}
    if unknown:
        raise KeyError(f"unexpected top-level keys {sorted(unknown)}")
    report = {"used": {}}
    for part in ("segmenter", "head"):
        module = getattr(model, part)
        report["used"][part] = load_part(module, part, params[part],
                                         scanned=scan_prefixes(module, part))
    emb = np.array(params["object_cls_embed"], dtype=np.float32)
    if tuple(model.object_cls_embed.shape) != emb.shape:
        raise ValueError(f"object_cls_embed: JAX {emb.shape} vs port "
                         f"{tuple(model.object_cls_embed.shape)}")
    with torch.no_grad():
        model.object_cls_embed.copy_(torch.from_numpy(emb))
    report["used"]["object_cls_embed"] = 1
    return report


def load_jax_params(model, params) -> Dict[str, object]:
    """Load a JAX ``PSGv4.params`` tree (numpy leaves) into a port
    ``PSGv4``, or a ``PSGMask2FormerRelation.params`` tree into the port's
    model of the closed-set family (:func:`load_family_params`).  Returns
    a report: leaves used per part."""
    if "object_cls_embed" in params:
        return load_family_params(model, params)
    unknown = set(params) - set(MODULE_PARTS) - {"class_embeds"}
    if unknown:
        raise KeyError(f"unexpected top-level keys {sorted(unknown)}")
    report = {"used": {}}
    for part in MODULE_PARTS:
        report["used"][part] = load_part(getattr(model, part), part, params[part])
    ce = np.array(params["class_embeds"], dtype=np.float32)
    model.class_embeds = torch.from_numpy(ce).to(model.device)
    report["used"]["class_embeds"] = 1
    return report
