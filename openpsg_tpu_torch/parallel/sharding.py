"""Parameter sharding policy (counterpart of
``openpsg_tpu/parallel/sharding.py``): Megatron-style tensor parallelism
for the LLM, replication for the relation head and the segmenter, the
pair axis of one image split over a mesh axis.

  * attention q/k/v and FFN gate/up, and ``lm_head``: column parallel, the
    output features split (each rank computes its block of outputs);
  * attention output and FFN down: row parallel, the input features split
    (each rank's partial product is summed over tp in float32);
  * the token embedding: split on the vocabulary (a masked lookup, then a
    sum over tp);
  * the int8 ``scale`` of a column-parallel ``QDense`` is split with its
    weight; the row-parallel scale, applied after the sum, is replicated;
  * everything else is replicated.

The rules are matched on the port's state-dict names.  The port stores
``[out, in]`` weights (``nn.Linear``, ``QDense.weight_q``) where flax has
``[in, out]`` kernels, so "col" splits dim 0 and "row" dim 1.  A spec is a
tuple with ``"tp"`` at the split dim and ``None`` elsewhere (``()`` for a
replicated tensor).

The port splits attention by WHOLE heads: RoPE rotates the two halves of
a head together, so a rank cannot hold half a head.  Given the LLM's
config, q/o shard only where the heads divide tp (and each rank's query
heads map onto whole kv heads), k/v only where the kv heads divide too;
otherwise they stay replicated.  GSPMD splits feature axes anywhere, so
at tiny shapes the two plans differ (k/v at 2 kv heads and tp 4); at
Llama-2-7B shapes they agree leaf for leaf.  A non-dividing axis degrades
to replicated, as in the JAX plan.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import torch

from openpsg_tpu_torch.parallel.comm import all_gather, gather_objects
from openpsg_tpu_torch.parallel.mesh import axis_group, axis_size

# (name regex, role): first match wins
_LLM_RULES: Tuple[Tuple[str, str], ...] = (
    (r"(^|\.)tok_embed\.weight$", "vocab"),
    (r"(^|\.)(wq|wk|wv|w_gate|w_up|lm_head)\.(weight|weight_q|scale)$", "col"),
    (r"(^|\.)(wo|w_down)\.(weight|weight_q)$", "row"),
)

_GROUP_OF = {"wq": "q", "wo": "q", "wk": "kv", "wv": "kv", "w_gate": "ffn", "w_up": "ffn",
             "w_down": "ffn", "lm_head": "vocab", "tok_embed": "vocab"}

Spec = Tuple[Optional[str], ...]


def _module_of(name: str) -> str:
    return name.rsplit(".", 2)[-2] if name.count(".") else name


def param_sharding_rules(name: str, ndim: int) -> Spec:
    """The rule's spec for a tensor of ``ndim`` dims named ``name``."""
    for pat, role in _LLM_RULES:
        if re.search(pat, name):
            axes = [None] * ndim
            axes[1 if role == "row" and ndim > 1 else 0] = "tp"
            return tuple(axes)
    return ()


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """Which parts of a Llama split over ``size`` tp ranks: the attention
    (``q``: query heads and the output; ``kv``: key/value heads), the FFN
    and the vocabulary."""

    size: int
    q: bool
    kv: bool
    ffn: bool
    vocab: bool


def tp_layout(cfg, tp: int) -> TPLayout:
    H, KV = cfg.n_heads, cfg.n_kv_heads
    rep = H // KV
    q = tp > 1 and H % tp == 0 and ((H // tp) % rep == 0 or rep % (H // tp) == 0)
    return TPLayout(size=tp, q=q, kv=q and KV % tp == 0, ffn=tp > 1 and cfg.ffn_hidden % tp == 0,
                    vocab=tp > 1 and cfg.vocab_size % tp == 0)


def _named_shapes(params) -> Dict[str, torch.Size]:
    if isinstance(params, torch.nn.Module):
        full = getattr(params, "_tp_full", {})
        return {n: full.get(n, p.shape) for n, p in params.named_parameters()}
    return {n: t.shape for n, t in params.items()}


def plan_shardings(params, mesh, cfg=None) -> Dict[str, Spec]:
    """{name: spec} for a module or a {name: tensor} dict (``meta`` tensors
    plan Llama-2-7B without allocating).  ``mesh``: a DeviceMesh or
    ``{"tp": n}``.  ``cfg`` (the LlamaConfig; a module's own by default)
    adds the whole-head rule."""
    tp = axis_size(mesh, "tp")
    if cfg is None:
        cfg = getattr(params, "cfg", None)
    layout = tp_layout(cfg, tp) if cfg is not None else None
    out = {}
    for name, shape in _named_shapes(params).items():
        spec = param_sharding_rules(name, len(shape))
        if "tp" in spec:
            dim = spec.index("tp")
            if shape[dim] % tp != 0 or (
                    layout is not None and not getattr(layout, _GROUP_OF[_module_of(name)])):
                spec = ()
        out[name] = spec
    return out


@dataclasses.dataclass
class TPState:
    """The tp runtime a sharded Llama reads: its group, this rank and the
    layout; ``kv_lo`` / ``kv_local``: the kv heads this rank's query heads
    use where k/v stay replicated."""

    group: object
    rank: int
    layout: TPLayout
    heads_local: int
    kv_lo: int
    kv_local: int


def _tp_state(cfg, layout: TPLayout, group, rank: int) -> TPState:
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if not layout.q:
        return TPState(group, rank, layout, H, 0, KV)
    hl = H // layout.size
    if layout.kv:
        return TPState(group, rank, layout, hl, rank * (KV // layout.size), KV // layout.size)
    rep = H // KV
    return TPState(group, rank, layout, hl, rank * hl // rep, max(hl // rep, 1))


def shard_params(llm, mesh) -> Dict[str, Spec]:
    """Keep this rank's block of every tensor the plan splits over the
    mesh's ``tp`` dim (the rest is freed), and set the tp runtime on the
    LLM's modules → {name: spec} of the split tensors ({} without tp).
    Only a Llama: another family is refused by name."""
    from openpsg_tpu_torch.models.llm.llama import require_llama

    require_llama(llm.cfg, "parallel.sharding.shard_params")
    g = axis_group(mesh, "tp")
    if g is None or g[2] <= 1:
        return {}
    group, rank, size = g
    plan = plan_shardings(llm, mesh)
    full = {}
    with torch.no_grad():
        for name, p in llm.named_parameters():
            spec = plan[name]
            if "tp" not in spec:
                continue
            dim = spec.index("tp")
            full[name] = p.shape
            p.data = p.data.chunk(size, dim)[rank].clone()
    llm._tp_full, llm._tp_specs = full, {n: plan[n] for n in full}
    state = _tp_state(llm.cfg, tp_layout(llm.cfg, size), group, rank)
    for m in llm.modules():
        if hasattr(type(m), "tp"):
            m.tp = state
    return llm._tp_specs


def assert_llm_sharded(llm, mesh, min_sharded: int = 4, tensors=None, prefix: str = "") -> int:
    """Guard against silent replication: with tp > 1, every tensor whose
    rule plans a dividing tp split must hold only its rank's block.  The
    expected count is computed from the plan at the full shapes, so it
    tightens with depth and quantization; ``min_sharded`` checks that the
    plan found enough tensors to split at all.  ``tensors`` ({prefix +
    name: tensor}, e.g. the trainer's masters or AdamW moments) are
    checked in place of the LLM's own.  → the count of split tensors."""
    tp = axis_size(mesh, "tp")
    if tp <= 1:
        return 0
    plan = plan_shardings(llm, mesh)
    shapes = _named_shapes(llm)
    expected = [n for n, s in plan.items() if "tp" in s]
    if tensors is None:
        tensors = {prefix + n: p for n, p in llm.named_parameters()}
    n = 0
    for name in expected:
        t = tensors.get(prefix + name)
        if t is None:
            continue
        dim = plan[name].index("tp")
        n += int(t.shape[dim] * tp == shapes[name][dim])
    if len(expected) < min_sharded:
        raise AssertionError(f"sharding rules planned only {len(expected)} tp tensors "
                             f"(need ≥{min_sharded}) — shapes too small for tp={tp}?")
    present = sum(prefix + e in tensors for e in expected)
    if n < present:
        raise AssertionError(f"LLM params not tensor-sharded: {n} tensors hold a tp block but "
                             f"the rules plan {present} at these shapes — params were kept "
                             "whole without shard_params?")
    return n


def _tp_of(llm) -> Optional[TPState]:
    return next((m.tp for m in llm.modules() if getattr(m, "tp", None) is not None), None)


def local_part(llm, name: str, full: torch.Tensor) -> torch.Tensor:
    """This rank's block of a whole tensor ``name`` of the LLM (a
    checkpoint value), or the tensor itself where it is not split."""
    spec = getattr(llm, "_tp_specs", {}).get(name)
    if not spec:
        return full
    tp = _tp_of(llm)
    return full.chunk(tp.layout.size, spec.index("tp"))[tp.rank].clone()


def full_tensors(llm, tensors: Dict[str, torch.Tensor], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Whole tensors from this rank's parts ({prefix + name: tensor}, names
    of the LLM's parameters; other names pass through): tp blocks
    all-gathered along their split dim, pipeline stages' layers gathered
    from every stage.  Every rank of the mesh must call it."""
    specs = getattr(llm, "_tp_specs", {})
    tp = _tp_of(llm)
    out = {}
    for key, t in tensors.items():
        spec = specs.get(key[len(prefix):]) if key.startswith(prefix) else None
        out[key] = all_gather(t.contiguous(), spec.index("tp"), tp.group) if spec else t
    pp = getattr(llm.core, "pp_group", None)
    if pp is not None:
        merged = {}
        for part in gather_objects({k: v.cpu() for k, v in out.items()}, pp):
            merged.update(part)
        dev = next(iter(tensors.values())).device if tensors else torch.device("cpu")
        out = {k: v.to(dev) for k, v in merged.items()}
    return out


def pair_sharded_range(mesh, num_pairs: int, axis: str = "dp") -> Optional[Tuple[int, int]]:
    """The sequence-parallel analogue for the relation stage (the pair axis
    of one image split across the mesh ``axis``): this rank's contiguous
    range ``[lo, hi)`` of the ``num_pairs`` pair-major rows, or None where
    ``num_pairs`` does not divide the axis (the JAX constraint would be
    rejected then)."""
    g = axis_group(mesh, axis)
    n = 1 if g is None else g[2]
    if num_pairs % n != 0:
        return None
    r = 0 if g is None else g[1]
    per = num_pairs // n
    return r * per, (r + 1) * per
