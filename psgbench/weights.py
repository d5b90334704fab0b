"""Seeded weights, made on the card in a few large calls.

The benchmark, not the program, makes every weight: one standard normal
draw per dtype (in blocks of at most 2**30 values) from a
``torch.Generator`` on the device, cut into one view per parameter and
scaled in place: matrices and kernels by ``fan_in ** -0.5``, a norm's
weight to ``1 + 0.1·z``, biases and shifts to ``0.1·z``, a scalar to
``1 + 0.1·z``.  The same seed and parameter list give the same values, so
the reference regenerates them after the program is gone.

Plain random weights make a segmenter whose queries are all alike and
whose masks cover most of the image, so that fusion keeps no object.  A
system adapter therefore shapes its draw (:func:`scale_matching`,
:func:`offset_masks`): residual branches quieted, as depth-scaled
initialisations do, so that queries stay distinct, and every mask logit
lowered by one calibrated amount, so that masks are small and fusion keeps
objects (:func:`upper_tail` reads the amount).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

ALIGN = 64        # elements: every view starts 128-byte aligned in bf16
BLOCK = 1 << 30   # values per generator call

Spec = List[Tuple[str, Tuple[int, ...], torch.dtype]]


def sub_seed(seed: int, stream: int) -> int:
    """An independent generator seed for one use of a run's seed."""
    return (int(seed) * 1_000_003 + int(stream)) % (1 << 63)


def spec_of(modules: Dict[str, torch.nn.Module]) -> Spec:
    """[(group.name, shape, dtype)] of every state entry, in module order."""
    return [(f"{g}.{n}", tuple(t.shape), t.dtype)
            for g, m in modules.items() for n, t in m.state_dict().items()]


def _scale(name: str, v: torch.Tensor) -> None:
    if v.dim() >= 2:
        v.mul_(v[0].numel() ** -0.5)
    elif v.dim() == 1 and not name.endswith("weight"):
        v.mul_(0.1)
    else:
        v.mul_(0.1).add_(1.0)


def make(spec: Sequence, seed: int, device) -> Dict[str, torch.Tensor]:
    """→ {name: tensor} for ``spec`` (views into one buffer per dtype)."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    out: Dict[str, torch.Tensor] = {}
    for dtype in sorted({d for _, _, d in spec}, key=str):
        items = [(n, s) for n, s, d in spec if d == dtype]
        offs, total = [], 0
        for _, shape in items:
            offs.append(total)
            n = 1
            for x in shape:
                n *= x
            total += -(-n // ALIGN) * ALIGN
        flat = torch.empty(total, dtype=dtype, device=device)
        for s in range(0, total, BLOCK):
            flat[s:s + BLOCK].normal_(generator=gen)
        for (name, shape), off in zip(items, offs):
            n = 1
            for x in shape:
                n *= x
            v = flat[off:off + n].view(shape)
            _scale(name, v)
            out[name] = v
    return out


def scale_matching(W: Dict[str, torch.Tensor], prefixes: Sequence[str], parts: Sequence[str],
                   factor: float) -> None:
    """Multiply in place every tensor whose name starts with one of
    ``prefixes`` and holds one of ``parts``."""
    for n, v in W.items():
        if n.startswith(tuple(prefixes)) and any(p in n for p in parts):
            v.mul_(factor)


def offset_masks(W: Dict[str, torch.Tensor], features: str, head: str, shift: float) -> None:
    """Lower every mask logit (mask head output · mask feature) by ``shift``:
    channel 0 of the ``features`` projection becomes the constant 1 and
    channel 0 of the ``head`` layer the constant ``-shift``."""
    W[features + ".weight"][0] = 0
    W[features + ".bias"][0] = 1
    W[head + ".weight"][0] = 0
    W[head + ".bias"][0] = -shift


def upper_tail(logits: torch.Tensor, share: float) -> float:
    """The value that ``share`` of ``logits`` exceed."""
    flat = logits.float().reshape(-1)
    k = max(int(share * flat.numel()), 1)
    return float(torch.topk(flat, k).values[-1])


def load(modules: Dict[str, torch.nn.Module], weights: Dict[str, torch.Tensor]) -> None:
    """Hand the weights to the program's modules (their own tensors are
    dropped), frozen."""
    for g, m in modules.items():
        prefix = g + "."
        m.load_state_dict({k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)},
                          strict=True, assign=True)
        m.requires_grad_(False)
