"""Layers shared by the port's models, and its seeded random init.

Parameter names mirror the flax modules of the JAX package (``kernel`` →
``weight`` and so on, see :mod:`openpsg_tpu_torch.bridge`), so that every
leaf of the JAX tree has exactly one home here.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in float32 and returned in the input's dtype (flax
    normalizes in at least float32)."""

    def forward(self, x):
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.eps,
        ).to(x.dtype)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32) over one [H, W, C] map, in float32 (two-pass variance,
    as torch and the JAX package's ``_gn32`` compute it)."""

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=1e-5)

    def forward(self, x):
        y = F.group_norm(
            x.permute(2, 0, 1)[None].float(), self.num_groups,
            self.weight.float(), self.bias.float(), self.eps,
        )
        return y[0].permute(1, 2, 0).to(x.dtype)


def conv_hwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply a Conv2d to one [H, W, C] map (the JAX package's layout)."""
    y = conv(x.permute(2, 0, 1)[None].to(conv.weight.dtype))
    return y[0].permute(1, 2, 0)


def device_constant(build):
    """``build(*key)`` (numpy arrays, or a tuple of them) as tensors on a
    device, made once per (key, device) and cached: ``f(*key, device)``.
    The same arithmetic as a per-call ``torch.from_numpy(...).to(device)``,
    so the same bits, but a call at a key seen before copies nothing from
    the host and waits for nothing (a CUDA graph of the call needs that).
    Made outside inference mode, so a cached tensor serves every later
    call, those that take gradients included; never written in place."""

    @functools.lru_cache(maxsize=64)
    def on(*key_and_device):
        *key, device = key_and_device
        made = build(*key)
        with torch.inference_mode(False):
            if isinstance(made, tuple):
                return tuple(torch.from_numpy(np.asarray(a)).to(device) for a in made)
            return torch.from_numpy(np.asarray(made)).to(device)

    on.__doc__ = build.__doc__
    return on


def mm_f32(a: torch.Tensor, b: torch.Tensor, eq: str) -> torch.Tensor:
    """The two-operand einsum ``eq`` with exact products summed in float32
    (the JAX package's ``preferred_element_type=float32``), for the whole
    port.  The rule: on CUDA, with both operands in one 16-bit dtype and no
    gradient needed, one ``torch.bmm(..., out_dtype=float32)`` planned
    from ``eq`` (:func:`bmm_einsum`); else (the CPU, float32 operands, a
    gradient: ``out_dtype`` has neither a CPU kernel nor a derivative)
    both operands widened to float32."""
    if (a.is_cuda and a.dtype == b.dtype and a.dtype in (torch.bfloat16, torch.float16)
            and not (torch.is_grad_enabled() and (a.requires_grad or b.requires_grad))):
        return bmm_einsum(a, b, eq, out_dtype=torch.float32)
    return torch.einsum(eq, a.float(), b.float())


def bmm_einsum(a: torch.Tensor, b: torch.Tensor, eq: str, **bmm_kw) -> torch.Tensor:
    """``eq`` planned as one ``torch.bmm(A, B, **bmm_kw)``: the batch dims
    are the indices in both operands and the output, the contracted dims
    those in both operands only, each operand's free dims those it shares
    with the output only; permute and reshape in, view and permute out."""
    ins, out = eq.split("->")
    ia, ib = ins.split(",")
    batch = [i for i in out if i in ia and i in ib]
    red = [i for i in ia if i in ib and i not in out]
    fa, fb = [i for i in ia if i not in ib], [i for i in ib if i not in ia]
    size = {**dict(zip(ia, a.shape)), **dict(zip(ib, b.shape))}
    n = lambda idx: math.prod(size[i] for i in idx)
    A = a.permute([ia.index(i) for i in batch + fa + red]).reshape(n(batch), n(fa), n(red))
    B = b.permute([ib.index(i) for i in batch + red + fb]).reshape(n(batch), n(red), n(fb))
    y = torch.bmm(A, B, **bmm_kw).view([size[i] for i in batch + fa + fb])
    return y.permute([(batch + fa + fb).index(i) for i in out])


@torch.no_grad()
def init_params(root: nn.Module, gen: torch.Generator) -> None:
    """Seeded random init in the spirit of flax's defaults: LeCun-normal
    dense and conv kernels, zero biases, unit norms, N(0, 1) embeddings.
    Modules with special parameters define ``init_extra(gen)``, called last."""
    for m in root.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=gen)
    for m in root.modules():
        if hasattr(m, "init_extra"):
            m.init_extra(gen)
