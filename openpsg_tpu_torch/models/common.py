"""Layers shared by the port's models, and its seeded random init.

Parameter names mirror the flax modules of the JAX package (``kernel`` →
``weight`` and so on, see :mod:`openpsg_tpu_torch.bridge`), so that every
leaf of the JAX tree has exactly one home here.
"""

from __future__ import annotations

import math

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


def mm_f32(a: torch.Tensor, b: torch.Tensor, eq: str) -> torch.Tensor:
    """einsum with float32 products and sums (``preferred_element_type=
    float32`` in the JAX package)."""
    return torch.einsum(eq, a.float(), b.float())


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
