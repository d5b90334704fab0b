"""Multi-scale deformable attention in plain PyTorch.

Counterpart of ``openpsg_tpu/ops/deform_attn.py`` (``_ms_deform_attn_flat``,
:125-213).  That op is XLA in the JAX package, not Pallas; a fused Hopper
kernel for it is later work.  Semantics kept exactly:

* each sample is a bilinear read from a "quad" row (the 2×2 corner
  neighbourhood) at the border-clipped base ``(by, bx)``, weighted by tent
  functions — equivalent to zero padding outside the map;
* ``points_per_level`` reads only the first K_l of the K points on level l.

Per level, the K_l points of all queries and heads are gathered at once and
reduced in float32 (the JAX version accumulates per (level, point) in f32).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def ms_deform_attn(
    value: torch.Tensor,                # [B, Lv, nH, hd]
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,   # [B, Lq, nH, L, K, 2] in [0, 1]
    attention_weights: torch.Tensor,    # [B, Lq, nH, L, K]
    points_per_level: Optional[Tuple[int, ...]] = None,
) -> torch.Tensor:                      # [B, Lq, nH * hd], value's dtype
    B, Lv, nH, hd = value.shape
    Lq, L, K = sampling_locations.shape[1], sampling_locations.shape[3], sampling_locations.shape[4]
    if L != len(spatial_shapes):
        raise ValueError(f"{L} levels in locations, {len(spatial_shapes)} shapes")
    if sum(h * w for h, w in spatial_shapes) != Lv:
        raise ValueError(f"spatial shapes {spatial_shapes} != Lv {Lv}")
    kpl = tuple(int(k) for k in points_per_level) if points_per_level else (K,) * L
    if len(kpl) != L or not all(0 < k <= K for k in kpl):
        raise ValueError(f"points_per_level {points_per_level}")

    out = torch.zeros(B, nH, Lq, hd, dtype=torch.float32, device=value.device)
    for lvl in range(L):
        quad, idx, cw = level_samples(value, spatial_shapes, sampling_locations,
                                      attention_weights, lvl, kpl[lvl])
        g = torch.gather(quad, 2, idx[..., None].expand(-1, -1, -1, 4 * hd))  # [B,nH,Lq*kl,4hd]
        g = g.view(B, nH, Lq, kpl[lvl], 4, hd).float()
        out += torch.einsum("bhqkcd,bhqkc->bhqd", g, cw)
    return out.permute(0, 2, 1, 3).reshape(B, Lq, nH * hd).to(value.dtype)


def level_samples(value, spatial_shapes, sampling_locations, attention_weights,
                  lvl: int, kl: int):
    """Level ``lvl``'s share of :func:`ms_deform_attn` for the first ``kl``
    points → (quad [B, nH, h·w, 4·hd] in value's dtype, idx [B, nH, Lq·kl]
    int64 quad rows, query-major then point, cw [B, nH, Lq, kl, 4] float32
    corner × attention weights).  The level's sampling is the row gather
    ``quad[b, h, idx[b, h]]`` (the op of ``ops/msda_gather.py``)."""
    h, w = spatial_shapes[lvl]
    start = sum(hh * ww for hh, ww in spatial_shapes[:lvl])
    B, _, nH, _ = value.shape
    Lq = sampling_locations.shape[1]
    vl = value[:, start:start + h * w].permute(0, 2, 1, 3)   # [B,nH,hw,hd]
    # quad row r = values at r, r+1, r+w, r+w+1 (wrapping within the
    # level as jnp.roll does; wrapped corners get zero tent weight)
    quad = torch.cat([vl, vl.roll(-1, 2), vl.roll(-w, 2), vl.roll(-(w + 1), 2)], dim=-1)
    loc = sampling_locations[:, :, :, lvl, :kl].float()      # [B,Lq,nH,kl,2]
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    bx = torch.clamp(torch.floor(x), 0, max(w - 2, 0))
    by = torch.clamp(torch.floor(y), 0, max(h - 2, 0))
    fx0 = torch.clamp(1.0 - (x - bx).abs(), min=0.0)
    fx1 = torch.clamp(1.0 - (x - (bx + 1)).abs(), min=0.0)
    fy0 = torch.clamp(1.0 - (y - by).abs(), min=0.0)
    fy1 = torch.clamp(1.0 - (y - (by + 1)).abs(), min=0.0)
    aw = attention_weights[:, :, :, lvl, :kl].float()
    cw = torch.stack([fx0 * fy0, fx1 * fy0, fx0 * fy1, fx1 * fy1], dim=-1) * aw[..., None]
    idx = (by * w + bx).long().permute(0, 2, 1, 3).reshape(B, nH, Lq * kl)
    return quad, idx, cw.permute(0, 2, 1, 3, 4)
