"""Mask-centric ops (counterpart of ``openpsg_tpu/ops/mask_ops.py``): mask
pooling (plain and chunked), pair OR-masks, resampling, and per-object
masks from an id map."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pair_or_masks(masks: torch.Tensor) -> torch.Tensor:
    """All ordered-pair unions of N masks: [N, P] → [N, N, P] with
    ``out[i, j] = masks[i] OR masks[j]`` (pair-major ``i * N + j``)."""
    a = masks[:, None, :]
    b = masks[None, :, :]
    if masks.dtype == torch.bool:
        return a | b
    return torch.maximum(a, b)


def downsample_mask_bilinear(
    masks: torch.Tensor, out_hw, threshold: float = 0.5
) -> torch.Tensor:
    """Bilinear resize of binary masks [N, H, W] then ``> threshold``;
    half-pixel centres, no antialiasing (the JAX version passes
    ``antialias=False``)."""
    resized = F.interpolate(
        masks.float()[:, None], size=tuple(out_hw), mode="bilinear",
        align_corners=False, antialias=False,
    )[:, 0]
    return resized > threshold


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    # jax.image.resize 'nearest': floor((i + 0.5) * in / out), in float32
    # (torch's 'nearest-exact' rule; plain 'nearest' floors i * in / out)
    off = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
    return torch.floor(off * n_in / n_out).to(torch.long)


def downsample_nearest(idmap: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest-neighbour resize of an integer or boolean map [..., H, W] →
    [..., h, w] (leading dims untouched, as ``jax.image.resize`` treats a
    dim whose size does not change)."""
    H, W = idmap.shape[-2:]
    h, w = out_hw
    out = idmap
    if h != H:
        out = out[..., _nearest_index(H, h, idmap.device), :]
    if w != W:
        out = out[..., _nearest_index(W, w, idmap.device)]
    return out


def mask_pool(features: torch.Tensor, masks: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Masked average pool: features [C, H, W], masks [N, H, W] (bool or
    {0, 1}) → [N, C].  An empty mask gives the zero vector."""
    m = masks.to(features.dtype)
    num = torch.einsum("chw,nhw->nc", features, m)
    den = m.sum(dim=(1, 2))[:, None]
    return num / torch.clamp(den, min=eps)


def mask_pool_chunked(features: torch.Tensor, masks: torch.Tensor, size: int) -> torch.Tensor:
    """The reference's ``_mask_pooling(output_size=S)``: features [C, H, W],
    masks [N, H, W] → [N, S, C] object tokens.

    The masked pixels (``mask >= 0.5``) in row-major order split into S
    contiguous chunks, the first ``n % S`` one pixel longer, each chunk
    averaged; with ``0 < n < S`` token k is the pixel of rank ``k % n``;
    an empty mask gives zero tokens.  Each pixel's chunk comes from its
    rank (a cumulative sum), so the pooling is one [C, P] x [P, S] product
    per object."""
    if size == 1:
        return mask_pool(features, masks)[:, None, :]
    C = features.shape[0]
    flat = features.reshape(C, -1)                              # [C, P]
    m = (masks >= 0.5).reshape(masks.shape[0], -1)              # [N, P]
    ks = torch.arange(size, device=features.device)
    n = m.sum(dim=1, keepdim=True)                              # [N, 1]
    r0 = torch.cumsum(m.to(torch.int64), dim=1) - 1             # pixel rank
    base, rem = n // size, n % size
    big = torch.where(
        r0 < rem * (base + 1),
        torch.div(r0, torch.clamp(base + 1, min=1), rounding_mode="floor"),
        rem + torch.div(r0 - rem * (base + 1), torch.clamp(base, min=1),
                        rounding_mode="floor"),
    )
    w_big = m[..., None] & (big[..., None] == ks)
    w_small = m[..., None] & ((ks % torch.clamp(n, min=1)[..., None]) == r0[..., None])
    w = torch.where((n >= size)[..., None], w_big, w_small).to(features.dtype)  # [N, P, S]
    num = torch.einsum("cp,nps->nsc", flat, w)
    den = w.sum(dim=1)[:, :, None]
    return num / torch.clamp(den, min=1.0)


def masks_from_idmap(idmap: torch.Tensor, object_ids: torch.Tensor) -> torch.Tensor:
    """Per-object boolean masks from a panoptic id map: idmap [h, w],
    object_ids [N] → [N, h, w] (one broadcast compare)."""
    return idmap[None, :, :] == object_ids[:, None, None]
