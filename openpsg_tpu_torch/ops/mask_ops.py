"""Mask-centric ops (counterpart of ``openpsg_tpu/ops/mask_ops.py:86-117``)."""

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
