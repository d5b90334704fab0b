"""Swin Transformer backbone (counterpart of
``openpsg_tpu/models/segmenter/swin.py``).  Single image, [H, W, C] layout;
outputs maps at strides 4, 8, 16, 32."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from openpsg_tpu_torch.models.common import LayerNorm, conv_hwc, device_constant, mm_f32


@device_constant
def rel_pos_index(window: int) -> np.ndarray:
    """[win⁴] flat index into the (2w-1)² relative position bias table
    ([win², win²] row-major)."""
    coords = np.stack(
        np.meshgrid(np.arange(window), np.arange(window), indexing="ij")
    ).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int64).reshape(-1)


@device_constant
def shift_mask(Hp: int, Wp: int, w: int, s: int) -> np.ndarray:
    """Additive mask [nW, w², w²] separating the 9 shifted-window regions."""
    img = np.zeros((Hp, Wp), np.int32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -s), slice(-s, None)):
        for ws in (slice(0, -w), slice(-w, -s), slice(-s, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(Hp // w, w, Wp // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    diff = win[:, None, :] != win[:, :, None]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.dim, self.num_heads, self.window = dim, num_heads, window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_bias = nn.Parameter(torch.empty((2 * window - 1) ** 2, num_heads))

    def init_extra(self, gen):
        self.rel_pos_bias.normal_(0.0, 0.02, generator=gen).clamp_(-0.04, 0.04)

    def forward(self, x, attn_mask=None):
        """x: [nW, win², C]; attn_mask: [nW, win², win²] additive or None."""
        nW, L, C = x.shape
        nh = self.num_heads
        hd = C // nh
        qkv = self.qkv(x).reshape(nW, L, 3, nh, hd)
        q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.unbind(2))
        attn = mm_f32(q * hd ** -0.5, k, "whld,whmd->whlm")
        bias = self.rel_pos_bias[rel_pos_index(self.window, x.device)].reshape(L, L, nh)
        attn = attn + bias.permute(2, 0, 1)[None].float()
        if attn_mask is not None:
            attn = attn + attn_mask[:, None]
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.einsum("whlm,whmd->whld", attn, v).permute(0, 2, 1, 3)
        return self.proj(out.reshape(nW, L, C))


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, window, shift, mlp_ratio=4.0):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        H, W, C = x.shape
        w, s = self.window, self.shift
        pad_h, pad_w = (-H) % w, (-W) % w
        Hp, Wp = H + pad_h, W + pad_w
        h = F.pad(self.norm1(x), (0, 0, 0, pad_w, 0, pad_h))
        mask = None
        if s > 0:
            h = torch.roll(h, (-s, -s), dims=(0, 1))
            mask = shift_mask(Hp, Wp, w, s, x.device)
        h = h.reshape(Hp // w, w, Wp // w, w, C).permute(0, 2, 1, 3, 4)
        h = self.attn(h.reshape(-1, w * w, C), mask)
        h = h.reshape(Hp // w, Wp // w, w, w, C).permute(0, 2, 1, 3, 4)
        h = h.reshape(Hp, Wp, C)
        if s > 0:
            h = torch.roll(h, (s, s), dims=(0, 1))
        x = x + h[:H, :W]
        h = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none"))
        return x + h


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        Hp, Wp = H + H % 2, W + W % 2
        x = x.reshape(Hp // 2, 2, Wp // 2, 2, C)
        x = torch.cat(
            [x[:, 0, :, 0], x[:, 1, :, 0], x[:, 0, :, 1], x[:, 1, :, 1]], dim=-1
        )
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 patch_size: int = 4):
        super().__init__()
        self.depths, self.patch_size = tuple(depths), patch_size
        # flax 'SAME' pads nothing for a stride-p p×p conv on a ÷p input
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.patch_norm = LayerNorm(embed_dim, eps=1e-5)
        dim = embed_dim
        for stage, depth in enumerate(self.depths):
            for blk in range(depth):
                self.add_module(
                    f"stage{stage}_block{blk}",
                    SwinBlock(dim, num_heads[stage], window,
                              shift=0 if blk % 2 == 0 else window // 2),
                )
            self.add_module(f"out_norm{stage}", LayerNorm(dim, eps=1e-5))
            if stage < len(self.depths) - 1:
                self.add_module(f"merge{stage}", PatchMerging(dim))
                dim *= 2

    def forward(self, image) -> Tuple[torch.Tensor, ...]:
        """image: [H, W, 3] → tuple of [H/4·2^-i, W/4·2^-i, C·2^i] maps."""
        H, W, _ = image.shape
        if H % self.patch_size or W % self.patch_size:
            raise ValueError(f"image {H}x{W} not divisible by {self.patch_size}")
        x = self.patch_norm(conv_hwc(self.patch_embed, image))
        outs = []
        for stage, depth in enumerate(self.depths):
            for blk in range(depth):
                x = getattr(self, f"stage{stage}_block{blk}")(x)
            outs.append(getattr(self, f"out_norm{stage}")(x))
            if stage < len(self.depths) - 1:
                x = getattr(self, f"merge{stage}")(x)
        return tuple(outs)
