"""Llama-family decoder, bf16 dense path (counterpart of
``openpsg_tpu/models/llm/llama.py``): RMSNorm, rotate-half RoPE, grouped-
query attention, SwiGLU.  A forward without a cache attends among its own
tokens (prefill) and returns their (k, v); a forward with a cache reads it
as read-only keys plus the current tokens' own keys, then writes those keys
into the cache in place (the JAX version returns an updated copy)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from openpsg_tpu_torch.models.common import mm_f32


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_hidden: int = 11008
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def llama2_7b(dtype=torch.bfloat16) -> "LlamaConfig":
        return LlamaConfig(dtype=dtype)

    @staticmethod
    def tiny_test(vocab_size: int = 128) -> "LlamaConfig":
        return LlamaConfig(vocab_size=vocab_size, dim=64, n_layers=2, n_heads=4,
                           n_kv_heads=2, ffn_hidden=128, dtype=torch.float32)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))

    def init_extra(self, gen):
        self.weight.fill_(1.0)

    def forward(self, x):
        x32 = x.float()
        normed = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return (normed * self.weight.float()).to(x.dtype)


def rope_tables(positions: torch.Tensor, hd: int, theta: float):
    """cos, sin [B, L, 1, hd/2] of the rotary angles (computed once per
    forward and shared by every layer)."""
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=positions.device) / hd))
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[:, :, None], torch.sin(angles)[:, :, None]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half rotary embedding of x [B, L, H, hd], in float32."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x [B, L, H, hd]; positions [B, L]."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


class LlamaBlock(nn.Module):
    def __init__(self, c: LlamaConfig):
        super().__init__()
        self.c = c
        hd = c.dim // c.n_heads
        self.attn_norm = RMSNorm(c.dim, c.norm_eps)
        self.wq = nn.Linear(c.dim, c.n_heads * hd, bias=False)
        self.wk = nn.Linear(c.dim, c.n_kv_heads * hd, bias=False)
        self.wv = nn.Linear(c.dim, c.n_kv_heads * hd, bias=False)
        self.wo = nn.Linear(c.n_heads * hd, c.dim, bias=False)
        self.ffn_norm = RMSNorm(c.dim, c.norm_eps)
        self.w_gate = nn.Linear(c.dim, c.ffn_hidden, bias=False)
        self.w_up = nn.Linear(c.dim, c.ffn_hidden, bias=False)
        self.w_down = nn.Linear(c.ffn_hidden, c.dim, bias=False)

    def forward(self, x, rot, masked_out, ck, cv):
        """x [B, L, D]; rot = rope_tables(positions); ck/cv [B, S, kv, hd]
        read-only (S may be 0); masked_out [B, 1, L, S + L] is True where a
        query may NOT see a key ([cache ; current]) → (x, k, v of the
        current tokens)."""
        c = self.c
        B, L, _ = x.shape
        hd = c.dim // c.n_heads
        h = self.attn_norm(x)
        q = apply_rope(self.wq(h).reshape(B, L, c.n_heads, hd), *rot)
        k = apply_rope(self.wk(h).reshape(B, L, c.n_kv_heads, hd), *rot)
        v = self.wv(h).reshape(B, L, c.n_kv_heads, hd)
        rep = c.n_heads // c.n_kv_heads
        expand = (lambda t: t.repeat_interleave(rep, dim=2)) if rep > 1 else (lambda t: t)
        s_cache = mm_f32(q, expand(ck.to(q.dtype)), "blhd,bmhd->bhlm")
        s_cur = mm_f32(q, expand(k), "blhd,bmhd->bhlm")
        attn = torch.cat([s_cache, s_cur], dim=-1) * (hd ** -0.5)
        attn = torch.softmax(attn.masked_fill(masked_out, -1e9), dim=-1).to(x.dtype)
        S = ck.shape[1]
        out = (torch.einsum("bhlm,bmhd->blhd", attn[..., :S], expand(cv.to(v.dtype)))
               + torch.einsum("bhlm,bmhd->blhd", attn[..., S:], expand(v)))
        x = x + self.wo(out.reshape(B, L, c.n_heads * hd))
        h = self.ffn_norm(x)
        down = self.w_down(F.silu(self.w_gate(h)) * self.w_up(h))
        return x + down, k, v


class Llama(nn.Module):
    def __init__(self, c: LlamaConfig):
        super().__init__()
        self.c = c
        self.layers = nn.ModuleList(LlamaBlock(c) for _ in range(c.n_layers))
        self.final_norm = RMSNorm(c.dim, c.norm_eps)
        self.lm_head = nn.Linear(c.dim, c.vocab_size, bias=False)

    def forward(self, input_embeds, attention_mask, positions,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache_index: int = 0, key_positions=None, last_logit_only=False):
        """input_embeds [B, L, D]; attention_mask [B, S] over keys;
        positions [B, L].  Without ``cache``: causal attention among the L
        tokens, returns (logits, (k, v) stacked [n_layers, B, L, kv, hd]).
        With ``cache`` ([n_layers, B, S, kv, hd] each) and ``key_positions``
        [B, S]: the current tokens' slots [cache_index, cache_index + L)
        take keys from this call; those keys are written into ``cache`` in
        place, which is returned."""
        c = self.c
        B, L, _ = input_embeds.shape
        hd = c.dim // c.n_heads
        dev = input_embeds.device
        if cache is None:
            kp = positions if key_positions is None else key_positions
            mask_cur = (kp[:, None, :] <= positions[:, :, None]) & attention_mask[:, None, :]
            mask_cache = torch.zeros(B, L, 0, dtype=torch.bool, device=dev)
            empty = torch.zeros(B, 0, c.n_kv_heads, hd, dtype=c.dtype, device=dev)
        else:
            if key_positions is None:
                raise ValueError("the cache path needs key_positions")
            S = cache[0].shape[2]
            base = key_positions[:, None, :] <= positions[:, :, None]
            mask_cur = positions[:, None, :] <= positions[:, :, None]
            slot = torch.arange(S, device=dev)[None, None, :]
            in_cur = (slot >= cache_index) & (slot < cache_index + L)
            mask_cache = base & attention_mask[:, None, :] & ~in_cur
            cur_valid = attention_mask[:, cache_index:cache_index + L]
            mask_cur = mask_cur & cur_valid[:, None, :]
        x = input_embeds.to(c.dtype)
        rot = rope_tables(positions, hd, c.rope_theta)
        masked_out = ~torch.cat([mask_cache, mask_cur], dim=-1)[:, None]
        ks, vs = [], []
        for i, layer in enumerate(self.layers):
            ck, cv = (empty, empty) if cache is None else (cache[0][i], cache[1][i])
            x, k, v = layer(x, rot, masked_out, ck, cv)
            if cache is None:
                ks.append(k)
                vs.append(v)
            else:
                cache[0][i, :, cache_index:cache_index + L] = k
                cache[1][i, :, cache_index:cache_index + L] = v
        new_cache = (torch.stack(ks), torch.stack(vs)) if cache is None else cache
        x = self.final_norm(x)
        if last_logit_only:
            x = x[:, -1:]
        return self.lm_head(x).float(), new_cache


class LlamaWithEmbeddings(nn.Module):
    def __init__(self, c: LlamaConfig):
        super().__init__()
        self.cfg = c
        self.tok_embed = nn.Embedding(c.vocab_size, c.dim)
        self.core = Llama(c)

    def embed(self, token_ids):
        return self.tok_embed(token_ids)

    def forward(self, *, input_embeds=None, token_ids=None, **kw):
        if input_embeds is None:
            input_embeds = self.tok_embed(token_ids)
        return self.core(input_embeds, **kw)
