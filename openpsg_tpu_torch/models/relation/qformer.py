"""Relation Q-Former (InstructBLIP-style), batched over object pairs
(counterpart of ``openpsg_tpu/models/relation/qformer.py``).

Self-attention runs over [queries ; instruction tokens]; cross-attention
and a separate query FFN apply to the query positions only.  The
cross-attention keys/values are the image patches, shared by every pair;
only the pair's OR-mask differs, which is what the shared-KV CUDA kernel
(:mod:`openpsg_tpu_torch.ops.flash_cross_attn`) exploits.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from openpsg_tpu_torch.models.common import LayerNorm, mm_f32
from openpsg_tpu_torch.ops.flash_cross_attn import (
    flash_shared_kv_cross_attn,
    guard_empty_mask,
    shared_kv_cross_attn_plain,
)

def _shared_kv_attention(q, k, v, mask, plain: bool = False):
    """q [B, H, Lq, hd]; k/v [H, P, hd]; mask [B, P] → [B, H, Lq, hd].

    All-false mask rows are guarded before either path (the kernel would
    give 0 and the plain softmax the mean of V; the kernel's wrapper guards
    its own input).  ``plain=True`` forces the plain PyTorch version on any
    device; it is a test-only switch."""
    if plain:
        return shared_kv_cross_attn_plain(q, k, v, guard_empty_mask(mask))
    return flash_shared_kv_cross_attn(q, k, v, mask)


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    hidden_size: int = 768
    num_layers: int = 2
    num_heads: int = 12
    intermediate: int = 3072
    encoder_hidden_size: int = 256
    num_relation_queries: int = 32
    vocab_size: int = 1024
    max_text_len: int = 16
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny_test() -> "QFormerConfig":
        return QFormerConfig(
            hidden_size=32, num_layers=2, num_heads=2, intermediate=64,
            encoder_hidden_size=16, num_relation_queries=4, vocab_size=64,
            max_text_len=8,
        )


class _MHA(nn.Module):
    """Multi-head attention with boolean masking (-1e9 fill)."""

    def __init__(self, dim: int, kv_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(kv_dim, dim)
        self.v = nn.Linear(kv_dim, dim)
        self.o = nn.Linear(dim, dim)

    def forward(self, q_in, kv_in, mask):
        """q_in [B, Lq, D]; kv_in [B, Lk, Dk]; mask [B, Lq, Lk] bool."""
        B, Lq, D = q_in.shape
        H = self.num_heads
        hd = D // H
        q = self.q(q_in).reshape(B, Lq, H, hd).transpose(1, 2)
        k = self.k(kv_in).reshape(B, -1, H, hd).transpose(1, 2)
        v = self.v(kv_in).reshape(B, -1, H, hd).transpose(1, 2)
        attn = mm_f32(q, k, "bhqd,bhkd->bhqk") * (hd ** -0.5)
        attn = attn.masked_fill(~mask[:, None], -1e9)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        return self.o(out.transpose(1, 2).reshape(B, Lq, D))


class _SharedKVCrossAttention(nn.Module):
    """Cross-attention where every batch row attends to the SAME key/value
    sequence under its own boolean mask: K/V are projected once ([P, D])."""

    def __init__(self, dim: int, kv_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(kv_dim, dim)
        self.v = nn.Linear(kv_dim, dim)
        self.o = nn.Linear(dim, dim)

    def forward(self, q_in, kv_shared, mask, plain: bool = False):
        """q_in [B, Lq, D]; kv_shared [P, Dk]; mask [B, P] bool."""
        B, Lq, D = q_in.shape
        H = self.num_heads
        hd = D // H
        P = kv_shared.shape[0]
        q = self.q(q_in).reshape(B, Lq, H, hd).transpose(1, 2).contiguous()
        k = self.k(kv_shared).reshape(P, H, hd).transpose(0, 1).contiguous()
        v = self.v(kv_shared).reshape(P, H, hd).transpose(0, 1).contiguous()
        out = _shared_kv_attention(q, k, v, mask.contiguous(), plain=plain)
        return self.o(out.transpose(1, 2).reshape(B, Lq, D))


class RelationQFormer(nn.Module):
    def __init__(self, cfg: QFormerConfig):
        super().__init__()
        c = self.cfg = cfg
        D = c.hidden_size
        self.word_embed = nn.Embedding(c.vocab_size, D)
        self.pos_embed = nn.Parameter(torch.empty(c.max_text_len, D))
        self.embed_ln = LayerNorm(D, eps=1e-12)
        for i in range(c.num_layers):
            self.add_module(f"self_attn{i}", _MHA(D, D, c.num_heads))
            self.add_module(f"self_ln{i}", LayerNorm(D, eps=1e-12))
            self.add_module(f"cross_attn{i}",
                            _SharedKVCrossAttention(D, c.encoder_hidden_size, c.num_heads))
            self.add_module(f"cross_ln{i}", LayerNorm(D, eps=1e-12))
            for part in ("q", "t"):
                self.add_module(f"ffn_{part}_up{i}", nn.Linear(D, c.intermediate))
                self.add_module(f"ffn_{part}_down{i}", nn.Linear(c.intermediate, D))
                self.add_module(f"ffn_{part}_ln{i}", LayerNorm(D, eps=1e-12))

    def init_extra(self, gen):
        self.pos_embed.normal_(0.0, 0.02, generator=gen)

    def _ffn(self, part: str, i: int, x):
        h = getattr(self, f"ffn_{part}_up{i}")(x)
        h = getattr(self, f"ffn_{part}_down{i}")(F.gelu(h, approximate="none"))
        return getattr(self, f"ffn_{part}_ln{i}")(x + h)

    def forward(self, query_embeds, text_ids, text_mask, encoder_hidden,
                encoder_mask, plain_attention: bool = False):
        """query_embeds [B, Q, D]; text_ids/text_mask [B, T]; encoder_hidden
        [P, De] (shared by all pairs); encoder_mask [B, P] → [B, Q, D]."""
        B, Qn, _ = query_embeds.shape
        T = text_ids.shape[1]
        dtype = self.word_embed.weight.dtype
        tok = self.word_embed(text_ids) + self.pos_embed[None, :T].to(dtype)
        x = self.embed_ln(torch.cat([query_embeds.to(dtype), tok], dim=1))
        seq_mask = torch.cat(
            [torch.ones(B, Qn, dtype=torch.bool, device=x.device), text_mask], dim=1)
        self_mask = seq_mask[:, None, :] & seq_mask[:, :, None]
        enc = encoder_hidden.to(dtype)
        for i in range(self.cfg.num_layers):
            h = getattr(self, f"self_attn{i}")(x, x, self_mask)
            x = getattr(self, f"self_ln{i}")(x + h)
            xq = x[:, :Qn]
            hq = getattr(self, f"cross_attn{i}")(xq, enc, encoder_mask, plain=plain_attention)
            xq = getattr(self, f"cross_ln{i}")(xq + hq)
            xq = self._ffn("q", i, xq)
            xt = self._ffn("t", i, x[:, Qn:])
            x = torch.cat([xq, xt], dim=1)
        return x[:, :Qn]
