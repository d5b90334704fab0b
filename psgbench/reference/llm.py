"""Plain float32 reference of a Llama-architecture decoder (Mistral-7B-v0.1
at its published sizes): RMSNorm, rotate-half RoPE, grouped-query causal
attention, SwiGLU.  No cache: one causal forward over the prefix and the
served tokens, layer by layer, each layer's weights widened to float32
only while it runs.  Mistral's 4096-token sliding window is the full
causal window at these lengths."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from psgbench.reference.prec import Prec


def rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x, pos, theta):
    """x [B, L, H, hd], pos [B, L]."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device).float() / hd)
    ang = pos[..., None].float() * freqs
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def forward(pr: Prec, W, x, key_valid, pos, cfg, out_at, prefix="llm."):
    """x [B, L, D] input embeddings; key_valid [B, L]; pos [B, L] RoPE
    positions; a query sees a valid key at a position not after its own.
    → float32 logits [B, len(out_at), vocab] at the rows ``out_at``."""
    B, L, D = x.shape
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = D // H
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    see = (pos[:, None, :] <= pos[:, :, None]) & key_valid[:, None, :]
    x = x.float()
    for i in range(cfg["num_hidden_layers"]):
        g = lambda n: W[f"{prefix}core.layers.{i}.{n}"]
        h = rms(x, g("attn_norm.weight"), eps)
        q = rope(pr.linear(h, g("wq.weight").float()).reshape(B, L, H, hd), pos, theta)
        k = rope(pr.linear(h, g("wk.weight").float()).reshape(B, L, KV, hd), pos, theta)
        v = pr.linear(h, g("wv.weight").float()).reshape(B, L, KV, hd)
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
        s = pr.einsum("blhd,bmhd->bhlm", q, k) * hd ** -0.5
        a = torch.softmax(s.masked_fill(~see[:, None], float("-inf")), -1)
        a = torch.nan_to_num(a)  # a padding query that sees no key
        o = pr.einsum("bhlm,bmhd->blhd", a, v).reshape(B, L, H * hd)
        x = x + pr.linear(o, g("wo.weight").float())
        h = rms(x, g("ffn_norm.weight"), eps)
        act = F.silu(pr.linear(h, g("w_gate.weight").float())) * pr.linear(h, g("w_up.weight").float())
        x = x + pr.linear(act, g("w_down.weight").float())
    x = rms(x[:, out_at], W[prefix + "core.final_norm.weight"], eps)
    return pr.linear(x, W[prefix + "core.lm_head.weight"].float())


def served_logits(pr: Prec, W, prefix_embeds, prefix_mask, tokens, cfg, prefix="llm."):
    """The logits that chose each served token: the prefix [B, Lp, D] and
    its mask (right-aligned), then the served tokens [B, T] fed back.
    → [B, T, vocab]: row t is the distribution token t was picked from."""
    B, Lp, _ = prefix_embeds.shape
    T = tokens.shape[1]
    dev = prefix_embeds.device
    emb = W[prefix + "tok_embed.weight"]
    fed = emb[tokens[:, : T - 1].long()].float()
    x = torch.cat([prefix_embeds.float(), fed], 1)
    ppos = torch.clamp(torch.cumsum(prefix_mask.long(), 1) - 1, min=0)
    n_real = prefix_mask.long().sum(1, keepdim=True)
    gpos = n_real + torch.arange(T - 1, device=dev)[None]
    pos = torch.cat([ppos, gpos], 1)
    valid = torch.cat([prefix_mask.bool(), torch.ones(B, T - 1, dtype=torch.bool, device=dev)], 1)
    out_at = torch.arange(Lp - 1, Lp + T - 1, device=dev)
    return forward(pr, W, x, valid, pos, cfg, out_at, prefix)
