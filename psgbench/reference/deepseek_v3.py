"""Plain float32 reference of a DeepSeek-V3-architecture decoder
(Moonlight-16B-A3B at its published sizes; HF config keys), written from
the family's published modeling code: multi-head latent attention in its
expanded form, the dense SwiGLU of the first layers, then the expert
layers (sigmoid router with ``e_score_correction_bias`` for the choice
only, the chosen scores normalised and scaled, each routed expert's SwiGLU
on its tokens, the shared experts added).  No cache: one causal forward
over the prefix and the served tokens, layer by layer, each layer's
weights widened to float32 only while it runs.

Departures from the published model: ``n_group`` and ``topk_group`` are 1
(Moonlight's), so the group-limited choice is left out, as it changes
nothing there; the routed experts are read stacked, as the program holds
them (``experts.gate_up_proj`` [E, 2F, D], gate rows first;
``experts.down_proj`` [E, D, F]); ``routing`` can replace the choice by
the program's, so that the comparison follows the program's path through
the experts, while the weights are still the reference's own scores.

The same equations as the port's ``deepseek_v3_reference.py``, with every
product through :class:`~psgbench.reference.prec.Prec` (the float8
control); it imports neither the program nor JAX."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from psgbench.reference.llm import rms
from psgbench.reference.prec import Prec


def rope(x, pos, theta):
    """RoPE of x [B, L, H, d] at pos [B, L] with DeepSeek-V3's pairing: the
    adjacent pairs de-interleaved, then rotated by halves."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device).float() / d)
    ang = pos[..., None].float() * freqs
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def swiglu(pr: Prec, h, gate_up, down):
    """gate_up [2F, D] (gate rows first), down [D, F]."""
    gate, up = pr.linear(h, gate_up).chunk(2, -1)
    return pr.linear(F.silu(gate) * up, down)


def forward(pr: Prec, W, x, key_valid, pos, cfg, out_at,
            routing: Optional[Dict[int, torch.Tensor]] = None, prefix="llm."):
    """x [B, L, D] input embeddings; key_valid [B, L]; pos [B, L]; a query
    sees a valid key at a position not after its own.  ``routing``: {layer:
    [B, L, k] experts} in place of the reference's own choice.  → (float32
    logits [B, len(out_at), vocab] at the rows ``out_at``; {layer: float32
    choice scores [B, L, E], sigmoid plus bias, of each expert layer})."""
    B, L, D = x.shape
    H, R = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rp, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    eps, theta, k = cfg["rms_norm_eps"], cfg["rope_theta"], cfg["num_experts_per_tok"]
    scale = (nope + rp) ** -0.5
    see = (pos[:, None, :] <= pos[:, :, None]) & key_valid[:, None, :]
    x = x.float()
    choices = {}
    for i in range(cfg["num_hidden_layers"]):
        g = lambda n: W[f"{prefix}core.layers.{i}.{n}"].float()
        h = rms(x, g("input_layernorm.weight"), eps)
        q = pr.linear(h, g("self_attn.q_proj.weight")).reshape(B, L, H, nope + rp)
        lat, k_pe = pr.linear(h, g("self_attn.kv_a_proj_with_mqa.weight")).split([R, rp], -1)
        lat = rms(lat, g("self_attn.kv_a_layernorm.weight"), eps)
        kv = pr.linear(lat, g("self_attn.kv_b_proj.weight")).reshape(B, L, H, nope + vd)
        k_pe = rope(k_pe[:, :, None], pos, theta).expand(B, L, H, rp)
        qh = torch.cat([q[..., :nope], rope(q[..., nope:], pos, theta)], -1)
        kh = torch.cat([kv[..., :nope], k_pe], -1)
        s = pr.einsum("blhd,bmhd->bhlm", qh, kh) * scale
        a = torch.nan_to_num(torch.softmax(s.masked_fill(~see[:, None], float("-inf")), -1))
        o = pr.einsum("bhlm,bmhd->blhd", a, kv[..., nope:].contiguous()).reshape(B, L, H * vd)
        x = x + pr.linear(o, g("self_attn.o_proj.weight"))
        h = rms(x, g("post_attention_layernorm.weight"), eps)
        if i < cfg["first_k_dense_replace"]:
            gu = torch.cat([g("mlp.gate_proj.weight"), g("mlp.up_proj.weight")])
            x = x + swiglu(pr, h, gu, g("mlp.down_proj.weight"))
            continue
        scores = torch.sigmoid(pr.linear(h, g("mlp.gate.weight")))
        choice = scores + g("mlp.gate.e_score_correction_bias")
        choices[i] = choice
        idx = routing[i] if routing is not None else torch.topk(choice, k, dim=-1).indices
        w = scores.gather(-1, idx)
        if cfg["norm_topk_prob"]:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        w = w * cfg["routed_scaling_factor"]
        gu_all = W[f"{prefix}core.layers.{i}.mlp.experts.gate_up_proj"]
        down_all = W[f"{prefix}core.layers.{i}.mlp.experts.down_proj"]
        ffn = torch.zeros_like(x)
        for e in range(cfg["n_routed_experts"]):
            b, l, j = (idx == e).nonzero(as_tuple=True)
            if b.numel():
                y = swiglu(pr, h[b, l], gu_all[e].float(), down_all[e].float())
                ffn.index_put_((b, l), y * w[b, l, j][:, None], accumulate=True)
        sh = torch.cat([g("mlp.shared_experts.gate_proj.weight"),
                        g("mlp.shared_experts.up_proj.weight")])
        x = x + ffn + swiglu(pr, h, sh, g("mlp.shared_experts.down_proj.weight"))
    x = rms(x[:, out_at], W[prefix + "core.final_norm.weight"], eps)
    return pr.linear(x, W[prefix + "core.lm_head.weight"].float()), choices


def served_logits(pr: Prec, W, prefix_embeds, prefix_mask, tokens, cfg, routing=None,
                  prefix="llm."):
    """The logits that chose each served token: the prefix [B, Lp, D] and
    its mask (right-aligned), then the served tokens [B, T] fed back
    (``psgbench.reference.llm.served_logits``'s inputs).  ``routing``:
    {layer: [B, Lp + T - 1, k]}.  → ([B, T, vocab]: row t is the
    distribution token t was picked from; {layer: [B, Lp + T - 1, E]}
    choice scores)."""
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
    return forward(pr, W, x, valid, pos, cfg, out_at, routing, prefix)
