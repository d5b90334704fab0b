"""Plain float32 reference of a DeepSeek-V3-architecture decoder
(Moonlight-16B-A3B at its published sizes; HF config keys), written from
the family's published modeling code: no cache, no batching of experts, no
kernels; plain ``torch`` operations, TF32 off (:func:`strict_f32`).  It
imports nothing of the port, so it checks the port's decoder
(``deepseek_v3.py``) from outside.

One causal forward over the given embeddings, layer by layer:

* RMSNorm, then MLA in its expanded form: ``q = q_proj(h)`` split per head
  into nope and rope parts; ``kv_a_proj_with_mqa(h)`` gives the latent
  (normed by ``kv_a_layernorm``) and one shared ``k_pe``;
  ``kv_b_proj(latent)`` gives ``k_nope`` and ``v`` per head; RoPE on the
  rope parts with adjacent pairs de-interleaved, then rotated by halves;
  softmax scale ``(qk_nope_head_dim + qk_rope_head_dim) ** -0.5``;
* RMSNorm, then a dense SwiGLU (layers before ``first_k_dense_replace``)
  or the expert layer: ``sigmoid`` scores of the router, the choice the top
  ``num_experts_per_tok`` of scores plus ``e_score_correction_bias``, the
  weights the chosen scores normalised and times
  ``routed_scaling_factor``; each expert's SwiGLU on its tokens, summed
  with those weights; the shared experts' SwiGLU added.

Departures from the published model: ``n_group`` and ``topk_group`` are 1
(Moonlight's), so the group-limited choice is left out, as it changes
nothing there; the routed experts are held stacked as the port holds them
(``experts.gate_up_proj`` [E, 2F, D], gate rows first, and
``experts.down_proj`` [E, D, F]); ``routing`` can replace the choice by a
given one, so that a comparison follows the program's choice, while the
weights are still read from the reference's own scores.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def strict_f32():
    """Float32 products in float32 on the card (TF32 off), restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x, pos, theta):
    """DeepSeek-V3's RoPE of x [B, L, H, d] at positions pos [B, L]."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device).float() / d)
    ang = pos[..., None].float() * freqs
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def swiglu(h, gate_up, down):
    """gate_up [2F, D] (gate rows first), down [D, F]."""
    gate, up = F.linear(h, gate_up).chunk(2, -1)
    return F.linear(F.silu(gate) * up, down)


def forward(W: Dict[str, torch.Tensor], cfg: Dict, x, key_valid, pos, out_at=None,
            routing: Optional[Dict[int, torch.Tensor]] = None, prefix: str = ""):
    """x [B, L, D] input embeddings; key_valid [B, L]; pos [B, L]; a query
    sees a valid key at a position not after its own.  ``routing``: {layer:
    [B, L, k] experts} to use in place of the reference's own choice.
    → (float32 logits [B, len(out_at), vocab] at the rows ``out_at``, all
    rows where None; {layer: float32 choice scores [B, L, E] (sigmoid plus
    bias)} of each expert layer)."""
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
        q = F.linear(h, g("self_attn.q_proj.weight")).reshape(B, L, H, nope + rp)
        lat, k_pe = F.linear(h, g("self_attn.kv_a_proj_with_mqa.weight")).split([R, rp], -1)
        lat = rms(lat, g("self_attn.kv_a_layernorm.weight"), eps)
        kv = F.linear(lat, g("self_attn.kv_b_proj.weight")).reshape(B, L, H, nope + vd)
        k_pe = rope(k_pe[:, :, None], pos, theta).expand(B, L, H, rp)
        qh = torch.cat([q[..., :nope], rope(q[..., nope:], pos, theta)], -1)
        kh = torch.cat([kv[..., :nope], k_pe], -1)
        s = torch.einsum("blhd,bmhd->bhlm", qh, kh) * scale
        a = torch.nan_to_num(torch.softmax(s.masked_fill(~see[:, None], float("-inf")), -1))
        o = torch.einsum("bhlm,bmhd->blhd", a, kv[..., nope:]).reshape(B, L, H * vd)
        x = x + F.linear(o, g("self_attn.o_proj.weight"))
        h = rms(x, g("post_attention_layernorm.weight"), eps)
        if i < cfg["first_k_dense_replace"]:
            gu = torch.cat([g("mlp.gate_proj.weight"), g("mlp.up_proj.weight")])
            x = x + swiglu(h, gu, g("mlp.down_proj.weight"))
            continue
        scores = torch.sigmoid(F.linear(h, g("mlp.gate.weight")))
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
                y = swiglu(h[b, l], gu_all[e].float(), down_all[e].float())
                ffn.index_put_((b, l), y * w[b, l, j][:, None], accumulate=True)
        sh = torch.cat([g("mlp.shared_experts.gate_proj.weight"),
                        g("mlp.shared_experts.up_proj.weight")])
        x = x + ffn + swiglu(h, sh, g("mlp.shared_experts.down_proj.weight"))
    x = x if out_at is None else x[:, out_at]
    x = rms(x, W[prefix + "core.final_norm.weight"], eps)
    return F.linear(x, W[prefix + "core.lm_head.weight"].float()), choices
