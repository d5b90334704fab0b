"""DeepSeek-V3-architecture decoder (HF ``model_type`` ``deepseek_v3``;
Moonlight-16B-A3B is one): multi-head latent attention (MLA) and a
mixture of experts with shared experts.  It offers the interface
:func:`~openpsg_tpu_torch.models.llm.decode.greedy_decode` calls on the
Llama (``embed``, ``forward(input_embeds=..., attention_mask=...,
positions=..., cache=..., cache_index=..., key_positions=...,
last_logit_only=...)``, ``core.lm_head``), so ``PSGv4`` decodes with it
unchanged.

Layer i: ``x += o_proj(MLA(rms(x)))``, then ``x += FFN_i(rms(x))``: a
dense SwiGLU for the first ``first_k_dense`` layers, the expert layer
(:class:`MoE`) after them.

MLA (no q LoRA), per token:

* ``q = q_proj(h)``, per head split into ``q_nope`` (``qk_nope_head_dim``)
  and ``q_pe`` (``qk_rope_head_dim``);
* ``[c, k_pe] = kv_a_proj_with_mqa(h)``: the latent ``c``
  (``kv_lora_rank``), normed by ``kv_a_layernorm``, and one ``k_pe`` that
  every head shares;
* ``[k_nope, v] = kv_b_proj(c)`` per head;
* RoPE on ``q_pe`` and ``k_pe`` with the pairing of the family's published
  modeling code (``modeling_deepseek.py`` ``apply_rotary_pos_emb``): the
  adjacent pairs ``(x0, x1), (x2, x3), ...`` are first de-interleaved to
  ``(x0, x2, ..., x1, x3, ...)``, then rotated by halves as in the Llama;
* softmax scale ``(qk_nope_head_dim + qk_rope_head_dim) ** -0.5``.

A forward without a cache (prefill) computes this expanded form and
returns each layer's ``(c, k_pe)``.  A forward with a cache (decode) holds
only ``c`` and the roped ``k_pe`` per token (``kv_lora_rank +
qk_rope_head_dim`` values a token a layer) and computes the absorbed form:
``W_UK`` (the ``k_nope`` rows of ``kv_b_proj``) is folded into the query,
``q_nope·k_nope = (q_nope·W_UK)·c``, the heads attend over the latent, and
``W_UV`` is applied after, ``p·v = (p·c)·W_UVᵀ``.  Scores are float32 sums
of exact products (``common.mm_f32``); the cache stays in the model's dtype.

Expert layer (``noaux_tc`` routing with one group, as Moonlight's config):
``s = sigmoid(h·W_gateᵀ)`` in float32; the choice is the top
``experts_per_token`` of ``s + e_score_correction_bias``; the weights are
the chosen ``s`` (no bias), normalised over the choice
(``norm_topk_prob``) and times ``routed_scaling_factor``.  The routed
experts' SwiGLUs (:class:`Experts`) are summed with those weights in
float32, and the shared experts, one SwiGLU of width ``n_shared_experts ·
moe_hidden``, added.  The experts are held stacked (``gate_up_proj`` [E,
2F, D] with the gate rows first, ``down_proj`` [E, D, F]); a published
checkpoint's per-expert ``gate_proj`` / ``up_proj`` / ``down_proj`` stack
into them.

Spans: ``psg.mla`` around each attention call, ``psg.moe`` around each
expert layer, router to combine, shared experts included.  Counters (host
ints from shapes, no sync): :attr:`MoE.grouped_launches` and
:attr:`MoE.routed_rows`, bumped through ``utils.graphs.bump``, so that a
decode trip replayed from CUDA graphs counts as the eager trip does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from openpsg_tpu_torch.models.common import mm_f32
from openpsg_tpu_torch.models.llm.llama import (
    RMSNorm,
    apply_rope,
    cache_slots,
    rope_tables,
    visibility,
)
from openpsg_tpu_torch.utils.graphs import bump
from openpsg_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class DeepseekV3Config:
    vocab_size: int = 163840
    dim: int = 2048
    n_layers: int = 27
    n_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # the dense SwiGLU of the first ``first_k_dense`` layers
    ffn_hidden: int = 11264
    first_k_dense: int = 1
    moe_hidden: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    experts_per_token: int = 6
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    rope_theta: float = 50000.0
    norm_eps: float = 1e-5
    # no int8 path: ``PSGv4`` reads ``quant`` and refuses it for this family
    quant: bool = False
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def from_hf(d: Dict, dtype: torch.dtype = torch.bfloat16) -> "DeepseekV3Config":
        """A published ``config.json`` (HF keys) → the config; refuses the
        variants this module does not compute (q LoRA, grouped routing over
        several groups, softmax scores, rope scaling, sparse MoE layers)."""
        unsupported = {"q_lora_rank": None, "n_group": 1, "topk_group": 1,
                       "scoring_func": "sigmoid", "topk_method": "noaux_tc",
                       "rope_scaling": None, "moe_layer_freq": 1, "hidden_act": "silu"}
        for k, want in unsupported.items():
            if d.get(k, want) != want:
                raise NotImplementedError(f"deepseek_v3 with {k}={d[k]!r} (only {want!r})")
        return DeepseekV3Config(
            vocab_size=d["vocab_size"], dim=d["hidden_size"], n_layers=d["num_hidden_layers"],
            n_heads=d["num_attention_heads"], kv_lora_rank=d["kv_lora_rank"],
            qk_nope_head_dim=d["qk_nope_head_dim"], qk_rope_head_dim=d["qk_rope_head_dim"],
            v_head_dim=d["v_head_dim"], ffn_hidden=d["intermediate_size"],
            first_k_dense=d["first_k_dense_replace"], moe_hidden=d["moe_intermediate_size"],
            n_routed_experts=d["n_routed_experts"], n_shared_experts=d["n_shared_experts"],
            experts_per_token=d["num_experts_per_tok"],
            routed_scaling_factor=float(d["routed_scaling_factor"]),
            norm_topk_prob=bool(d["norm_topk_prob"]), rope_theta=float(d["rope_theta"]),
            norm_eps=float(d["rms_norm_eps"]), dtype=dtype)

    @staticmethod
    def tiny_test(vocab_size: int = 128) -> "DeepseekV3Config":
        return DeepseekV3Config(
            vocab_size=vocab_size, dim=64, n_layers=3, n_heads=4, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, ffn_hidden=128,
            first_k_dense=1, moe_hidden=32, n_routed_experts=8, n_shared_experts=1,
            experts_per_token=2, dtype=torch.float32)


def rope_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's RoPE of x [B, L, H, d]: adjacent pairs de-interleaved,
    then rotated by halves (the result stays de-interleaved, as the
    published code leaves it; queries and keys alike)."""
    x = x.unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)
    return apply_rope(x, cos, sin)


class SwiGLU(nn.Module):
    """``down(silu(gate(h)) · up(h))``: the dense layers' FFN and the shared
    experts."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.gate_proj = nn.Linear(dim, hidden, bias=False)
        self.up_proj = nn.Linear(dim, hidden, bias=False)
        self.down_proj = nn.Linear(hidden, dim, bias=False)

    def forward(self, h):
        return self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))


class MLA(nn.Module):
    """Multi-head latent attention (module docstring)."""

    def __init__(self, c: DeepseekV3Config):
        super().__init__()
        self.c = c
        H, R = c.n_heads, c.kv_lora_rank
        self.q_proj = nn.Linear(c.dim, H * (c.qk_nope_head_dim + c.qk_rope_head_dim), bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(c.dim, R + c.qk_rope_head_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(R, c.norm_eps)
        self.kv_b_proj = nn.Linear(R, H * (c.qk_nope_head_dim + c.v_head_dim), bias=False)
        self.o_proj = nn.Linear(H * c.v_head_dim, c.dim, bias=False)

    def forward(self, h, rot, see, cache=None, cache_index=0):
        """h [B, L, D]; rot = rope_tables(positions, qk_rope_head_dim);
        see [B, L, K] True where a query may see a key (K = L without a
        cache, the cache's S with one).  ``cache``: this layer's (latent [B,
        S, R], k_pe [B, S, rope]); the current tokens' entries are written
        at ``cache_index`` first, then attended over with the rest.
        → (out [B, L, D], latent [B, L, R], k_pe [B, L, rope])."""
        c = self.c
        B, L, _ = h.shape
        H, nope, rp = c.n_heads, c.qk_nope_head_dim, c.qk_rope_head_dim
        with span("mla"):
            q = self.q_proj(h).view(B, L, H, nope + rp)
            q_nope, q_pe = q.split([nope, rp], -1)
            q_pe = rope_pairs(q_pe, *rot)
            lat, k_pe = self.kv_a_proj_with_mqa(h).split([c.kv_lora_rank, rp], -1)
            lat = self.kv_a_layernorm(lat)
            k_pe = rope_pairs(k_pe[:, :, None], *rot)[:, :, 0]
            masked_out = ~see
            if cache is None:
                out = self._expanded(q_nope, q_pe, lat, k_pe, masked_out)
            else:
                slots = cache_slots(cache_index, L, h.device)
                cache[0].index_copy_(1, slots, lat.to(cache[0].dtype))
                cache[1].index_copy_(1, slots, k_pe.to(cache[1].dtype))
                out = self._absorbed(q_nope, q_pe, cache[0], cache[1], masked_out)
            return self.o_proj(out.reshape(B, L, H * c.v_head_dim)), lat, k_pe

    def _expanded(self, q_nope, q_pe, lat, k_pe, masked_out):
        """Prefill: per-head keys and values from the latent → [B, L, H, v]."""
        c = self.c
        B, L, H, _ = q_nope.shape
        kv = self.kv_b_proj(lat).view(B, L, H, c.qk_nope_head_dim + c.v_head_dim)
        k_nope, v = kv.split([c.qk_nope_head_dim, c.v_head_dim], -1)
        q = torch.cat([q_nope, q_pe], -1)
        k = torch.cat([k_nope, k_pe[:, :, None].expand(B, L, H, -1)], -1)
        scores = mm_f32(q, k, "blhd,bmhd->bhlm")
        scale = (c.qk_nope_head_dim + c.qk_rope_head_dim) ** -0.5
        attn = torch.softmax((scores * scale).masked_fill(masked_out[:, None], -1e9), -1)
        out = torch.matmul(attn.to(v.dtype), v.transpose(1, 2))      # [B, H, L, v]
        return out.transpose(1, 2)

    def _absorbed(self, q_nope, q_pe, c_kv, pe_kv, masked_out):
        """Decode: attention over the latent cache (c_kv [B, S, R], pe_kv
        [B, S, rope]) with W_UK folded into the query and W_UV after
        → [B, L, H, v]."""
        c = self.c
        B, L, H, _ = q_nope.shape
        w = self.kv_b_proj.weight.view(H, c.qk_nope_head_dim + c.v_head_dim, c.kv_lora_rank)
        w_uk, w_uv = w[:, :c.qk_nope_head_dim], w[:, c.qk_nope_head_dim:]
        q_lat = torch.einsum("blhd,hdr->blhr", q_nope, w_uk).reshape(B, L * H, -1)
        scores = mm_f32(q_lat, c_kv, "bqr,bsr->bqs") \
            + mm_f32(q_pe.reshape(B, L * H, -1), pe_kv, "bqe,bse->bqs")     # [B, L·H, S]
        scale = (c.qk_nope_head_dim + c.qk_rope_head_dim) ** -0.5
        mask = masked_out[:, :, None].expand(B, L, H, -1).reshape(B, L * H, -1)
        attn = torch.softmax((scores * scale).masked_fill(mask, -1e9), -1)
        o_lat = torch.bmm(attn.to(c_kv.dtype), c_kv).view(B, L, H, -1)
        return torch.einsum("blhr,hvr->blhv", o_lat, w_uv)


class Router(nn.Module):
    """``noaux_tc`` routing with one group (module docstring)."""

    def __init__(self, c: DeepseekV3Config):
        super().__init__()
        self.c = c
        self.weight = nn.Parameter(torch.empty(c.n_routed_experts, c.dim))
        self.e_score_correction_bias = nn.Parameter(torch.empty(c.n_routed_experts))

    def init_extra(self, gen):
        self.weight.normal_(0.0, self.c.dim ** -0.5, generator=gen)
        self.e_score_correction_bias.zero_()

    def forward(self, h):
        """h [..., D] → (experts [..., k] int64, weights [..., k] float32)."""
        c = self.c
        logits = mm_f32(h.reshape(-1, h.shape[-1]), self.weight, "td,ed->te")
        scores = torch.sigmoid(logits.view(*h.shape[:-1], -1))
        choice = scores + self.e_score_correction_bias.float()
        idx = torch.topk(choice, c.experts_per_token, dim=-1).indices
        w = scores.gather(-1, idx)
        if c.norm_topk_prob:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return idx, w * c.routed_scaling_factor


class Experts(nn.Module):
    """The routed experts' SwiGLUs, stacked: ``gate_up_proj`` [E, 2F, D]
    (gate rows, then up rows) and ``down_proj`` [E, D, F]."""

    def __init__(self, c: DeepseekV3Config):
        super().__init__()
        self.c = c
        E, D, Fh = c.n_routed_experts, c.dim, c.moe_hidden
        self.gate_up_proj = nn.Parameter(torch.empty(E, 2 * Fh, D))
        self.down_proj = nn.Parameter(torch.empty(E, D, Fh))

    def init_extra(self, gen):
        for p in (self.gate_up_proj, self.down_proj):
            p.normal_(0.0, p.shape[-1] ** -0.5, generator=gen)

    def forward(self, x, idx, w):
        """x [T, D]; idx [T, k] experts; w [T, k] float32 weights → the
        weighted sum of each token's experts, float32 [T, D].  The (token,
        expert) picks are sorted by expert on the card and the group ends
        found by a search of the sorted ids (no host sync); then one
        grouped product for gate/up and one for down over every expert (an
        expert with no rows has an empty group)."""
        T, k = idx.shape
        E = self.c.n_routed_experts
        flat = idx.reshape(-1)
        order = torch.argsort(flat, stable=True)
        ends = torch.searchsorted(flat[order], torch.arange(E, device=flat.device),
                                  right=True).to(torch.int32)
        rows = x[order // k]
        gate, up = torch._grouped_mm(rows, self.gate_up_proj.transpose(1, 2),
                                     offs=ends).chunk(2, -1)
        y = torch._grouped_mm(F.silu(gate) * up, self.down_proj.transpose(1, 2), offs=ends)
        bump(MoE, "grouped_launches", 2)
        back = torch.empty_like(y)
        back[order] = y
        return (back.view(T, k, -1).float() * w[..., None]).sum(1)

    def loop(self, x, idx, w):
        """One product per expert that has rows: the plain version the CPU
        tests hold :meth:`forward` to (the row lists wait for the device)."""
        out = torch.zeros(x.shape[0], x.shape[1], dtype=torch.float32, device=x.device)
        for e in range(self.c.n_routed_experts):
            tok, slot = (idx == e).nonzero(as_tuple=True)
            if tok.numel() == 0:
                continue
            gate, up = F.linear(x[tok], self.gate_up_proj[e]).chunk(2, -1)
            y = F.linear(F.silu(gate) * up, self.down_proj[e])
            out.index_add_(0, tok, y.float() * w[tok, slot][:, None])
        return out


class MoE(nn.Module):
    """The expert layer: router, routed experts, shared experts."""

    # host counters, from shapes: grouped products launched, routed
    # (token, expert) rows computed
    grouped_launches = 0
    routed_rows = 0

    def __init__(self, c: DeepseekV3Config):
        super().__init__()
        self.gate = Router(c)
        self.experts = Experts(c)
        self.shared_experts = SwiGLU(c.dim, c.n_shared_experts * c.moe_hidden)

    def forward(self, h):
        """h [B, L, D] → [B, L, D] in h's dtype."""
        B, L, D = h.shape
        with span("moe"):
            idx, w = self.gate(h)
            k = idx.shape[-1]
            bump(MoE, "routed_rows", B * L * k)
            routed = self.experts(h.reshape(-1, D), idx.reshape(-1, k), w.reshape(-1, k))
            shared = self.shared_experts(h).reshape(-1, D)
            return (routed + shared.float()).to(h.dtype).view(B, L, D)


class DecoderLayer(nn.Module):
    def __init__(self, c: DeepseekV3Config, dense: bool):
        super().__init__()
        self.input_layernorm = RMSNorm(c.dim, c.norm_eps)
        self.self_attn = MLA(c)
        self.post_attention_layernorm = RMSNorm(c.dim, c.norm_eps)
        self.mlp = SwiGLU(c.dim, c.ffn_hidden) if dense else MoE(c)

    def forward(self, x, rot, see, cache=None, cache_index=0):
        a, lat, k_pe = self.self_attn(self.input_layernorm(x), rot, see, cache, cache_index)
        x = x + a
        return x + self.mlp(self.post_attention_layernorm(x)), lat, k_pe


class DeepseekV3(nn.Module):
    def __init__(self, c: DeepseekV3Config):
        super().__init__()
        self.c = c
        self.layers = nn.ModuleList(DecoderLayer(c, i < c.first_k_dense)
                                    for i in range(c.n_layers))
        self.final_norm = RMSNorm(c.dim, c.norm_eps)
        self.lm_head = nn.Linear(c.dim, c.vocab_size, bias=False)

    def forward(self, input_embeds, attention_mask, positions,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache_index=0, key_positions=None, last_logit_only: bool = False):
        """input_embeds [B, L, D]; attention_mask [B, S] over keys;
        positions [B, L]; a query sees a valid key whose position is not
        after its own.  Without ``cache``: the L tokens are the keys;
        returns (logits, (latent [n_layers, B, L, R], k_pe [n_layers, B, L,
        rope])).  With ``cache`` (those two, S slots) and ``key_positions``
        [B, S]: the current tokens fill slots [cache_index, cache_index + L)
        in place, and the cache is returned; ``cache_index`` an int or a 0-d
        int64 device tensor (``llama.cache_slots``)."""
        c = self.c
        if cache is not None and key_positions is None:
            raise ValueError("the cache path needs key_positions")
        see = visibility(positions, attention_mask, key_positions)
        rot = rope_tables(positions, c.qk_rope_head_dim, c.rope_theta)
        x = input_embeds.to(c.dtype)
        lats, pes = [], []
        for i, layer in enumerate(self.layers):
            layer_cache = None if cache is None else (cache[0][i], cache[1][i])
            x, lat, k_pe = layer(x, rot, see, layer_cache, cache_index)
            if cache is None:
                lats.append(lat)
                pes.append(k_pe)
        new_cache = (torch.stack(lats), torch.stack(pes)) if cache is None else cache
        x = self.final_norm(x)
        if last_logit_only:
            x = x[:, -1:]
        return self.lm_head(x).float(), new_cache


class DeepseekV3WithEmbeddings(nn.Module):
    def __init__(self, c: DeepseekV3Config):
        super().__init__()
        self.cfg = c
        self.tok_embed = nn.Embedding(c.vocab_size, c.dim)
        self.core = DeepseekV3(c)

    def embed(self, token_ids):
        return self.tok_embed(token_ids)

    def forward(self, *, input_embeds=None, token_ids=None, **kw):
        """Embeds ``token_ids`` unless ``input_embeds`` is given, then runs
        the core (:meth:`DeepseekV3.forward`'s keywords)."""
        if input_embeds is None:
            input_embeds = self.embed(token_ids)
        return self.core(input_embeds, **kw)
