"""BERT/CLIP-style transformer encoder (counterpart of
``openpsg_tpu/models/commons/text_encoder.py``), one configurable module:

  * post-LN BERT layers, or pre-LN CLIP layers (``pre_ln``) with
    quickGELU (``quick_gelu``) and causal self-attention (``causal``);
  * layer truncation (``num_layers``);
  * decoder mode with cross-attention to encoder states
    (``add_cross_attention``; the cross block runs only when encoder states
    are passed, as in HF BERT);
  * bottleneck adapters after attention and parallel to the FFN
    (``use_adapters``);
  * learnable prompt embeddings spliced between CLS and the text tokens
    (``num_learnable_prompts``, or a per-row table passed in);
  * externally projected token sequences (``input_embeds``), constant
    position ids, BERT pooling (``pool``), and the bare layer stack
    (``bare``).

Parameter names mirror the flax module's (the scanned layer stack becomes
``layers.{i}``), so a flax-layout tree — a JAX parameter tree or a
converter's output — loads through :func:`load_tree`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from openpsg_tpu_torch.models.common import LayerNorm


@dataclasses.dataclass(frozen=True)
class BertStyleConfig:
    hidden_size: int = 768
    num_layers: int = 2
    num_heads: int = 12
    intermediate: int = 3072
    vocab_size: int = 1024
    max_len: int = 128
    add_cross_attention: bool = False
    encoder_hidden_size: int = 256
    use_adapters: bool = False
    adapter_reduction: int = 4        # bottleneck /4
    num_learnable_prompts: int = 0
    pre_ln: bool = False              # CLIP towers are pre-LN; BERT post-LN
    quick_gelu: bool = False          # CLIP's x*sigmoid(1.702x) activation
    causal: bool = False              # CLIP text attention is causal
    ln_eps: float = 1e-12             # HF BERT epsilon; CLIP towers use 1e-5
    bare: bool = False                # raw HF BertEncoder: layer stack only
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny_test(**kw) -> "BertStyleConfig":
        base = dict(hidden_size=32, num_layers=2, num_heads=2,
                    intermediate=64, vocab_size=64, max_len=32)
        base.update(kw)
        return BertStyleConfig(**base)


class DenseLN(nn.Module):
    """Linear → LayerNorm (eps 1e-5), the reference's ``fc_*`` block
    (``nn.Sequential(nn.Linear, nn.LayerNorm)``); scopes ``dense``, ``ln``."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.dense = nn.Linear(in_features, features)
        self.ln = LayerNorm(features, eps=1e-5)

    def forward(self, x):
        return self.ln(self.dense(x))


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention``: query/key/value/out
    projections with biases, queries scaled by 1/√hd, masked logits set to
    the dtype's minimum, softmax over keys."""

    def __init__(self, dim: int, num_heads: int, kv_dim: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(kv_dim or dim, dim)
        self.value = nn.Linear(kv_dim or dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x, kv, mask):
        """x [B, L, D]; kv [B, S, Dk]; mask [B, L, S] bool (True = attend)."""
        B, L, D = x.shape
        S = kv.shape[1]
        H = self.num_heads
        q = self.query(x).reshape(B, L, H, D // H) / (D // H) ** 0.5
        k = self.key(kv).reshape(B, S, H, D // H)
        v = self.value(kv).reshape(B, S, H, D // H)
        logits = torch.einsum("blhd,bshd->bhls", q, k)
        logits = logits.masked_fill(~mask[:, None], torch.finfo(logits.dtype).min)
        attn = torch.softmax(logits, dim=-1)
        return self.out(torch.einsum("bhls,bshd->blhd", attn, v).reshape(B, L, D))


class _Adapter(nn.Module):
    """Bottleneck adapter: down /r → exact GELU → up (residual by caller)."""

    def __init__(self, dim: int, reduction: int):
        super().__init__()
        self.down = nn.Linear(dim, dim // reduction)
        self.up = nn.Linear(dim // reduction, dim)

    def forward(self, x):
        return self.up(F.gelu(self.down(x), approximate="none"))


class _EncoderLayer(nn.Module):
    def __init__(self, c: BertStyleConfig):
        super().__init__()
        self.c = c
        D = c.hidden_size
        ln = lambda: LayerNorm(D, eps=c.ln_eps)
        if c.pre_ln:
            self.attn_pre_ln = ln()
        self.self_attn = Attention(D, c.num_heads)
        if not c.pre_ln:
            self.self_ln = ln()
        if c.add_cross_attention:
            if c.pre_ln:
                self.cross_pre_ln = ln()
            self.cross_attn = Attention(D, c.num_heads)
            if not c.pre_ln:
                self.cross_ln = ln()
        if c.pre_ln:
            self.ffn_pre_ln = ln()
        self.ffn_up = nn.Linear(D, c.intermediate)
        self.ffn_down = nn.Linear(c.intermediate, D)
        if not c.pre_ln:
            self.ffn_ln = ln()
        if c.use_adapters:
            self.attn_adapter = _Adapter(D, c.adapter_reduction)
            self.ffn_adapter = _Adapter(D, c.adapter_reduction)

    def _act(self, f):
        if self.c.quick_gelu:
            return f * torch.sigmoid(1.702 * f)
        return F.gelu(f, approximate="none")

    def forward(self, x, self_mask, enc_states, enc_mask):
        c = self.c
        if c.pre_ln:
            # CLIP ordering: x += attn(LN(x)); x += mlp(LN(x))
            h = self.attn_pre_ln(x)
            h = self.self_attn(h, h, self_mask)
            if c.use_adapters:
                h = h + self.attn_adapter(h)
            x = x + h
            if c.add_cross_attention and enc_states is not None:
                h = self.cross_pre_ln(x)
                x = x + self.cross_attn(h, enc_states, enc_mask)
            h = self.ffn_pre_ln(x)
            f = self.ffn_down(self._act(self.ffn_up(h)))
            if c.use_adapters:
                f = f + self.ffn_adapter(h)
            return x + f
        h = self.self_attn(x, x, self_mask)
        if c.use_adapters:
            h = h + self.attn_adapter(h)
        x = self.self_ln(x + h)
        if c.add_cross_attention and enc_states is not None:
            x = self.cross_ln(x + self.cross_attn(x, enc_states, enc_mask))
        f = self.ffn_down(F.gelu(self.ffn_up(x), approximate="none"))
        if c.use_adapters:
            # parallel adapter on the FFN input
            f = f + self.ffn_adapter(x)
        return self.ffn_ln(x + f)


class BertStyleEncoder(nn.Module):
    """``word_embeddings``: build the token table (``word_embed``); the
    flax module creates it only when called with token ids, so towers fed
    ``input_embeds`` alone are built without it."""

    def __init__(self, cfg: BertStyleConfig, word_embeddings: bool = True):
        super().__init__()
        c = self.cfg = cfg
        D = c.hidden_size
        if word_embeddings:
            self.word_embed = nn.Embedding(c.vocab_size, D)
        if not c.bare:
            self.pos_embed = nn.Parameter(torch.empty(c.max_len, D))
            if not c.pre_ln:
                self.embed_ln = LayerNorm(D, eps=c.ln_eps)
        if c.num_learnable_prompts > 0:
            self.learnable_prompts = nn.Parameter(torch.empty(c.num_learnable_prompts, D))
        if c.add_cross_attention and c.encoder_hidden_size != D:
            self.encoder_proj = nn.Linear(c.encoder_hidden_size, D)
        self.layers = nn.ModuleList(_EncoderLayer(c) for _ in range(c.num_layers))
        if not c.bare:
            if c.pre_ln:
                self.final_ln = LayerNorm(D, eps=c.ln_eps)
            self.pooler = nn.Linear(D, D)

    def init_extra(self, gen):
        for name in ("pos_embed", "learnable_prompts"):
            if hasattr(self, name):
                getattr(self, name).normal_(0.0, 0.02, generator=gen)

    def forward(self, *, token_ids=None, input_embeds=None, attention_mask=None,
                encoder_hidden=None, encoder_mask=None, pool: bool = False,
                position_ids: Optional[int] = None, learnable_embeds=None):
        """token_ids [B, L] or input_embeds [B, L, D]; attention_mask [B, L]
        bool over keys (HF semantics: padded query rows still attend);
        encoder_hidden [B, P, De] with encoder_mask [B, P]; ``pool``: the
        BERT pooler's tanh(dense(CLS)); ``position_ids``: one constant
        position row for every token (None: 0..L-1); ``learnable_embeds``
        [B, P, D]: a per-row prompt table.  → [B, L(+P), D] or [B, D]."""
        c = self.cfg
        emb = self.word_embed(token_ids.long()) if input_embeds is None else input_embeds
        emb = emb.to(c.dtype)
        B, L = emb.shape[:2]
        dev = emb.device
        if attention_mask is None:
            attention_mask = torch.ones(B, L, dtype=torch.bool, device=dev)
        attention_mask = attention_mask.bool()
        if c.bare:
            x = emb
        elif position_ids is None:
            x = emb + self.pos_embed[:L].to(emb.dtype)
        else:
            x = emb + self.pos_embed[position_ids].to(emb.dtype)[None, None]
        if not c.pre_ln and not c.bare:
            x = self.embed_ln(x)
        if learnable_embeds is not None or c.num_learnable_prompts > 0:
            # spliced after the embedding LayerNorm, without position rows
            if learnable_embeds is None:
                learnable_embeds = self.learnable_prompts[None].expand(B, -1, -1)
            pr = learnable_embeds.to(x.dtype)
            P = pr.shape[1]
            x = torch.cat([x[:, :1], pr, x[:, 1:]], dim=1)
            attention_mask = torch.cat([attention_mask[:, :1],
                                        torch.ones(B, P, dtype=torch.bool, device=dev),
                                        attention_mask[:, 1:]], dim=1)
            L = L + P
        self_mask = attention_mask[:, None, :].expand(B, L, L)
        if c.causal:
            self_mask = self_mask & torch.ones(L, L, dtype=torch.bool, device=dev).tril()[None]
        enc_states = enc_mask = None
        if encoder_hidden is not None:
            if hasattr(self, "encoder_proj") and encoder_hidden.shape[-1] != c.hidden_size:
                encoder_hidden = self.encoder_proj(encoder_hidden)
            enc_states = encoder_hidden.to(x.dtype)
            em = (encoder_mask.bool() if encoder_mask is not None
                  else torch.ones(enc_states.shape[:2], dtype=torch.bool, device=dev))
            enc_mask = em[:, None, :].expand(B, L, em.shape[1])
        for layer in self.layers:
            x = layer(x, self_mask, enc_states, enc_mask)
        if c.bare:
            return x
        if c.pre_ln:
            x = self.final_ln(x)
        if pool:
            return torch.tanh(self.pooler(x[:, 0]))
        return x


# the flax module's one nn.scan stack
_SCANNED = {("tower", "layers"): ("tower", "layers")}


def tower_state_dict(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A flax-layout tree (nested dicts of arrays, without the ``params``
    wrapper) → {port parameter name: numpy array}, the scanned layer stack
    split into ``layers.{i}``."""
    from openpsg_tpu_torch.bridge import part_state_dict

    return part_state_dict("tower", {"params": tree}, scanned=_SCANNED)


def load_tree(module: nn.Module, tree: Dict[str, Any]) -> None:
    """Load a flax-layout tree into a :class:`BertStyleEncoder`, each array
    cast to its parameter's dtype.  Strict: a missing, extra or misshapen
    parameter raises."""
    from openpsg_tpu_torch.bridge import load_part

    load_part(module, "tower", {"params": tree}, scanned=_SCANNED)
