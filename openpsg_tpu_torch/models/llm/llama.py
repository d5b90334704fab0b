"""Llama-family decoder (counterpart of ``openpsg_tpu/models/llm/llama.py``):
RMSNorm, rotate-half RoPE, grouped-query attention, SwiGLU; dense
projections, or int8 ones (:class:`QDense`, ``LlamaConfig.quant``) with
the optional int8-activation prefill (``act_int8``).  A forward without a
cache attends among its own tokens (prefill) and returns their (k, v); a
forward with a cache reads it as read-only keys plus the current tokens'
own keys, then writes those keys into the cache in place (the JAX version
returns an updated copy)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

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
    max_seq_len: int = 512
    # False: every token attends to every valid key (head v3's non-causal
    # trunk); True (default): causal by position
    causal: bool = True
    # int8 projections with per-output-channel float32 scales (QDense)
    quant: bool = False
    # with ``quant``: per-token int8 activations for products of at least
    # QDense.ACT_INT8_MIN_ROWS rows (prefill); decode stays weight-only
    act_int8: bool = False
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def llama2_7b(dtype=torch.bfloat16) -> "LlamaConfig":
        return LlamaConfig(dtype=dtype)

    @staticmethod
    def tiny_test(vocab_size: int = 128) -> "LlamaConfig":
        return LlamaConfig(vocab_size=vocab_size, dim=64, n_layers=2, n_heads=4,
                           n_kv_heads=2, ffn_hidden=128, max_seq_len=128,
                           dtype=torch.float32)

    def truncate(self, n: int) -> "LlamaConfig":
        """The first n layers only (``llm_truncate_num`` /
        ``shave_language_decoder_at``)."""
        return dataclasses.replace(self, n_layers=n)


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


# the projections QDense replaces under ``quant`` (JAX llama.py:165)
QUANT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")


def _per_127(t: torch.Tensor) -> torch.Tensor:
    """t / 127, correctly rounded on every device: CUDA divides by a host
    scalar through its reciprocal, which can land one float32 step away."""
    return t / torch.full_like(t, 127.0)


class _WeightOnlyMM(torch.autograd.Function):
    """x [M, K] times the int8 w_q [N, K] transposed, with w_q in x's type:
    exact products summed and returned in float32 (the JAX einsum's
    ``preferred_element_type=float32``; a bf16 product would round once
    more before the scale).

    Backward: the input gradient flax takes through that einsum, the
    float32 cotangent times w_q (exact in float32) summed in float32 and
    cast to x's type; the frozen int8 weight gets none.  The same Function
    runs on every device, so the CPU exercises the card's backward."""

    @staticmethod
    def forward(ctx, x, w_q):
        ctx.save_for_backward(w_q)
        ctx.x_dtype = x.dtype
        if x.dtype == torch.float32 or not x.is_cuda:
            return x.float() @ w_q.float().t()
        # the same sums on the card without widening the weights to
        # float32; PyTorch's mm with out_dtype has no CPU kernel and no
        # derivative (hence this Function)
        return torch.mm(x, w_q.to(x.dtype).t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad_y):
        (w_q,) = ctx.saved_tensors
        grad_x = (grad_y.float() @ w_q.float()).to(ctx.x_dtype)
        return grad_x, None


def _weight_only_mm(x: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    return _WeightOnlyMM.apply(x, w_q)


class QDense(nn.Module):
    """Int8 linear (counterpart of the JAX ``QDense``, llama.py:104-148):
    ``weight_q`` int8 [out, in] (flax ``kernel_q`` transposed) and a float32
    per-output-channel ``scale`` [out].

    Weight-only: ``x @ weight_q`` in x's type with float32 sums, times
    ``scale`` in float32, cast to ``dtype``.  With ``act_int8`` and at
    least ``ACT_INT8_MIN_ROWS`` rows (the product of all leading dims of
    x): per-token ``s_x = max(max|x|, 1e-6) / 127``, ``round(x / s_x)``
    (half to even) clipped to ±127, an int8×int8→int32 product, then
    ``(y · s_x) · scale``.

    Gradients (training through the frozen LLM) are flax's: weight-only,
    the cotangent times ``weight_q`` (:class:`_WeightOnlyMM`); with int8
    activations, rounding and the cast to int8 pass none, so the input
    gradient flows only through ``s_x`` — to each row's largest |x|,
    shared among ties (a quirk of the JAX ``QDense`` that the port
    copies)."""

    ACT_INT8_MIN_ROWS = 256

    def __init__(self, in_features: int, out_features: int, act_int8: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.act_int8, self.dtype = act_int8, dtype
        self.weight_q = nn.Parameter(
            torch.empty(out_features, in_features, dtype=torch.int8), requires_grad=False)
        self.scale = nn.Parameter(
            torch.empty(out_features, dtype=torch.float32), requires_grad=False)

    def forward(self, x):
        x2 = x.reshape(-1, x.shape[-1])
        if self.act_int8 and x2.shape[0] >= self.ACT_INT8_MIN_ROWS:
            xf = x2.float()
            s_x = _per_127(torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-6))
            xq = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
            # on CUDA _int_mm needs more than 16 rows (here ≥ 256) and K, N
            # multiples of 8 (true of every Llama width the configs use)
            y = torch._int_mm(xq, self.weight_q.t()).float() * s_x * self.scale
        else:
            y = _weight_only_mm(x2, self.weight_q) * self.scale
        return y.to(self.dtype).reshape(*x.shape[:-1], -1)


def _dense(c: LlamaConfig, in_features: int, out_features: int) -> nn.Module:
    if c.quant:
        return QDense(in_features, out_features, act_int8=c.act_int8, dtype=c.dtype)
    return nn.Linear(in_features, out_features, bias=False)


@torch.no_grad()
def quantize_llama(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """State dict of a dense LLM (``[out, in]`` weights) → that of the
    ``quant=True`` LLM (counterpart of the JAX ``quantize_llama``,
    llama.py:159-185): per-output-channel symmetric scales ``max|w| / 127``
    over the input axis, floored at 1e-8, ``round(w / scale)`` (half to
    even) clipped to ±127.  Embeddings and norms pass through."""
    out = {}
    for name, w in state.items():
        module, _, leaf = name.rpartition(".")
        if leaf == "weight" and module.rpartition(".")[2] in QUANT_TARGETS:
            w32 = w.float()
            scale = torch.clamp(_per_127(w32.abs().amax(dim=1, keepdim=True)), min=1e-8)
            out[f"{module}.weight_q"] = torch.clamp(
                torch.round(w32 / scale), -127, 127).to(torch.int8)
            out[f"{module}.scale"] = scale[:, 0]
        else:
            out[name] = w
    return out


class LlamaBlock(nn.Module):
    def __init__(self, c: LlamaConfig):
        super().__init__()
        self.c = c
        hd = c.dim // c.n_heads
        self.attn_norm = RMSNorm(c.dim, c.norm_eps)
        self.wq = _dense(c, c.dim, c.n_heads * hd)
        self.wk = _dense(c, c.dim, c.n_kv_heads * hd)
        self.wv = _dense(c, c.dim, c.n_kv_heads * hd)
        self.wo = _dense(c, c.n_heads * hd, c.dim)
        self.ffn_norm = RMSNorm(c.dim, c.norm_eps)
        self.w_gate = _dense(c, c.dim, c.ffn_hidden)
        self.w_up = _dense(c, c.dim, c.ffn_hidden)
        self.w_down = _dense(c, c.ffn_hidden, c.dim)

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
    def __init__(self, c: LlamaConfig, lm_head: bool = True):
        """``lm_head=False``: a trunk whose callers only take the hidden
        states (``return_hidden``), as flax builds one that never calls
        its head."""
        super().__init__()
        self.c = c
        self.layers = nn.ModuleList(LlamaBlock(c) for _ in range(c.n_layers))
        self.final_norm = RMSNorm(c.dim, c.norm_eps)
        if lm_head:
            self.lm_head = _dense(c, c.dim, c.vocab_size)

    def forward(self, input_embeds, attention_mask, positions,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache_index: int = 0, key_positions=None, last_logit_only=False,
                remat: bool = False, return_hidden: bool = False):
        """input_embeds [B, L, D]; attention_mask [B, S] over keys;
        positions [B, L].  Without ``cache``: causal attention among the L
        tokens, returns (logits, (k, v) stacked [n_layers, B, L, kv, hd]).
        With ``cache`` ([n_layers, B, S, kv, hd] each) and ``key_positions``
        [B, S]: the current tokens' slots [cache_index, cache_index + L)
        take keys from this call; those keys are written into ``cache`` in
        place, which is returned.

        ``remat`` (training, no cache): each block runs under activation
        checkpointing, so the backward recomputes it instead of keeping its
        activations (the JAX ``LlamaConfig.remat``), and no K/V is kept:
        returns (logits, None).

        ``return_hidden``: the final-normed hidden states [B, L, D] in place
        of the logits."""
        c = self.c
        if remat and cache is not None:
            raise ValueError("remat is the training forward: it takes no cache")
        B, L, _ = input_embeds.shape
        hd = c.dim // c.n_heads
        dev = input_embeds.device
        if cache is None:
            kp = positions if key_positions is None else key_positions
            if c.causal:
                mask_cur = (kp[:, None, :] <= positions[:, :, None]) & attention_mask[:, None, :]
            else:
                mask_cur = attention_mask[:, None, :].expand(B, L, attention_mask.shape[1])
            mask_cache = torch.zeros(B, L, 0, dtype=torch.bool, device=dev)
            empty = torch.zeros(B, 0, c.n_kv_heads, hd, dtype=c.dtype, device=dev)
        else:
            if key_positions is None:
                raise ValueError("the cache path needs key_positions")
            S = cache[0].shape[2]
            if c.causal:
                base = key_positions[:, None, :] <= positions[:, :, None]
                mask_cur = positions[:, None, :] <= positions[:, :, None]
            else:
                base = torch.ones(B, L, S, dtype=torch.bool, device=dev)
                mask_cur = torch.ones(B, L, L, dtype=torch.bool, device=dev)
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
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    layer, x, rot, masked_out, ck, cv, use_reentrant=False)[0]
                continue
            x, k, v = layer(x, rot, masked_out, ck, cv)
            if cache is None:
                ks.append(k)
                vs.append(v)
            else:
                cache[0][i, :, cache_index:cache_index + L] = k
                cache[1][i, :, cache_index:cache_index + L] = v
        if remat:
            new_cache = None
        else:
            new_cache = (torch.stack(ks), torch.stack(vs)) if cache is None else cache
        x = self.final_norm(x)
        if return_hidden:
            return x, new_cache
        if last_logit_only:
            x = x[:, -1:]
        return self.lm_head(x).float(), new_cache


class LlamaWithEmbeddings(nn.Module):
    def __init__(self, c: LlamaConfig, lm_head: bool = True):
        super().__init__()
        self.cfg = c
        self.tok_embed = nn.Embedding(c.vocab_size, c.dim)
        self.core = Llama(c, lm_head=lm_head)

    def embed(self, token_ids):
        return self.tok_embed(token_ids)

    def forward(self, *, input_embeds=None, token_ids=None, **kw):
        if input_embeds is None:
            input_embeds = self.tok_embed(token_ids)
        return self.core(input_embeds, **kw)
