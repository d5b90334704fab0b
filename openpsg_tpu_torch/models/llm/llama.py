"""Llama-family decoder (counterpart of ``openpsg_tpu/models/llm/llama.py``):
RMSNorm, rotate-half RoPE, grouped-query attention, SwiGLU; dense
projections, or int8 ones (:class:`QDense`, ``LlamaConfig.quant``) with
the optional int8-activation prefill (``act_int8``).  A forward without a
cache attends among its own tokens (prefill) and returns their (k, v); a
forward with a cache writes the current tokens' keys into it in place
(the JAX version returns an updated copy), then attends over the whole
cache once, as the DeepSeek-V3 decoder's latent attention does.  Who
sees whom is :func:`visibility`, for both families and the pipeline.

Tensor parallel: :func:`openpsg_tpu_torch.parallel.sharding.shard_params`
keeps each tp rank's block of the split weights and sets ``tp`` on the
modules.  Then each rank attends with its whole query heads (the KV cache
holds its kv heads), the row-parallel ``wo`` / ``w_down`` sum their
float32 partial products over tp before the scale and the cast, the
embedding looks up its vocabulary block and sums, and ``lm_head``'s
column blocks are gathered, so every rank holds the whole logits and
takes the same greedy token."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from openpsg_tpu_torch.models.common import mm_f32
from openpsg_tpu_torch.parallel.comm import (
    all_reduce,
    copy_to_group,
    gather_from_group,
    reduce_from_group,
    row_amax,
)


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


def require_llama(cfg, what: str) -> None:
    """Refuse, by name and before any work, an LLM config of another family
    on a path that handles only the Llama's (``what`` names the path)."""
    if not isinstance(cfg, LlamaConfig):
        raise NotImplementedError(
            f"{what} handles only a Llama-family LLM (LlamaConfig), not {type(cfg).__name__}")


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


def visibility(positions, attention_mask, key_positions=None, causal: bool = True,
               full_mask=None) -> torch.Tensor:
    """[B, L, S] bool, True where a query may see a key: ``full_mask`` where
    given, else the causal rule ``key_positions ≤ positions`` (keys at
    ``positions`` by default), or every key where not ``causal``; each
    and-ed with the valid keys ``attention_mask`` [B, S]."""
    valid = attention_mask.bool()[:, None, :]
    if full_mask is not None:
        return full_mask.to(valid.device).bool() & valid
    if not causal:
        return valid.expand(positions.shape[0], positions.shape[1], -1)
    kp = positions if key_positions is None else key_positions
    return (kp[:, None, :] <= positions[:, :, None]) & valid


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half rotary embedding of x [B, L, H, hd], in float32."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x [B, L, H, hd]; positions [B, L]."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def cache_slots(cache_index, L: int, device) -> torch.Tensor:
    """The cache slots [cache_index, cache_index + L) of the current tokens,
    an int64 index tensor on ``device``: ``cache_index`` is an int or a 0-d
    int64 tensor there (a trip's step, so that one CUDA graph of the
    forward serves every step)."""
    return torch.arange(L, device=device) + cache_index


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
        return mm_f32(x, w_q.to(x.dtype), "mk,nk->mn")

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

    def forward(self, x, tp_group=None):
        """``tp_group``: x holds this rank's block of the input features and
        ``weight_q`` the matching columns (row parallel): the int8 scale
        ``s_x`` takes the whole row's max |x| (a MAX over the group), and
        the int32 or float32 partial products are summed over the group
        before ``* scale`` and the cast."""
        x2 = x.reshape(-1, x.shape[-1])
        if self.act_int8 and x2.shape[0] >= self.ACT_INT8_MIN_ROWS:
            xf = x2.float()
            amax = xf.abs().amax(dim=-1, keepdim=True) if tp_group is None else row_amax(
                xf, tp_group)
            s_x = _per_127(torch.clamp(amax, min=1e-6))
            xq = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
            # on CUDA _int_mm needs more than 16 rows (here ≥ 256) and K, N
            # multiples of 8 (true of every Llama width the configs use)
            acc = torch._int_mm(xq, self.weight_q.t())
            if tp_group is not None:
                acc = all_reduce(acc, "sum", tp_group)      # int32: exact
            y = acc.float() * s_x * self.scale
        else:
            y = _weight_only_mm(x2, self.weight_q)
            if tp_group is not None:
                y = reduce_from_group(y, tp_group)
            y = y * self.scale
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


def _row_parallel(layer: nn.Module, x: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel projection of this rank's input block: float32
    partial products summed over tp, then cast (the scale of a ``QDense``
    applied after the sum)."""
    if tp is None:
        return layer(x)
    if isinstance(layer, QDense):
        return layer(x, tp_group=tp.group)
    part = mm_f32(x.reshape(-1, x.shape[-1]), layer.weight, "mk,nk->mn")
    return reduce_from_group(part, tp.group).to(x.dtype).reshape(*x.shape[:-1], -1)


def _kv_heads(layer: nn.Module, h: torch.Tensor, tp) -> torch.Tensor:
    """k or v of every kv head from a replicated projection, cut to the
    heads this rank's query heads use.  A trainable replicated weight gets
    its gradient summed over tp (each rank back-propagates only its
    heads' share)."""
    if isinstance(layer, nn.Linear) and layer.weight.requires_grad:
        return F.linear(h, copy_to_group(layer.weight, tp.group))
    return layer(h)


class LlamaBlock(nn.Module):
    tp = None   # the tp runtime (parallel.sharding.TPState) once sharded

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

    def forward(self, x, rot, masked_out, cache=None, slots=None):
        """x [B, L, D]; rot = rope_tables(positions); masked_out [B, L, S]
        True where a query may NOT see a key (``~visibility``).  ``cache``:
        this layer's (k, v) [B, S, kv, hd]; the current tokens' k and v are
        written at ``slots`` first, then the queries attend over the S
        cached keys.  Without one the L tokens are the keys (S = L).  Each
        kv head serves its ``rep`` query heads as one group, without
        copies.  → (x, k, v of the current tokens)."""
        c = self.c
        B, L, _ = x.shape
        hd = c.dim // c.n_heads
        tp = self.tp
        split_q = tp is not None and tp.layout.q
        heads = tp.heads_local if split_q else c.n_heads
        h = self.attn_norm(x)
        if split_q:
            h = copy_to_group(h, tp.group)
        q = apply_rope(self.wq(h).reshape(B, L, heads, hd), *rot)
        if split_q and not tp.layout.kv:
            lo, n = tp.kv_lo, tp.kv_local
            k = _kv_heads(self.wk, h, tp).reshape(B, L, c.n_kv_heads, hd)[:, :, lo:lo + n]
            v = _kv_heads(self.wv, h, tp).reshape(B, L, c.n_kv_heads, hd)[:, :, lo:lo + n]
            k = apply_rope(k, *rot)
        else:
            n = tp.kv_local if split_q else c.n_kv_heads
            k = apply_rope(self.wk(h).reshape(B, L, n, hd), *rot)
            v = self.wv(h).reshape(B, L, n, hd)
        keys, values = k, v
        if cache is not None:
            keys, values = cache
            keys.index_copy_(1, slots, k.to(keys.dtype))
            values.index_copy_(1, slots, v.to(values.dtype))
        groups = k.shape[2]
        scores = mm_f32(q.view(B, L, groups, heads // groups, hd), keys, "blgrd,bmgd->bgrlm")
        attn = (scores * (hd ** -0.5)).masked_fill(masked_out[:, None, None], -1e9)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.einsum("bgrlm,bmgd->blgrd", attn, values)
        out = out.reshape(B, L, heads * hd)
        x = x + (_row_parallel(self.wo, out, tp) if split_q else self.wo(out))
        h = self.ffn_norm(x)
        split_ffn = tp is not None and tp.layout.ffn
        if split_ffn:
            h = copy_to_group(h, tp.group)
        act = F.silu(self.w_gate(h)) * self.w_up(h)
        down = _row_parallel(self.w_down, act, tp) if split_ffn else self.w_down(act)
        return x + down, k, v


class Llama(nn.Module):
    tp = None
    # a pipeline stage's layers [lo, hi) (parallel.pipeline.shard_pipeline)
    stage_range = None

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
                cache_index=0, key_positions=None, last_logit_only=False,
                remat: bool = False, return_hidden: bool = False, full_mask=None):
        """input_embeds [B, L, D]; attention_mask [B, S] over keys;
        positions [B, L]; who sees whom is :func:`visibility`.  Without
        ``cache``: attention among the L tokens, returns (logits, (k, v)
        stacked [n_layers, B, L, kv, hd]).  With ``cache`` ([n_layers, B,
        S, kv, hd] each) and ``key_positions`` [B, S]: each layer writes the
        current tokens' keys into slots [cache_index, cache_index + L) of
        ``cache`` in place, then attends over its S slots; the cache is
        returned.  ``cache_index`` is an int or a 0-d int64 tensor on the
        cache's device (:func:`cache_slots`).

        ``remat`` (training, no cache): each block runs under activation
        checkpointing, so the backward recomputes it instead of keeping its
        activations (the JAX ``LlamaConfig.remat``), and no K/V is kept:
        returns (logits, None).

        ``return_hidden``: the final-normed hidden states [B, L, D] in place
        of the logits.

        ``full_mask`` (bool, True where a query may see a key) replaces the
        causal rule, as :func:`decouple_label_masks` builds it: [B, L, L]
        without a cache (and-ed with ``attention_mask``); [B, L, S] over the
        whole cache with one, its slice ``[:, :, cache_index:cache_index +
        L]`` the current block.  A tp-sharded model takes the same mask on
        every rank."""
        c = self.c
        if remat and cache is not None:
            raise ValueError("remat is the training forward: it takes no cache")
        if self.stage_range is not None:
            raise ValueError("a pipeline stage holds some layers only: run it through "
                             "parallel.pipeline.pipelined_llama_logits")
        if cache is not None and key_positions is None:
            raise ValueError("the cache path needs key_positions")
        L = input_embeds.shape[1]
        slots = None if cache is None else cache_slots(cache_index, L, input_embeds.device)
        masked_out = ~visibility(positions, attention_mask, key_positions, c.causal, full_mask)
        x = input_embeds.to(c.dtype)
        rot = rope_tables(positions, c.dim // c.n_heads, c.rope_theta)
        ks, vs = [], []
        for i, layer in enumerate(self.layers):
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    layer, x, rot, masked_out, use_reentrant=False)[0]
                continue
            layer_cache = None if cache is None else (cache[0][i], cache[1][i])
            x, k, v = layer(x, rot, masked_out, layer_cache, slots)
            ks.append(k)
            vs.append(v)
        if remat:
            new_cache = None
        else:
            new_cache = (torch.stack(ks), torch.stack(vs)) if cache is None else cache
        x = self.final_norm(x)
        if return_hidden:
            return x, new_cache
        if last_logit_only:
            x = x[:, -1:]
        return self.logits(x), new_cache

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """``lm_head`` on final-normed states → float32 logits over the
        whole vocabulary (column blocks gathered over tp)."""
        tp = self.tp
        if tp is None or not tp.layout.vocab:
            return self.lm_head(x).float()
        return gather_from_group(self.lm_head(copy_to_group(x, tp.group)).float(), -1, tp.group)


class LlamaWithEmbeddings(nn.Module):
    tp = None

    def __init__(self, c: LlamaConfig, lm_head: bool = True):
        super().__init__()
        self.cfg = c
        self.tok_embed = nn.Embedding(c.vocab_size, c.dim)
        self.core = Llama(c, lm_head=lm_head)

    def embed(self, token_ids):
        tp = self.tp
        if tp is None or not tp.layout.vocab:
            return self.tok_embed(token_ids)
        # this rank's vocabulary block: a masked lookup, summed over tp
        w = self.tok_embed.weight
        local = token_ids - tp.rank * w.shape[0]
        inside = (local >= 0) & (local < w.shape[0])
        e = F.embedding(local.clamp(0, w.shape[0] - 1), w) * inside[..., None].to(w.dtype)
        return reduce_from_group(e, tp.group)

    def forward(self, *, input_embeds=None, token_ids=None, full_mask=None, **kw):
        """Embeds ``token_ids`` unless ``input_embeds`` is given, then runs
        the core (:meth:`Llama.forward`'s keywords, ``full_mask`` among
        them)."""
        if input_embeds is None:
            input_embeds = self.embed(token_ids)
        return self.core(input_embeds, full_mask=full_mask, **kw)


def decouple_label_masks(token_ids, answer_id: int, delimiter_id: int,
                         decouple_positions: bool = False):
    """Host copy of the JAX ``decouple_label_masks`` (the reference's
    ``decouple_label_tok_embeds``, kings_sgg/models/commons/llama.py:226-288).
    The answer region after the first ``answer_id`` of the last sample holds
    delimiter-separated label segments; each attends causally within itself
    and to the whole prompt, never to an earlier segment, so the labels are
    predicted independently given the prompt.  With ``decouple_positions``
    each segment's RoPE positions restart at the answer position.

    token_ids [B, L] → (mask [B, L, L] bool, to feed as ``full_mask``;
    positions [B, L] int32).  The reference's ids are 526 ("are") and 29892
    (","); pass the tokenizer's own."""
    ids = np.asarray(token_ids)
    B, L = ids.shape
    mask = np.tile(np.tril(np.ones((L, L), bool))[None], (B, 1, 1))
    positions = np.tile(np.arange(L, dtype=np.int32)[None], (B, 1))
    hits = np.nonzero(ids[-1] == answer_id)[0]
    if not len(hits):
        return mask, positions
    a = int(hits[0])
    for b in range(B):
        prev = a
        for d in np.nonzero(ids[b] == delimiter_id)[0]:
            end = int(d) + 1   # a delimiter sees its own segment
            mask[b, prev:end, a + 1:prev] = False
            if decouple_positions:
                positions[b, prev:end] = a + np.arange(end - prev)
            prev = end
        if prev < L:           # the segment after the last delimiter
            mask[b, prev:, a + 1:prev] = False
            if decouple_positions:
                positions[b, prev:] = a + np.arange(L - prev)
    return mask, positions
