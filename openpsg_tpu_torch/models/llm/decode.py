"""Batched greedy decoding with a static KV cache (counterpart of
``openpsg_tpu/models/llm/decode.py``).

One cache-free prefill over the whole [pairs, prefix] batch (last logit
only), then single-token steps: HF positions ``cumsum(mask) - 1``, EOS
early exit, tokens after a sequence's EOS emitted as ``pad_id``, greedy
log-prob scores.  ``trip_budget`` is a runtime cap on the number of decode
steps, read on every call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from openpsg_tpu_torch.models.llm.llama import LlamaWithEmbeddings


@torch.no_grad()
def greedy_decode(
    model: LlamaWithEmbeddings,
    prefix_embeds: torch.Tensor,   # [B, Lp, D]
    prefix_mask: torch.Tensor,     # [B, Lp] bool
    max_new_tokens: int,
    eos_id: int,
    pad_id: int = 0,
    early_exit: bool = True,
    trip_budget: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """→ (tokens [B, max_new_tokens] int32, scores [B, max_new_tokens] f32,
    trips): ``trips`` is the number of decode steps that ran, at most
    ``min(max_new_tokens, trip_budget)``; ``trip_budget=None`` means no
    cap beyond ``max_new_tokens``.  EOS itself is not emitted."""
    c = model.cfg
    B, Lp, _ = prefix_embeds.shape
    dev = prefix_embeds.device
    S = Lp + max_new_tokens
    hd = c.dim // c.n_heads

    key_mask = torch.cat(
        [prefix_mask, torch.zeros(B, max_new_tokens, dtype=torch.bool, device=dev)], dim=1)
    positions = torch.clamp(torch.cumsum(prefix_mask.to(torch.int64), dim=1) - 1, min=0)
    n_real = prefix_mask.sum(dim=1)
    key_positions = torch.cat(
        [positions, torch.zeros(B, max_new_tokens, dtype=torch.int64, device=dev)], dim=1)

    logits, (k0, v0) = model(input_embeds=prefix_embeds, attention_mask=prefix_mask,
                             positions=positions, last_logit_only=True)
    shape = (c.n_layers, B, S, c.n_kv_heads, hd)
    cache = (torch.zeros(shape, dtype=c.dtype, device=dev),
             torch.zeros(shape, dtype=c.dtype, device=dev))
    cache[0][:, :, :Lp] = k0
    cache[1][:, :, :Lp] = v0

    rows = torch.arange(B, device=dev)

    def pick(lg):
        tok = torch.argmax(lg, dim=-1)
        return tok, torch.log_softmax(lg, dim=-1)[rows, tok]

    tok, score = pick(logits[:, -1])
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    toks = torch.full((B, max_new_tokens), pad_id, dtype=torch.int32, device=dev)
    scores = torch.zeros(B, max_new_tokens, dtype=torch.float32, device=dev)
    limit = max_new_tokens if trip_budget is None else min(max_new_tokens, int(trip_budget))

    t = 0
    while t < limit:
        if early_exit and bool(torch.all(done | (tok == eos_id))):
            break
        hit_eos = tok == eos_id
        stop = done | hit_eos
        toks[:, t] = torch.where(stop, torch.full_like(tok, pad_id), tok).to(torch.int32)
        scores[:, t] = torch.where(stop, torch.zeros_like(score), score)
        done = stop
        slot = Lp + t
        key_mask[:, slot] = True
        pos = (n_real + t)[:, None]
        key_positions[:, slot] = pos[:, 0]
        logits, _ = model(input_embeds=model.embed(tok[:, None]), attention_mask=key_mask,
                          positions=pos, cache=cache, cache_index=slot,
                          key_positions=key_positions)
        tok, score = pick(logits[:, 0])
        t += 1
    return toks, scores, t
