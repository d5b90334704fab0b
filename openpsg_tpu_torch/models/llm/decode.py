"""Batched greedy decoding with a static KV cache (counterpart of
``openpsg_tpu/models/llm/decode.py``).

One cache-free prefill over the whole [pairs, prefix] batch (last logit
only), then single-token steps: HF positions ``cumsum(mask) - 1``, EOS
early exit, tokens after a sequence's EOS emitted as ``pad_id``, greedy
log-prob scores.  ``trip_budget`` is a runtime cap on the number of decode
steps, read on every call.  The prefill (the forward, the cache's
allocation and fill, the first pick) is the span ``psg.prefill`` and each
step one ``psg.trip``; the early-exit test, which waits for the card, lies
between them (``utils/profiling.span``).

The LLM is a Llama (:class:`LlamaWithEmbeddings`, whose cache holds
(k, v) [n_layers, B, S, kv, hd]) or a DeepSeek-V3 decoder
(:class:`~openpsg_tpu_torch.models.llm.deepseek_v3.DeepseekV3WithEmbeddings`,
whose cache holds MLA's latent [n_layers, B, S, R] and k_pe [n_layers, B,
S, rope]): each takes the same calls.

A tensor-parallel LLM (``parallel.sharding.shard_params``) decodes the
same way on every tp rank: its cache holds the rank's kv heads, and the
logits are whole on every rank, so the greedy tokens and the early-exit
test agree across the group and its collectives stay in step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from openpsg_tpu_torch.utils.profiling import span


@torch.no_grad()
def greedy_decode(
    model: nn.Module,
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

    key_mask = torch.cat(
        [prefix_mask, torch.zeros(B, max_new_tokens, dtype=torch.bool, device=dev)], dim=1)
    positions = torch.clamp(torch.cumsum(prefix_mask.to(torch.int64), dim=1) - 1, min=0)
    n_real = prefix_mask.sum(dim=1)
    key_positions = torch.cat(
        [positions, torch.zeros(B, max_new_tokens, dtype=torch.int64, device=dev)], dim=1)

    rows = torch.arange(B, device=dev)

    def pick(lg):
        tok = torch.argmax(lg, dim=-1)
        return tok, torch.log_softmax(lg, dim=-1)[rows, tok]

    with span("prefill"):
        logits, (k0, v0) = model(input_embeds=prefix_embeds, attention_mask=prefix_mask,
                                 positions=positions, last_logit_only=True)
        # each cache tensor shaped from its own prefill tensor: the Llama's
        # (k, v) of the rank's kv heads, or MLA's latent and k_pe
        cache = tuple(torch.zeros((c.n_layers, B, S) + tuple(t.shape[3:]), dtype=c.dtype,
                                  device=dev) for t in (k0, v0))
        cache[0][:, :, :Lp] = k0
        cache[1][:, :, :Lp] = v0
        tok, score = pick(logits[:, -1])
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    toks = torch.full((B, max_new_tokens), pad_id, dtype=torch.int32, device=dev)
    scores = torch.zeros(B, max_new_tokens, dtype=torch.float32, device=dev)
    limit = max_new_tokens if trip_budget is None else min(max_new_tokens, int(trip_budget))

    t = 0
    while t < limit:
        if early_exit and bool(torch.all(done | (tok == eos_id))):
            break
        with span("trip"):
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
