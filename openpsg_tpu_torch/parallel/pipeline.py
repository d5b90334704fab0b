"""Pipeline parallelism (GPipe) for the Llama trunk (counterpart of
``openpsg_tpu/parallel/pipeline.py``).

The trunk's ``n_layers`` are cut into ``pp`` contiguous stages; each pp
rank holds only its ``n_layers / pp`` layers (:func:`shard_pipeline`).
:func:`pipelined_llama_logits` runs the GPipe schedule over
``n_micro + pp - 1`` ticks: at tick ``t`` stage ``s`` runs microbatch
``t - s`` when it exists, then every stage hands its output one stage on
(:func:`~openpsg_tpu_torch.parallel.comm.permute`, point-to-point).  The
last stage's hidden states are summed over pp from zeros elsewhere, so
every rank holds them; the final norm and ``lm_head`` run outside the
pipeline, replicated.  Backward is autograd: the permute's backward sends
each gradient one stage back, and a scalar token threads every tick so
all ranks run the exchanges in the same order.  The embeddings' gradient
is summed over pp (only stage 0 reads them), so a trainable module in
front of the LLM gets the same gradient on every pp rank.

tp composes inside each stage: on a ("dp", "pp", "tp") mesh the stage's
layers are Megatron-sharded over tp (:func:`shard_pipeline` calls
``sharding.shard_params``) and their collectives run on the tp group
within the tick.  dp: each dp rank passes its own rows (the JAX function
splits each microbatch over dp; the rows are independent, so the values
are the same).

Scope, as in the JAX package: the cache-free forward (prefill and
teacher-forced training).  Decode keeps the tp path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.utils.checkpoint

from openpsg_tpu_torch.models.llm.llama import require_llama, rope_tables, visibility
from openpsg_tpu_torch.parallel.comm import copy_to_group, permute, reduce_from_group
from openpsg_tpu_torch.parallel.mesh import axis_group, device_mesh, world
from openpsg_tpu_torch.parallel.sharding import shard_params


def make_dp_pp_mesh(pp: int, dp: Optional[int] = None, tp: int = 1):
    """Mesh over ("dp", "pp"), or ("dp", "pp", "tp") when ``tp > 1`` (tp
    innermost).  Default: the remaining ranks on dp."""
    n = world()[1]
    if dp is None:
        assert n % (pp * tp) == 0, (n, pp, tp)
        dp = n // (pp * tp)
    assert dp * pp * tp == n, f"dp({dp}) * pp({pp}) * tp({tp}) != ranks({n})"
    if tp == 1:
        return device_mesh((dp, pp), ("dp", "pp"))
    return device_mesh((dp, pp, tp), ("dp", "pp", "tp"))


class _NotOnThisStage(nn.Module):
    """Stands in for a layer another pipeline stage holds, so parameter
    names keep their global layer index."""

    def forward(self, *a, **k):
        raise RuntimeError("this layer lives on another pipeline stage")


def shard_pipeline(llm, mesh) -> None:
    """Keep this pp rank's contiguous layers (the others are dropped) and,
    on a mesh with tp, tp-shard what is left.  Only a Llama: another
    family is refused by name."""
    require_llama(llm.cfg, "parallel.pipeline.shard_pipeline")
    group, s, pp = axis_group(mesh, "pp")
    core = llm.core
    n = len(core.layers)
    assert n % pp == 0, (n, pp)
    lo, hi = s * n // pp, (s + 1) * n // pp
    for i in range(n):
        if not lo <= i < hi:
            core.layers[i] = _NotOnThisStage()
    core.stage_range, core.pp_group, core.pp_stage, core.pp_size = (lo, hi), group, s, pp
    shard_params(llm, mesh)


def pipelined_llama_logits(model, input_embeds: torch.Tensor, attention_mask: torch.Tensor,
                           positions: torch.Tensor, mesh, n_micro: int, *,
                           last_logit_only: bool = False, remat: bool = False) -> torch.Tensor:
    """Cache-free forward of a :func:`shard_pipeline` LLM on this rank's rows
    (input_embeds [B, L, D], attention_mask [B, L] bool, positions [B, L])
    → float32 logits [B, L or 1, V], equal to ``model(input_embeds=...,
    attention_mask=..., positions=...)[0]`` of the whole LLM.  The rows
    split into ``n_micro`` microbatches (B % n_micro == 0).  ``remat``
    checkpoints each (stage, microbatch) block, so backward keeps one
    microbatch of activations per stage."""
    c = model.cfg
    require_llama(c, "parallel.pipeline.pipelined_llama_logits")
    core = model.core
    group, s, P = core.pp_group, core.pp_stage, core.pp_size
    lo, hi = core.stage_range
    B, L, D = input_embeds.shape
    assert B % n_micro == 0, (B, n_micro)
    mb = B // n_micro
    dev = input_embeds.device

    masked_out = ~visibility(positions, attention_mask, causal=c.causal)     # [B, L, L]
    emb = copy_to_group(input_embeds, group)

    def run_stage(x, rot, mo):
        for i in range(lo, hi):
            x = core.layers[i](x, rot, mo)[0]
        return x

    token = torch.zeros((), device=dev, requires_grad=torch.is_grad_enabled())
    if emb.requires_grad:
        token = token + 0.0 * emb.sum()
    state = torch.zeros(mb, L, D, dtype=c.dtype, device=dev)
    outputs = [None] * n_micro
    for t in range(n_micro + P - 1):
        m = t - s
        if 0 <= m < n_micro:
            rows = slice(m * mb, (m + 1) * mb)
            x = emb[rows].to(c.dtype) if s == 0 else state
            rot = rope_tables(positions[rows], c.dim // c.n_heads, c.rope_theta)
            if remat and torch.is_grad_enabled():
                y = torch.utils.checkpoint.checkpoint(run_stage, x, rot, masked_out[rows],
                                                      use_reentrant=False)
            else:
                y = run_stage(x, rot, masked_out[rows])
            if s == P - 1:
                outputs[m] = y
        else:
            y = torch.zeros(mb, L, D, dtype=c.dtype, device=dev)
        state, token = permute(y, token, group, s, P)
    if s == P - 1:
        hidden = torch.cat(outputs)
    else:
        hidden = torch.zeros(B, L, D, dtype=c.dtype, device=dev)
    hidden = reduce_from_group(hidden, group)
    if token.requires_grad:
        hidden = hidden + (0.0 * token).to(hidden.dtype)
    x = core.final_norm(hidden)
    if last_logit_only:
        x = x[:, -1:]
    return core.logits(x)
