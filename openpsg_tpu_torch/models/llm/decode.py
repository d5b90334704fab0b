"""Batched greedy decoding with a static KV cache (counterpart of
``openpsg_tpu/models/llm/decode.py``).

One cache-free prefill over the whole [pairs, prefix] batch (last logit
only), then single-token steps: HF positions ``cumsum(mask) - 1``, EOS
early exit, tokens after a sequence's EOS emitted as ``pad_id``, greedy
log-prob scores.  ``trip_budget`` is a runtime cap on the number of decode
steps, read on every call.  The prefill (the forward, the cache's fill, the
first pick) is the span ``psg.prefill`` and each step one ``psg.trip``;
the early-exit test, which waits for the card, lies between them
(``utils/profiling.span``).

The LLM is a Llama (:class:`LlamaWithEmbeddings`, whose cache holds
(k, v) [n_layers, B, S, kv, hd]) or a DeepSeek-V3 decoder
(:class:`~openpsg_tpu_torch.models.llm.deepseek_v3.DeepseekV3WithEmbeddings`,
whose cache holds MLA's latent [n_layers, B, S, R] and k_pe [n_layers, B,
S, rope]): each takes the same calls.

A call's cache, masks, token and step live in a :class:`DecodeState`, whose
trip indexes them with the step as a device tensor.  On one CUDA device the
LLM module keeps the states of its last few decode shapes, and the trips
after the first of a shape are replayed from CUDA graphs: one capture
serves every step.  The graph splits where the trip opens a span
(``psg.mla``, ``psg.moe``) or calls a module that has forward hooks, which
runs eagerly between the graphs (``utils/graphs.py``), so spans and hooks
see every trip as the eager trip shows it.  Elsewhere a state made for the
call runs the same trip eagerly.  The prefill stays eager; the early-exit
test stays on the host before every trip.  Counters:
``greedy_decode.graph_captures``, ``.graph_trips`` and ``.eager_trips``.

A tensor-parallel LLM (``parallel.sharding.shard_params``) decodes the
same way on every tp rank, eagerly: its cache holds the rank's kv heads,
and the logits are whole on every rank, so the greedy tokens and the
early-exit test agree across the group and its collectives stay in step.
The CPU and a pipeline stage run their trips eagerly too.
"""

from __future__ import annotations

import contextlib
import itertools
from collections import OrderedDict
from typing import Optional, Tuple

import torch
import torch.nn as nn

from openpsg_tpu_torch.utils.graphs import SegmentedGraph, global_hooks, hooked
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
    positions = torch.clamp(torch.cumsum(prefix_mask.to(torch.int64), dim=1) - 1, min=0)
    graphs = _graphs(model, prefix_embeds.device)
    with span("prefill"):
        logits, (k0, v0) = model(input_embeds=prefix_embeds, attention_mask=prefix_mask,
                                 positions=positions, last_logit_only=True)
        if graphs is None:
            state = DecodeState(k0, v0, max_new_tokens, model.cfg.dtype)
        else:
            state = graphs.state(k0, v0, max_new_tokens, model.cfg.dtype)
        state.start(k0, v0, logits[:, -1], prefix_mask, positions, eos_id, pad_id)
    limit = max_new_tokens if trip_budget is None else min(max_new_tokens, int(trip_budget))
    t = 0
    while t < limit:
        if early_exit and bool(torch.all(state.done | (state.tok == eos_id))):
            break
        if graphs is None:
            state.step(model)
            greedy_decode.eager_trips += 1
        else:
            state.trip(model)
        t += 1
    if graphs is None:
        return state.toks, state.scores, t
    return state.toks.clone(), state.scores.clone(), t     # a kept state serves later calls


# host counters: decode shapes captured as CUDA graphs, trips replayed from
# them, trips run eagerly (operation by operation)
greedy_decode.graph_captures = 0
greedy_decode.graph_trips = 0
greedy_decode.eager_trips = 0


def pick(lg: torch.Tensor, rows: torch.Tensor):
    """Greedy token of each row of logits [B, V] and its log-probability."""
    tok = torch.argmax(lg, dim=-1)
    return tok, torch.log_softmax(lg, dim=-1)[rows, tok]


class DecodeGraphs:
    """The graph path's decode states of one LLM, kept on the module
    (``_decode_graphs``), so they are freed with it: one per decode shape
    (B, Lp, S, dtype, device), the ``KEPT`` used last (serving's groups of
    1 to 4 images are 4 shapes).  They are dropped when a parameter or
    buffer moved or the set of hooked modules changed, since a graph reads
    fixed addresses and splits where a hook runs."""

    KEPT = 4

    def __init__(self, dev: torch.device):
        self.signature = None
        self.states: "OrderedDict[tuple, DecodeState]" = OrderedDict()
        # the side stream every capture of this LLM runs on
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def refresh(self, model: nn.Module) -> None:
        sig = (tuple(t.data_ptr() for t in itertools.chain(model.parameters(), model.buffers())),
               tuple(i for i, m in enumerate(model.modules()) if hooked(m)))
        if sig != self.signature:
            self.signature, self.states = sig, OrderedDict()

    def state(self, k0, v0, max_new_tokens: int, dtype) -> "DecodeState":
        """The kept state of the prefill's (k0, v0) shape, made if there is
        none; the least recently used beyond ``KEPT`` is dropped."""
        B, Lp = k0.shape[1:3]
        key = (B, Lp, Lp + max_new_tokens, dtype, k0.device)
        st = self.states.pop(key, None)
        if st is None:
            st = DecodeState(k0, v0, max_new_tokens, dtype, self.stream)
        self.states[key] = st
        while len(self.states) > self.KEPT:
            self.states.popitem(last=False)
        return st


def _graphs(model: nn.Module, dev: torch.device) -> Optional[DecodeGraphs]:
    """The model's :class:`DecodeGraphs` where the graph path engages: on
    CUDA, neither tensor-parallel nor a pipeline stage (collectives stay
    eager), no hook on every module, ``embed`` and ``forward`` the class's
    own (one replaced on the instance, as a teacher-forcing wrapper is, is
    Python that a replay would not run again), not inside another capture;
    else None (the trips run eagerly)."""
    if dev.type != "cuda" or torch.cuda.is_current_stream_capturing() or global_hooks():
        return None
    if "embed" in vars(model) or "forward" in vars(model):
        return None
    if any(getattr(m, "tp", None) is not None or getattr(m, "stage_range", None) is not None
           for m in model.modules()):
        return None
    graphs = model.__dict__.get("_decode_graphs")
    if graphs is None:
        graphs = model._decode_graphs = DecodeGraphs(dev)
    graphs.refresh(model)
    return graphs


@contextlib.contextmanager
def _lasting():
    """Where tensors that may outlive the call are made: outside inference
    mode (a later call outside it updates them in place, which an inference
    tensor refuses), without autograd."""
    with torch.inference_mode(False), torch.no_grad():
        yield


class DecodeState:
    """One decode shape's tensors (the cache, key mask and positions, the
    current token, score and stop flags, EOS and pad, the step ``t`` as a
    0-d device tensor, the tokens and scores so far) and its trip
    (:meth:`step`).  A kept state (``stream`` given) captures its trip as a
    :class:`~openpsg_tpu_torch.utils.graphs.SegmentedGraph` (split where a
    span opens or a hooked module runs) on the shape's first trip and
    replays it on every trip after: the same operations on the same
    inputs, so the same bits as the trip run eagerly."""

    def __init__(self, k0, v0, max_new_tokens: int, dtype,
                 stream: Optional[torch.cuda.Stream] = None):
        L, B, Lp = k0.shape[:3]
        S, dev = Lp + max_new_tokens, k0.device
        self.Lp, self.stream = Lp, stream
        with _lasting():
            # each cache tensor shaped from its own prefill tensor: the
            # Llama's (k, v) of the rank's kv heads, or MLA's latent and k_pe
            self.cache = tuple(torch.empty((L, B, S) + tuple(t.shape[3:]), dtype=dtype,
                                           device=dev) for t in (k0, v0))
            self.key_mask = torch.empty(B, S, dtype=torch.bool, device=dev)
            self.key_positions = torch.empty(B, S, dtype=torch.int64, device=dev)
            self.n_real = torch.empty(B, dtype=torch.int64, device=dev)
            self.tok = torch.empty(B, dtype=torch.int64, device=dev)
            self.score = torch.empty(B, dtype=torch.float32, device=dev)
            self.done = torch.empty(B, dtype=torch.bool, device=dev)
            self.eos = torch.empty((), dtype=torch.int64, device=dev)
            self.pad = torch.empty((), dtype=torch.int64, device=dev)
            self.t = torch.empty((), dtype=torch.int64, device=dev)
            self.rows = torch.arange(B, device=dev)
            self.toks = torch.empty(B, max_new_tokens, dtype=torch.int32, device=dev)
            self.scores = torch.empty(B, max_new_tokens, dtype=torch.float32, device=dev)
        self.graph: Optional[SegmentedGraph] = None

    def start(self, k0, v0, last_logits, prefix_mask, positions, eos_id: int,
              pad_id: int) -> None:
        """Set the state for a call from its prefill: the cache's prefix
        slots, its other slots zeroed, the first pick."""
        Lp = self.Lp
        for cache, t in zip(self.cache, (k0, v0)):
            cache[:, :, :Lp] = t
            cache[:, :, Lp:].zero_()
        self.key_mask[:, :Lp] = prefix_mask
        self.key_mask[:, Lp:] = False
        self.key_positions[:, :Lp] = positions
        self.key_positions[:, Lp:].zero_()
        self.n_real.copy_(prefix_mask.sum(dim=1))
        tok, score = pick(last_logits, self.rows)
        self.tok.copy_(tok)
        self.score.copy_(score)
        self.done.zero_()
        self.eos.fill_(eos_id)
        self.pad.fill_(pad_id)
        self.t.zero_()
        self.toks.fill_(pad_id)
        self.scores.zero_()

    def trip(self, model: nn.Module) -> None:
        """One decode step of a kept state: the first of the shape runs as
        its capture, the rest replay it."""
        if self.graph is None:
            with _lasting():
                self.graph = SegmentedGraph.capture(lambda: self.step(model), model.modules(),
                                                    self.stream)
            greedy_decode.graph_captures += 1
        else:
            self.graph.replay()
        greedy_decode.graph_trips += 1

    def step(self, model: nn.Module) -> None:
        """The trip, indexed by the device step ``t``, which it advances."""
        with span("trip"):
            tok = self.tok
            stop = self.done | (tok == self.eos)
            col = self.t.view(1)
            self.toks.index_copy_(1, col, torch.where(stop, self.pad, tok).to(torch.int32)[:, None])
            self.scores.index_copy_(1, col, torch.where(
                stop, torch.zeros_like(self.score), self.score)[:, None])
            self.done.copy_(stop)
            slot = self.t + self.Lp
            self.key_mask.index_fill_(1, slot.view(1), True)
            pos = (self.n_real + self.t)[:, None]
            self.key_positions.index_copy_(1, slot.view(1), pos)
            logits, _ = model(input_embeds=model.embed(tok[:, None]), attention_mask=self.key_mask,
                              positions=pos, cache=self.cache, cache_index=slot,
                              key_positions=self.key_positions)
            new_tok, new_score = pick(logits[:, 0], self.rows)
            self.tok.copy_(new_tok)
            self.score.copy_(new_score)
            self.t += 1
